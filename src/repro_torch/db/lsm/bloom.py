"""Per-run bloom filters — packed 32-bit words with vectorized hashing.

Accumulo keeps a bloom filter per RFile so point lookups skip files that
cannot contain the key; here every sorted run (L0 flush or leveled run)
carries one over its ROW ids. Build and probe are plain tensor code: k
multiplicative xor-shift hashes, a boolean scatter (collision-safe), then a
pack to 32-bit words, bit-identical to the JAX package's uint32 words.

Words are held as int32 with the uint32 bit pattern (``.view(np.uint32)``
of the numpy copy gives the JAX words). The hash is computed in int64
masked to 32 bits: PyTorch has no logical right shift on uint32 on every
device, and ``>>`` on int32 is arithmetic. Keys are masked to 32 bits
BEFORE the multiply, so the fused read's -1 query pads hash exactly as
JAX's uint32 cast makes them.

The defaults — 8 bits/key, 4 hashes — give ~2.4% false positives at full
occupancy; the theoretical rate for m bits, n keys, k hashes is
``(1 - exp(-k*n/m))**k`` (``theoretical_fp_rate``).
"""
from __future__ import annotations

import math

import torch

from ...kernels.common import I32_MAX

NUM_HASHES = 4
BITS_PER_KEY = 8

# odd 32-bit constants (xxhash/murmur finalizer family); len() bounds the
# largest usable n_hashes
_MULTS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
          0x165667B1, 0xD6E8FEB9, 0xCC9E2D51, 0x1B873593)

MAX_HASHES = len(_MULTS)

_M32 = 0xFFFFFFFF


def num_words(run_capacity: int, bits_per_key: int = BITS_PER_KEY) -> int:
    """32-bit words for a run of ``run_capacity`` keys (pow2, >= 2)."""
    bits = max(64, run_capacity * bits_per_key)
    bits = 1 << (bits - 1).bit_length()
    return bits // 32


def theoretical_fp_rate(n_keys: int, n_words: int, n_hashes: int) -> float:
    """Classic bloom bound: (1 - e^{-kn/m})^k for m = 32 * n_words bits."""
    if n_keys == 0:
        return 0.0
    m = 32 * n_words
    return (1.0 - math.exp(-n_hashes * n_keys / m)) ** n_hashes


def suggest_hashes(bits_per_key: int) -> int:
    """fp-optimal hash count k = ln2 * bits/key, clamped to _MULTS."""
    return max(1, min(MAX_HASHES, round(math.log(2) * bits_per_key)))


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """``a * m mod 2**32`` for int64 ``a`` in [0, 2**32): split the constant
    in 16-bit halves so no product leaves int64."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash(keys: torch.Tensor, mult: int, n_bits: int) -> torch.Tensor:
    """Multiplicative xor-shift hash of int32 keys into [0, n_bits): int64."""
    h = keys.to(torch.int64) & _M32
    h = _mul32(h, mult)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 13)
    return h & (n_bits - 1)


def bloom_build(rows: torch.Tensor, n_words: int,
                n_hashes: int = NUM_HASHES) -> torch.Tensor:
    """Build a packed filter over the valid (!= I32_MAX) row ids of each
    run ``rows[..., cap]``: int32 words ``[..., n_words]``.

    Scatters into a boolean bitset first (set is idempotent, so same-word
    collisions are safe; one spare slot takes the pads), then packs 32 bits
    per word.
    """
    n_bits = n_words * 32
    lead = rows.shape[:-1]
    r2 = rows.reshape(-1, rows.shape[-1])
    valid = r2 != I32_MAX
    bits = torch.zeros((r2.shape[0], n_bits + 1), dtype=torch.bool,
                       device=rows.device)
    for mult in _MULTS[:n_hashes]:
        idx = torch.where(valid, _hash(r2, mult, n_bits), n_bits)
        bits.scatter_(1, idx, True)
    bits = bits[:, :n_bits].reshape(-1, n_words, 32)
    low = (bits[..., :31].to(torch.int32)
           << torch.arange(31, dtype=torch.int32, device=rows.device))
    words = low.sum(-1, dtype=torch.int32)
    # bit 31 is the sign bit of the int32 pattern (no overflow: low < 2**31)
    words = torch.where(bits[..., 31], words - 2 ** 31, words)
    return words.reshape(*lead, n_words)


def bloom_maybe_contains(words: torch.Tensor, q: torch.Tensor,
                         n_hashes: int = NUM_HASHES) -> torch.Tensor:
    """bool[..., Q]: False guarantees the row is absent from the run.
    ``words`` is one filter ``[W]`` or a stack ``[K, W]``."""
    n_bits = words.shape[-1] * 32
    hit = None
    for mult in _MULTS[:n_hashes]:
        h = _hash(q, mult, n_bits)
        word = words[..., h >> 5]
        bit = ((word >> (h & 31).to(torch.int32)) & 1) == 1
        hit = bit if hit is None else hit & bit
    return hit


def bloom_maybe_contains_batch(words: torch.Tensor, q: torch.Tensor,
                               n_hashes: int = NUM_HASHES) -> torch.Tensor:
    """bool[K, Q] probe of a stacked batch of filters ``words[K, W]`` —
    the fused read path probes every resident L0 run of a shard at once."""
    return bloom_maybe_contains(words, q, n_hashes)


def fence_build(rows: torch.Tensor, block: int) -> torch.Tensor:
    """Fence pointers: first row id of every ``block``-entry block.

    The in-memory analogue of RFile index blocks: a query's start position
    is bracketed to one block by searching the (tiny) fence array.
    """
    return rows[..., ::block].contiguous()
