"""The port's bloom filters against the JAX package's: the packed words
must be bit-identical for the same rows (I32_MAX pads included), and the
probes must agree, -1 query pads included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.db.lsm import bloom as jb
from repro_torch.db.lsm import bloom as tb
from repro_torch.kernels.common import I32_MAX


def _rows(rng, n_runs, cap):
    rows = np.full((n_runs, cap), I32_MAX, np.int32)
    for k in range(n_runs):
        m = int(rng.integers(0, cap + 1))
        rows[k, :m] = np.sort(rng.integers(0, 2 ** 31 - 1, m))
    return rows


@pytest.mark.parametrize("n_hashes", [1, 4, 8])
@pytest.mark.parametrize("n_words", [2, 32, 256])
def test_bloom_words_bit_identical(n_hashes, n_words):
    rng = np.random.default_rng(n_hashes * 1000 + n_words)
    rows = _rows(rng, 3, 200)
    got = tb.bloom_build(torch.from_numpy(rows), n_words, n_hashes).numpy()
    for k in range(3):
        want = np.asarray(jb.bloom_build(jnp.asarray(rows[k]), n_words,
                                         n_hashes))
        np.testing.assert_array_equal(got[k].view(np.uint32), want)
    # probes: present rows, random ids (including negatives) and -1 pads
    q = np.concatenate([rows[0][rows[0] != I32_MAX][:40],
                        rng.integers(-2 ** 31, 2 ** 31 - 1, 60),
                        [-1, -1, 0, I32_MAX - 1]]).astype(np.int32)
    want_words = np.stack([np.asarray(jb.bloom_build(jnp.asarray(r), n_words,
                                                     n_hashes)) for r in rows])
    hit = tb.bloom_maybe_contains_batch(torch.from_numpy(got),
                                        torch.from_numpy(q), n_hashes).numpy()
    want = np.asarray(jb.bloom_maybe_contains_batch(
        jnp.asarray(want_words), jnp.asarray(q), n_hashes))
    np.testing.assert_array_equal(hit, want)
    one = tb.bloom_maybe_contains(torch.from_numpy(got[0]),
                                  torch.from_numpy(q), n_hashes).numpy()
    np.testing.assert_array_equal(one, np.asarray(jb.bloom_maybe_contains(
        jnp.asarray(want_words[0]), jnp.asarray(q), n_hashes)))


def test_bloom_has_no_false_negatives_and_empty_is_zero():
    rng = np.random.default_rng(1)
    rows = _rows(rng, 1, 500)[0]
    words = tb.bloom_build(torch.from_numpy(rows), tb.num_words(500))
    valid = rows[rows != I32_MAX]
    assert tb.bloom_maybe_contains(words, torch.from_numpy(valid)).all()
    empty = tb.bloom_build(torch.full((64,), I32_MAX, dtype=torch.int32), 4)
    assert (empty == 0).all()


def test_sizing_helpers_match():
    for cap in (1, 8, 1000, 1 << 18):
        for bits in (4, 8, 16):
            assert tb.num_words(cap, bits) == jb.num_words(cap, bits)
    assert tb.suggest_hashes(10) == jb.suggest_hashes(10)
    assert tb.theoretical_fp_rate(100, 32, 4) == jb.theoretical_fp_rate(
        100, 32, 4)
    rows = np.arange(37, dtype=np.int32)
    np.testing.assert_array_equal(
        tb.fence_build(torch.from_numpy(rows), 5).numpy(),
        np.asarray(jb.fence_build(jnp.asarray(rows), 5)))
