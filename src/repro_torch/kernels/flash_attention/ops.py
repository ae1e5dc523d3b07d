"""Public wrapper of flash attention, the attention of every LM family's
prefill, decode and training steps (``models.layers``). A plain CPU tensor
goes to the plain version; any other tensor goes through the registered
op ``torch.ops.repro_torch.flash_attention``, whose CUDA implementation is
the hand kernel (``csrc/flash_attention.cu``, or a raise).

The op returns ``(o, lse)``: the output and, when asked for, the rows'
float32 log-sum-exp [B, H, Sq] (the TPU kernel's ``m + log l``; an empty
tensor otherwise), which merges attention over key shards. Being an op,
it is seen by dispatch modes: ``FakeTensorMode`` runs its fake
implementation (it allocates o and lse, never the scores), ``launch.
op_cost.OpCost`` counts it by formula (``attention_cost``), and DTensor
runs it on each rank's shards (replicated or batch-sharded; the mesh
placements of ``models.sharded_attention`` go further). Its backward
recomputes the plain version (``flash_attention_bwd_ref``), as the JAX
package's training path differentiates its plain attention and recomputes
the scores of its blocked form; there is no backward kernel."""
import torch

from ..common import cdiv, check_cuda, launch
from .ref import flash_attention_bwd_ref, flash_attention_ref

HEAD_DIMS = (8, 16, 64, 80, 112, 128)  # the head dims the kernel is built for
_MAX_GRID_Y = 65535  # the grid's y extent (float32 prefill: blocks of 8 rows)
_DECODE_ROWS = 16  # Sq below this runs the split-K decode
_DECODE_KEYS = 64  # keys per tile of a decode split
_DECODE_BLOCKS = 512  # splits stop growing once the grid holds this many
_DECODE_UNSPLIT = 4  # up to this many tiles, one block walks them all


def decode_splits(b: int, sq: int, sk: int, h: int, kvh: int, causal: bool,
                  q_offset: int) -> int:
    """Key splits of the split-K decode: one per 64-key tile up to the
    causal limit, fewer (several tiles each) once the grid (KV groups x
    blocks of 16 rows x splits) would pass ~512 blocks; none (no merge
    kernel) for a cache of at most 4 tiles."""
    key_end = min(sk, q_offset + sq) if causal else sk
    tiles = cdiv(key_end, _DECODE_KEYS)
    if tiles <= _DECODE_UNSPLIT:
        return 1
    blocks = b * kvh * cdiv(sq * (h // kvh), _DECODE_ROWS)
    return cdiv(tiles, max(1, tiles * blocks // _DECODE_BLOCKS))


def _plain(t: torch.Tensor) -> bool:
    """A tensor of no subclass (not fake, not a DTensor)."""
    return type(t) in (torch.Tensor, torch.nn.Parameter)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0, *,
                    return_lse: bool = False):
    """q: [B, Sq, H, hd]; k, v: [B, Sk, KV, hd] with H a multiple of KV ->
    [B, Sq, H, hd] in ``q.dtype``, or with ``return_lse`` (that, float32
    lse [B, H, Sq]). Any Sq and Sk; ``q_offset`` (>= 0) is the position of
    query row 0 for the causal mask. On the card: bf16 or float32, hd in
    ``HEAD_DIMS``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q[B, Sq, H, hd] and "
                         f"k, v[B, Sk, KV, hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not pair (H % KV == 0)")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset={q_offset} < 0")
    if q.device.type == "cpu" and _plain(q):
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   return_lse=return_lse)
    if not _plain(q):
        _dtensor_strategy()
    o, lse = torch.ops.repro_torch.flash_attention(q, k, v, bool(causal),
                                                   int(q_offset),
                                                   bool(return_lse))
    return (o, lse) if return_lse else o


# ----------------------------------------------------------- the registered op
@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, q_offset: int, return_lse: bool
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The CPU implementation: the plain version."""
    o, lse = flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                 return_lse=True)
    return o, (lse if return_lse else lse.new_empty(0))


@_attention_op.register_kernel("cuda")
def _attention_cuda(q, k, v, causal, q_offset, return_lse):
    return _launch(q, k, v, causal, q_offset, return_lse)


@_attention_op.register_fake
def _attention_fake(q, k, v, causal, q_offset, return_lse):
    b, sq, h, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, h, sq) if return_lse else (0,),
                        dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    q, k, v, causal, q_offset, return_lse = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal, ctx.q_offset, ctx.return_lse = causal, q_offset, return_lse


def _backward(ctx, dout, dlse):
    q, k, v = ctx.saved_tensors
    if dout is None:
        dout = torch.zeros_like(q)
    dq, dk, dv = flash_attention_bwd_ref(
        q, k, v, dout, causal=ctx.causal, q_offset=ctx.q_offset,
        dlse=dlse if ctx.return_lse else None)
    return dq, dk, dv, None, None, None


_attention_op.register_autograd(_backward, setup_context=_setup_context)

_strategy_registered = []


def _dtensor_strategy() -> None:
    """DTensor's placements of the op (registered at the first call on a
    subclass tensor): all replicated, or the batch dim sharded. Heads and
    rows are placed by ``models.sharded_attention``, which calls the op on
    each rank's local tensors."""
    if _strategy_registered:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _strategy(q, k, v, causal, q_offset, return_lse):
        scalars = [None] * 3
        lse = Shard(0) if return_lse else Replicate()
        return [([Replicate(), Replicate()], [Replicate()] * 3 + scalars),
                ([Shard(0), lse], [Shard(0)] * 3 + scalars)]

    _strategy_registered.append(True)


def attention_cost(q_shape, k_shape, causal: bool, q_offset: int,
                   elem_size: int, return_lse: bool = False):
    """(bytes, flops) of one forward call: q read and o written once (and
    lse, float32, when asked for), of K and V only the keys some row may
    see (the causal limit of the last row); four flops per (row, key, dim)
    pair the mask keeps (q.k and p.v, multiply + add): the causal
    triangle, not the square."""
    b, sq, h, hd = q_shape
    sk, kvh = k_shape[1], k_shape[2]
    if causal:
        pairs = _causal_pairs(sq, sk, q_offset)
        keys = max(0, min(sk, q_offset + sq))
    else:
        pairs, keys = sq * sk, sk
    n_bytes = elem_size * (2 * b * sq * h * hd + 2 * b * keys * kvh * hd)
    if return_lse:
        n_bytes += 4 * b * h * sq
    return n_bytes, 4 * b * h * hd * pairs


def _causal_pairs(sq: int, sk: int, q_offset: int) -> int:
    """(row, key) pairs kept under the causal mask: row i sees
    min(Sk, max(0, q_offset + i + 1)) keys."""
    lo = q_offset + 1  # keys row 0 would see, before the clamps
    hi = q_offset + sq  # keys the last row would see
    total = 0
    # rows seeing 0 keys (lo + i <= 0), a ramp, then rows seeing all Sk
    ramp_lo = max(lo, 1)
    ramp_hi = min(hi, sk)
    if ramp_hi >= ramp_lo:
        total += (ramp_lo + ramp_hi) * (ramp_hi - ramp_lo + 1) // 2
    full_rows = max(0, hi - max(lo - 1, sk))
    total += full_rows * sk
    return total


def _launch(q, k, v, causal: bool, q_offset: int, return_lse: bool = False):
    """One launch of the kernel on CUDA tensors (checked here): (o, lse),
    lse empty unless asked for."""
    for x in (q, k, v):
        if not _plain(x):  # a DTensor's storage is its shards'
            raise TypeError(f"flash_attention: the kernel takes plain CUDA "
                            f"tensors, got a {type(x).__name__}")
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention: the kernel takes bf16 or float32, "
                        f"got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes hd in "
                         f"{HEAD_DIMS}, got {hd}")
    if sk == 0 or cdiv(sq, 8) > _MAX_GRID_Y or b * kvh > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: Sk={sk}, Sq={sq}, B * KV = "
                         f"{b * kvh} out of range")
    # the kernel reads K and V in 16-byte loads: a view that starts off a
    # 16-byte boundary is copied to a fresh (aligned) tensor first
    q, k, v = (x.contiguous() if x.data_ptr() % 16 == 0 else x.clone(
        memory_format=torch.contiguous_format) for x in (q, k, v))
    check_cuda("flash_attention", (q, q.dtype), (k, q.dtype), (v, q.dtype))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq) if return_lse else (0,),
                      dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    splits = decode_splits(b, sq, sk, h, kvh, causal, q_offset) \
        if sq < _DECODE_ROWS else 0
    ws = None  # each split's (acc[hd], m, l) per row, in float32
    if splits > 1:
        ws = torch.empty(b * splits * sq * h * (hd + 2), dtype=torch.float32,
                         device=q.device)
    launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), o.data_ptr(), 0 if ws is None else ws.data_ptr(),
           lse.data_ptr() if return_lse else 0, b, sq, sk, h, kvh, hd,
           int(causal), int(q_offset), int(q.dtype == torch.bfloat16), splits)
    return o, lse
