"""Public wrapper of flash attention, the self-attention of the LM's
prefill, decode and training steps (``models.layers.attention``). A CUDA
tensor goes to the hand kernel (``csrc/flash_attention.cu``) or raises; a
CPU tensor goes to the plain version.

On the card the kernel is the forward of a ``torch.autograd.Function``
whose backward recomputes the plain version (``flash_attention_bwd_ref``),
as the JAX package's training path differentiates its plain attention and
recomputes the scores of its blocked form; there is no backward kernel."""
import torch

from ..common import cdiv, check_cuda, launch
from .ref import flash_attention_bwd_ref, flash_attention_ref

HEAD_DIMS = (64, 80, 112, 128)  # the head dims the kernel is built for
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, hd]; k, v: [B, Sk, KV, hd] with H a multiple of KV ->
    [B, Sq, H, hd] in ``q.dtype``. Any Sq and Sk; ``q_offset`` (>= 0) is
    the position of query row 0 for the causal mask. On the card: bf16 or
    float32, hd 64, 80, 112 or 128."""
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
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    return _Attention.apply(q, k, v, bool(causal), int(q_offset))


class _Attention(torch.autograd.Function):
    """The kernel forward; the backward recomputes the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.q_offset = causal, q_offset
        return _launch(q, k, v, causal, q_offset)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_ref(q, k, v, dout, causal=ctx.causal,
                                             q_offset=ctx.q_offset)
        return dq, dk, dv, None, None


def _launch(q, k, v, causal: bool, q_offset: int) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors (checked here)."""
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
    if o.numel() == 0:
        return o
    splits = decode_splits(b, sq, sk, h, kvh, causal, q_offset) \
        if sq < _DECODE_ROWS else 0
    ws = None  # each split's (acc[hd], m, l) per row, in float32
    if splits > 1:
        ws = torch.empty(b * splits * sq * h * (hd + 2), dtype=torch.float32,
                         device=q.device)
    launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), o.data_ptr(), 0 if ws is None else ws.data_ptr(), b,
           sq, sk, h, kvh, hd, int(causal), int(q_offset),
           int(q.dtype == torch.bfloat16), splits)
    return o
