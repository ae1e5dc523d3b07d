"""Public wrapper of flash attention, the self-attention of the LM's prefill
and decode steps (``models.layers.attention``). A CUDA tensor goes to the
hand kernel (``csrc/flash_attention.cu``) or raises; a CPU tensor goes to
the plain version."""
import torch

from ..common import cdiv, check_cuda, launch
from .ref import flash_attention_ref

HEAD_DIMS = (64, 128)  # the head dims the kernel is built for
_MAX_ROW_BLOCKS = 65535  # the grid's y extent: blocks of 8 query rows


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, hd]; k, v: [B, Sk, KV, hd] with H a multiple of KV ->
    [B, Sq, H, hd] in ``q.dtype``. Any Sq and Sk; ``q_offset`` (>= 0) is
    the position of query row 0 for the causal mask. On the card: bf16 or
    float32, hd 64 or 128."""
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
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention: the kernel takes bf16 or float32, "
                        f"got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes hd in "
                         f"{HEAD_DIMS}, got {hd}")
    if sk == 0 or cdiv(sq, 8) > _MAX_ROW_BLOCKS:
        raise ValueError(f"flash_attention: Sk={sk}, Sq={sq} out of range")
    # the kernel reads K and V in 16-byte loads: a view that starts off a
    # 16-byte boundary is copied to a fresh (aligned) tensor first
    q, k, v = (x.contiguous() if x.data_ptr() % 16 == 0 else x.clone(
        memory_format=torch.contiguous_format) for x in (q, k, v))
    check_cuda("flash_attention", (q, q.dtype), (k, q.dtype), (v, q.dtype))
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), o.data_ptr(), b, sq, sk, h, kvh, hd, int(causal),
           int(q_offset), int(q.dtype == torch.bfloat16))
    return o
