"""Plain PyTorch version of flash attention (what the CUDA kernel is held
against): naive scaled dot-product attention with grouped GQA, in float32."""
import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, q_offset: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, hd]; k, v: [B, Sk, KV, hd] -> [B, Sq, H, hd] in
    ``q.dtype``. Query head h reads KV head h // (H / KV); scores are f32,
    scaled by hd**-0.5; with ``causal`` a score is kept where
    ``q_offset + i >= j`` and set to -1e30 elsewhere."""
    b, sq, h, hd = q.shape
    kvh, sk = k.shape[2], k.shape[1]
    qg = q.reshape(b, sq, kvh, h // kvh, hd).float()
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * hd ** -0.5
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
        mask = qpos >= torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(~mask, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)
