"""Plain PyTorch version of flash attention (what the CUDA kernel is held
against): naive scaled dot-product attention with grouped GQA, in float32;
and its backward, by recompute."""
import torch

BWD_Q_BLOCK = 512  # query rows a backward recompute takes at once


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


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool, q_offset: int = 0,
                            q_block: int = BWD_Q_BLOCK):
    """(dq, dk, dv) of ``flash_attention_ref`` at (q, k, v) against the
    output gradient ``dout`` [B, Sq, H, hd], each in its input's dtype.

    The forward is recomputed under autograd, ``q_block`` query rows at a
    time (the JAX ``_blocked_sdpa``'s 512), so the scores held at once are
    [B, KV, H / KV, q_block, Sk] in float32 at any Sq. Query rows are
    independent, so the blocks' dq are exact; their dk and dv add up in
    float32 (k and v enter as float32 leaves) before one cast."""
    kf = k.detach().float().requires_grad_()
    vf = v.detach().float().requires_grad_()
    dqs = []
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    with torch.enable_grad():
        for lo in range(0, q.shape[1], q_block):
            qb = q[:, lo:lo + q_block].detach().requires_grad_()
            out = flash_attention_ref(qb, kf, vf, causal=causal,
                                      q_offset=q_offset + lo)
            gq, gk, gv = torch.autograd.grad(out, (qb, kf, vf),
                                             dout[:, lo:lo + q_block])
            dqs.append(gq)
            dk += gk
            dv += gv
    dq = torch.cat(dqs, dim=1) if dqs else torch.zeros_like(q)
    return dq, dk.to(k.dtype), dv.to(v.dtype)
