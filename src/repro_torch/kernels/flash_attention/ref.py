"""Plain PyTorch version of flash attention (what the CUDA kernel is held
against): naive scaled dot-product attention with grouped GQA, in float32;
its row log-sum-exp; and its backward, by recompute."""
import torch

BWD_Q_BLOCK = 512  # query rows a backward recompute takes at once


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, q_offset: int = 0,
                        return_lse: bool = False):
    """q: [B, Sq, H, hd]; k, v: [B, Sk, KV, hd] -> [B, Sq, H, hd] in
    ``q.dtype``. Query head h reads KV head h // (H / KV); scores are f32,
    scaled by hd**-0.5; with ``causal`` a score is kept where
    ``q_offset + i >= j`` and set to -1e30 elsewhere.

    ``return_lse``: also the row's log-sum-exp of the kept scaled scores,
    float32 [B, H, Sq] (the TPU kernel's ``m + log l``), as ``(o, lse)``.
    A row that keeps no key (a negative ``q_offset``, or no keys) has
    ``o = 0`` and ``lse = -inf``, so that it weighs nothing in a merge of
    key shards."""
    b, sq, h, hd = q.shape
    kvh, sk = k.shape[2], k.shape[1]
    qg = q.reshape(b, sq, kvh, h // kvh, hd).float()
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * hd ** -0.5
    blind = None  # [Sq, 1]: rows before key 0, which see no key
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
        mask = qpos >= torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(~mask, -1e30)
        if q_offset < 0:
            blind = qpos < 0
    w = torch.softmax(scores, dim=-1)
    if blind is not None:
        w = w.masked_fill(blind, 0.0)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w, v.float())
    out = out.reshape(b, sq, h, hd).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(scores, dim=-1)  # [B, KV, rep, Sq]
    if blind is not None:
        lse = lse.masked_fill(blind[:, 0], float("-inf"))
    return out, lse.reshape(b, h, sq)


def merge_shards_ref(parts):
    """The attention over the union of disjoint key shards from each
    shard's ``(o, lse)`` (``flash_attention_ref(..., return_lse=True)``):
    o = sum_r w_r o_r / sum_r w_r, w_r = exp(lse_r - max_r lse_r), in
    float32; a row no shard sees gets o = 0, lse = -inf. Returns
    (o in the shards' dtype, lse). The max is a stabiliser (the result
    does not depend on it), so it carries no gradient."""
    lses = torch.stack([lse for _, lse in parts])  # [n, B, H, Sq]
    top = lses.detach().amax(dim=0)
    safe = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(lses - safe)  # an empty shard's lse -inf: weight 0
    den = w.sum(dim=0)
    num = sum(o.float() * wr.transpose(1, 2)[..., None]
              for (o, _), wr in zip(parts, w))
    o = num / den.clamp_min(1e-30).transpose(1, 2)[..., None]
    return o.to(parts[0][0].dtype), safe + torch.log(den)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool, q_offset: int = 0,
                            q_block: int = BWD_Q_BLOCK, dlse=None):
    """(dq, dk, dv) of ``flash_attention_ref`` at (q, k, v) against the
    output gradient ``dout`` [B, Sq, H, hd] (and, given, the gradient of
    its log-sum-exp ``dlse`` [B, H, Sq]), each in its input's dtype.

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
            outs = flash_attention_ref(qb, kf, vf, causal=causal,
                                       q_offset=q_offset + lo,
                                       return_lse=dlse is not None)
            grads = dout[:, lo:lo + q_block]
            if dlse is not None:
                grads = (grads, dlse[:, :, lo:lo + q_block])
            gq, gk, gv = torch.autograd.grad(outs, (qb, kf, vf), grads)
            dqs.append(gq)
            dk += gk
            dv += gv
    dq = torch.cat(dqs, dim=1) if dqs else torch.zeros_like(q)
    return dq, dk.to(k.dtype), dv.to(v.dtype)
