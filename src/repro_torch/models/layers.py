"""Shared transformer layers: norms, RoPE, GQA self-attention (+KV cache),
cross-attention (enc-dec), MLPs, embedding, unembedding, the training loss
and the remat policies.

Plain functions on tensors over a parameter tree (``spec.py``), with the
JAX package's layouts: weights ``[in, out]`` (``x @ w``), activations
``[B, S, ...]``, heads ``[B, S, H, hd]``. Math in the parameter dtype with
float32 norms, RoPE angles and attention. Every attention, self and
cross, is ``kernels.flash_attention`` on every path: the JAX ``_sdpa`` and
``_blocked_sdpa`` (Sq >= 4096) compute the same function, except that
they round scores and weights to the activation dtype where the kernel
keeps float32. On the card its gradient is the plain version's, by
recompute (``kernels.flash_attention``).

Every forward takes the activation-sharding hook ``sh`` (``spec.
make_sharder``; None is the identity) and calls it where the JAX module
does. On a mesh (DTensors, or a hook that carries one) attention goes to
``sharded_attention``, which places #7's operands as the JAX rules place
``_blocked_sdpa``'s query blocks (its two ``attn_q`` sites, taken where
JAX takes the blocked form: causal and Sq >= ``BLOCKED_ATTN_MIN_SQ``) and
``_sdpa``'s sequence-sharded cache.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..kernels.flash_attention import flash_attention
from . import sharded_attention
from .config import ModelConfig
from .sharded_attention import merge_heads, split_heads
from .spec import PSpec, contiguous_stride, no_sharding


# ------------------------------------------------------------------- norms
def norm_specs(cfg: ModelConfig, prefix_shape=()) -> Dict:
    base = {"scale": PSpec(prefix_shape + (cfg.d_model,), torch.float32,
                           "ones")}
    if cfg.norm == "layernorm":
        base["bias"] = PSpec(prefix_shape + (cfg.d_model,), torch.float32,
                             "zeros")
    return base


def apply_norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm in float32 (+1e-6 inside the rsqrt), cast back."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
    y = y * p["scale"]
    if cfg.norm == "layernorm":
        y = y + p["bias"]
    return y.to(x.dtype)


# -------------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S]. Rotates the two halves of
    the head (not interleaved pairs) by float32 angles; cast back."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None, None].float() * freqs  # [..., S, 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- attention
BLOCKED_ATTN_MIN_SQ = 4096  # JAX's blocked attention: causal, Sq at least this


def attn_specs(cfg: ModelConfig, L=()) -> Dict:
    h, kv, d, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_model, cfg.hd
    dt = cfg.dtype
    lax_ = (None,) * len(L)
    p = {
        "wq": PSpec(L + (d, h * hd), dt, axes=lax_ + ("embed", "heads")),
        "wk": PSpec(L + (d, kv * hd), dt, axes=lax_ + ("embed", "kv_heads")),
        "wv": PSpec(L + (d, kv * hd), dt, axes=lax_ + ("embed", "kv_heads")),
        "wo": PSpec(L + (h * hd, d), dt, axes=lax_ + ("heads", "embed")),
    }
    if cfg.qkv_bias:
        for name, width, ax in (("bq", h * hd, "heads"),
                                ("bk", kv * hd, "kv_heads"),
                                ("bv", kv * hd, "kv_heads")):
            p[name] = PSpec(L + (width,), torch.float32, "zeros",
                            axes=lax_ + (ax,))
    return p


def _project_qkv(cfg: ModelConfig, p, x: torch.Tensor, sh=None):
    sh = sh or no_sharding
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:  # f32 biases cast to the activation dtype first
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = sh(q, "batch", "seq_inner", "heads")
    k = sh(k, "batch", "seq_inner", "kv_heads")
    v = sh(v, "batch", "seq_inner", "kv_heads")
    return (split_heads(q, cfg.n_heads, cfg.hd),
            split_heads(k, cfg.n_kv_heads, cfg.hd),
            split_heads(v, cfg.n_kv_heads, cfg.hd))


def _attend(q, k, v, sh, *, causal: bool, q_offset=None,
            kv_sharded: bool = False):
    """#7 over q, k, v: ``sharded_attention`` on a mesh, else one
    ``flash_attention`` call (without ``q_offset`` where None).
    ``kv_sharded``: k and v are the cache (placed on ``kv_seq``)."""
    blocked = causal and q.shape[1] >= BLOCKED_ATTN_MIN_SQ
    if sharded_attention.plan(q, k, sh, blocked=blocked,
                              kv_sharded=kv_sharded):
        return sharded_attention.attend(q, k, v, sh, causal=causal,
                                        q_offset=q_offset or 0,
                                        blocked=blocked,
                                        kv_sharded=kv_sharded)
    if q_offset is None:
        return flash_attention(q, k, v, causal=causal)
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset)


def attention(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor,
              *, causal: bool = True, use_rope: bool = True,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_pos: int = 0, sh=None):
    """Self-attention; returns (out, cache). ``cache=(k, v)`` of shape
    [B, Smax, KV, hd] takes the new keys and values at ``cache_pos`` (in
    place; the JAX function returns a new array of the same values) and
    the queries attend over all Smax slots, the causal mask hiding the
    ones past each query's position. ``use_rope=False`` leaves q and k
    unrotated (the enc-dec family's sinusoidal positions are added to the
    activations instead)."""
    sh = sh or no_sharding
    q, k, v = _project_qkv(cfg, p, x, sh)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if cache is not None:
        ck, cv = cache
        s = x.shape[1]
        if cache_pos + s > ck.shape[1]:
            raise ValueError(f"attention: positions {cache_pos}..{cache_pos + s}"
                             f" past the cache's {ck.shape[1]} slots")
        if not sharded_attention.write_cache(ck, k, cache_pos):
            ck[:, cache_pos:cache_pos + s] = k.to(ck.dtype)
        if not sharded_attention.write_cache(cv, v, cache_pos):
            cv[:, cache_pos:cache_pos + s] = v.to(cv.dtype)
        att = _attend(q, sh(ck, "batch", "kv_seq", None, None),
                      sh(cv, "batch", "kv_seq", None, None), sh,
                      causal=causal, q_offset=cache_pos, kv_sharded=True)
    else:
        att = _attend(q, k, v, sh, causal=causal)
    att = sh(merge_heads(att), "batch", "seq_inner", "heads")
    return sh(att @ p["wo"], "batch", "seq", "model_dim_act"), cache


def cross_attention(cfg: ModelConfig, p, x: torch.Tensor,
                    kv: Tuple[torch.Tensor, torch.Tensor],
                    sh=None) -> torch.Tensor:
    """The decoder's attention over encoder keys and values ``kv`` (each
    [B, Senc, KV, hd], from ``cross_kv``): ``x @ wq``, every query over
    every key (``flash_attention``, ``causal=False``), ``@ wo``; no bias,
    as in the JAX package. On a mesh the attention itself is
    ``sharded_attention``'s, and the output takes the self-attention's
    placement: the JAX module calls no ``sh`` here, and XLA reduces the
    heads' partial sums, where DTensor would carry them into the next
    layer's matmuls (each then replicating its weight)."""
    sh = sh or no_sharding
    q = split_heads(x @ p["wq"], cfg.n_heads, cfg.hd)
    att = _attend(q, kv[0], kv[1], sh, causal=False)
    return sh(merge_heads(att) @ p["wo"], "batch", "seq", "model_dim_act")


def cross_kv(cfg: ModelConfig, p, enc_out: torch.Tensor):
    """The cross-attention keys and values of ``enc_out`` [B, Senc, D]:
    (k, v), each [B, Senc, KV, hd]."""
    return (split_heads(enc_out @ p["wk"], cfg.n_kv_heads, cfg.hd),
            split_heads(enc_out @ p["wv"], cfg.n_kv_heads, cfg.hd))


# ---------------------------------------------------------------------- mlp
def mlp_specs(cfg: ModelConfig, L=()) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.dtype
    up = (None,) * len(L) + ("embed", "ff")
    down = (None,) * len(L) + ("ff", "embed")
    if cfg.mlp == "swiglu":
        return {
            "w_gate": PSpec(L + (d, f), dt, axes=up),
            "w_up": PSpec(L + (d, f), dt, axes=up),
            "w_down": PSpec(L + (f, d), dt, axes=down),
        }
    return {
        "w_in": PSpec(L + (d, f), dt, axes=up),
        "w_out": PSpec(L + (f, d), dt, axes=down),
    }


def apply_mlp(cfg: ModelConfig, p, x: torch.Tensor, sh=None) -> torch.Tensor:
    sh = sh or no_sharding
    if cfg.mlp == "swiglu":
        h = sh(F.silu(x @ p["w_gate"]) * (x @ p["w_up"]), "batch",
               "seq_inner", "ff")
        out = h @ p["w_down"]
    else:  # jax.nn.gelu defaults to the tanh approximation
        h = sh(F.gelu(x @ p["w_in"], approximate="tanh"), "batch",
               "seq_inner", "ff")
        out = h @ p["w_out"]
    return sh(out, "batch", "seq", "model_dim_act")


# ------------------------------------------------------------------- embed
def embed_specs(cfg: ModelConfig) -> Dict:
    d = {"embedding": PSpec((cfg.vocab_padded, cfg.d_model), cfg.dtype,
                            axes=("vocab", "embed"))}
    if not cfg.tie_embeddings:
        d["lm_head"] = PSpec((cfg.d_model, cfg.vocab_padded), cfg.dtype,
                             axes=("embed", "vocab"))
    return d


def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``. Where the DTensor table is sharded
    on the vocab, each rank takes the rows of its own shard (zeros for the
    others) and one all-reduce over those ranks adds them, as XLA
    partitions the gather. On the other mesh dims the rows follow the
    tokens where those are sharded (the table gathered there, and its
    gradient from each shard a part of a sum), else the table's embed dim.
    (DTensor's own rules for the lookup and its backward differ between
    PyTorch versions.)"""
    from .spec import shard_mesh_dim
    w = p["embedding"]
    i = None if _plain(w) else shard_mesh_dim(w, 0)
    if i is None:
        return w[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = w.device_mesh
    if _plain(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    # a rank's tokens against the table's vocab rows: where the tokens are
    # split on a mesh dim that splits the table's embed dim too, gather
    # the table there, or, when the tokens are fewer than its rows (a
    # decode step), gather the tokens and keep the embed dim split
    few = math.prod(tokens.to_local().shape) < w.shape[0] // mesh.shape[i]
    on_w, on_grad, on_rows, on_tok = [], [], [], []  # by mesh dim
    for j, x in enumerate(tokens.placements):
        embed = w.placements[j] == Shard(1)
        if j == i:
            on_w.append(Shard(0))
            on_grad.append(Shard(0))
            on_rows.append(Partial())
            on_tok.append(Replicate())
        elif isinstance(x, Shard) and not (embed and few):
            on_w.append(Replicate())  # the table gathered
            on_grad.append(Partial())
            on_rows.append(x)
            on_tok.append(x)
        elif embed:  # the table's embed dim stays split
            on_w.append(Shard(1))
            on_grad.append(Shard(1))
            on_rows.append(Shard(tokens.dim()))
            on_tok.append(Replicate())
        else:
            on_w.append(Replicate())
            on_grad.append(Replicate())
            on_rows.append(Replicate())
            on_tok.append(Replicate())
    tl = tokens.redistribute(mesh, on_tok).to_local().long()
    wl = w.redistribute(mesh, on_w).to_local(grad_placements=on_grad)
    ids = tl - mesh.get_coordinate()[i] * wl.shape[0]
    hit = (ids >= 0) & (ids < wl.shape[0])
    rows = torch.where(hit[..., None], wl[ids.clamp(0, wl.shape[0] - 1)],
                       torch.zeros((), dtype=wl.dtype, device=wl.device))
    shape = tuple(tokens.shape) + (w.shape[1],)
    on_rows_sum = [Replicate() if j == i else x for j, x in enumerate(on_rows)]
    return DTensor.from_local(rows, mesh, on_rows, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape)).redistribute(
        mesh, on_rows_sum)


def unembed(cfg: ModelConfig, p, x: torch.Tensor, sh=None) -> torch.Tensor:
    """Logits over ``vocab_padded`` (the pad rows included, as in the JAX
    package), computed in the parameter dtype and returned as float32."""
    sh = sh or no_sharding
    w = p["embedding"].T if cfg.tie_embeddings else p["lm_head"]
    return sh((x @ w).float(), "batch", "seq_unembed", "vocab")


def softmax_xent(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in float32 (the JAX function): the
    pad-vocab columns set to -1e30, then logsumexp minus the gold logit,
    averaged over ``mask`` with a denominator of at least 1."""
    logits = logits.float()
    v = logits.shape[-1]
    keep = torch.arange(v, device=logits.device)[None, None, :] < cfg.vocab
    logits = torch.where(keep, logits, torch.full((), -1e30,
                                                  device=logits.device))
    lse = _logsumexp(logits)
    gold = gold_logit(logits, labels)
    nll = lse - gold
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp`` over the last dim; on DTensor logits sharded on
    it (for which DTensor's logsumexp gathers the vocab), the max and the
    sum of exponentials, each reduced over the shards, the sum before its
    log (so that the log's backward divides by the whole sum)."""
    from .spec import shard_mesh_dim
    if _plain(logits) or shard_mesh_dim(logits, -1) is None:
        return torch.logsumexp(logits, dim=-1)
    from torch.distributed.tensor import Partial, Replicate
    top = logits.detach().amax(-1)
    total = torch.exp(logits - top[..., None]).sum(-1)
    total = total.redistribute(total.device_mesh, [
        Replicate() if isinstance(p, Partial) else p
        for p in total.placements])
    return torch.log(total) + top


def gold_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]``: a masked sum over the vocab, exact (every
    other term is a zero). Where DTensor logits are sharded on the vocab,
    each rank sums its own columns and the result is ``Partial`` over those
    ranks (DTensor's masked-partial gather, by hand: its own fails at the
    reduction), so that no rank gathers the vocab."""
    from .spec import shard_mesh_dim
    i = shard_mesh_dim(logits, -1) if not _plain(logits) else None
    if i is None:
        hit = torch.arange(logits.shape[-1], device=logits.device) == \
            labels[..., None].long()
        return torch.where(hit, logits,
                           torch.zeros((), device=logits.device)).sum(-1)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh, pl = logits.device_mesh, list(logits.placements)
    if _plain(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    lab = labels.redistribute(mesh, [Replicate() if j == i else p
                                     for j, p in enumerate(pl)]).to_local()
    local = logits.to_local()
    lo = mesh.get_coordinate()[i] * local.shape[-1]
    hit = torch.arange(lo, lo + local.shape[-1], device=local.device) == \
        lab[..., None].long()
    part = torch.where(hit, local, torch.zeros((), device=local.device))
    return DTensor.from_local(part.sum(-1), mesh,
                              [Partial() if j == i else p
                               for j, p in enumerate(pl)], run_check=False,
                              shape=labels.shape,
                              stride=contiguous_stride(labels.shape))


def _plain(t) -> bool:
    from torch.distributed.tensor import DTensor
    return not isinstance(t, DTensor)


def next_token_loss(cfg: ModelConfig, logits: torch.Tensor,
                    tokens: torch.Tensor) -> torch.Tensor:
    """``softmax_xent`` of ``logits`` [B, S, V] against the next token of
    ``tokens`` [B, S], the last position masked (every family's
    ``train_loss``)."""
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                       dim=1)
    # made from the tokens, so that DTensor tokens give a mask (and a loss
    # gradient) on the batch's shards
    f32 = torch.float32
    mask = torch.cat([torch.ones_like(tokens[:, 1:], dtype=f32),
                      torch.zeros_like(tokens[:, :1], dtype=f32)], dim=1)
    return softmax_xent(cfg, logits, labels, mask)


# ------------------------------------------------------------------- remat
_aten = torch.ops.aten
# The JAX checkpoint policies by name: None runs a layer without a
# checkpoint; otherwise each layer is one checkpoint that keeps the outputs
# of these ops and recomputes the rest in the backward ("dots_no_batch":
# ``x @ w`` reaches the dispatcher as ``mm``; "dots" also keeps batched
# products; "nothing" keeps none).
REMAT_POLICIES = {
    "none": None,
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
    "nothing": (),
}


def remat_runner(remat: str):
    """``run(fn, *args)``: ``fn(*args)`` as one checkpoint under the remat
    policy ``remat`` (a ``REMAT_POLICIES`` name; another raises
    ``KeyError``), or plainly under ``"none"``."""
    saved = REMAT_POLICIES[remat]
    if saved is None:
        return lambda fn, *args: fn(*args)
    kw = {"use_reentrant": False}
    if saved:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, list(saved))
    return lambda fn, *args: checkpoint(fn, *args, **kw)
