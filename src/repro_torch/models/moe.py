"""Mixture-of-Experts layer: top-k router + sort-based scatter dispatch (the
JAX package's ``models/moe.py``, local path).

Tokens are flat-sorted by expert id, positioned within their expert by rank
arithmetic, and scattered into a dense [E, C, d] buffer; overflow beyond the
capacity C = ceil8(T * k / E * capacity_factor + 1) is dropped (the aux
loss tracks the balance). The experts are batched matrix products outside
any hand kernel.

Only the local path is here: the expert-parallel ``_apply_moe_spmd`` and
its int8 weight gather ``gather_w_int8`` need a mesh and come with ROADMAP
Queue 1 item 11i. Three choices keep the port's routing and sums the JAX
package's: the top k is the first k of a stable descending sort (on ties
the lower expert first, as ``lax.top_k``), the dispatch sort is stable, and
a token's contributions are added in ascending expert order in the
activation dtype (XLA's scatter-add order on the CPU; ``index_add_`` is
atomic on the card, its order unspecified)."""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import layers
from .config import ModelConfig
from .spec import PSpec


def moe_specs(cfg: ModelConfig, L=()) -> Dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.dtype
    specs = {
        "router": PSpec(L + (d, e), torch.float32),
        "w_gate": PSpec(L + (e, d, f), dt),
        "w_up": PSpec(L + (e, d, f), dt),
        "w_down": PSpec(L + (e, f, d), dt),
    }
    if cfg.n_shared_experts:
        specs["shared"] = layers.mlp_specs(_shared_cfg(cfg), L)
    return specs


def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, d_ff=cfg.d_ff * cfg.n_shared_experts)


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.experts_per_token * cfg.capacity_factor
            / cfg.n_experts) + 1
    return -(-c // 8) * 8  # keep the E-buffer lane-aligned


class Routing(NamedTuple):
    """One layer's routing of T tokens to k of E experts. Per token:
    ``probs`` [T, E] float32, ``eidx`` [T, k] (best first); per
    (token, choice) pair in dispatch order (stable by expert): ``stok``
    the token, ``sgate`` its renormalised gate, ``slot`` its buffer row
    (``E * cap`` when dropped) and ``keep``; ``order`` maps dispatch
    order to the flat (token, choice) order."""
    probs: torch.Tensor
    eidx: torch.Tensor
    order: torch.Tensor
    stok: torch.Tensor
    sgate: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    cap: int


def route(cfg: ModelConfig, router: torch.Tensor,
          xt: torch.Tensor) -> Routing:
    """Router and dispatch of ``xt`` [T, d] (JAX ``_apply_moe_local``'s
    first half)."""
    t = xt.shape[0]
    k, e = cfg.experts_per_token, cfg.n_experts
    logits = xt.float() @ router
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, eidx = vals[:, :k], idx[:, :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    dev = xt.device
    flat_e = eidx.reshape(t * k)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    se, order = torch.sort(flat_e, stable=True)
    stok, sgate = flat_tok[order], gate_vals.reshape(t * k)[order]
    starts = torch.searchsorted(se, torch.arange(e, device=dev))
    pos_in_e = torch.arange(t * k, device=dev) - starts[se]
    cap = capacity(cfg, t)
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e,
                       torch.full_like(se, e * cap))
    return Routing(probs, eidx, order, stok, sgate, slot, keep, cap)


def combine(r: Routing, out: torch.Tensor, dtype: torch.dtype
            ) -> torch.Tensor:
    """The experts' outputs ``out`` [E * cap, d] back to their tokens: each
    kept pair's output times its gate, a token's k contributions added in
    ascending expert order in ``dtype`` (the order in which XLA applies
    JAX's scatter-add ``y.at[stok].add(contrib)`` on the CPU). [T, d]."""
    t, k = r.eidx.shape
    d = out.shape[1]
    # each pair's contribution in dispatch order, then in flat (token,
    # choice) order, then a token's choices sorted by expert id
    contrib = out[r.slot.clamp(max=out.shape[0] - 1)] * r.sgate[:, None].to(
        dtype)
    contrib = torch.where(r.keep[:, None], contrib, torch.zeros_like(contrib))
    flat = torch.empty_like(contrib).index_copy(0, r.order, contrib)
    by_expert = r.eidx.argsort(dim=1)
    c = flat.reshape(t, k, d).gather(
        1, by_expert[:, :, None].expand(t, k, d))
    y = c[:, 0]
    for j in range(1, k):
        y = y + c[:, j]
    return y


def apply_moe(cfg: ModelConfig, p, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y [B, S, D], aux loss, 0-d float32)."""
    b, s, d = x.shape
    e = cfg.n_experts
    xt = x.reshape(b * s, d)
    r = route(cfg, p["router"], xt)
    cap = r.cap

    # dispatch: row e * cap takes every dropped pair and is cut off (JAX's
    # scatter with mode="drop")
    buf = xt.new_zeros(e * cap + 1, d).index_copy(0, r.slot, xt[r.stok])
    buf = buf[:e * cap].reshape(e, cap, d)

    # expert FFN (swiglu)
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    out = torch.bmm(F.silu(g) * u, p["w_down"]).reshape(e * cap, d)

    y = combine(r, out, x.dtype).reshape(b, s, d)

    if cfg.n_shared_experts:
        y = y + layers.apply_mlp(_shared_cfg(cfg), p["shared"], x)

    # load-balance aux loss (Switch-style)
    me = r.probs.mean(0)
    ce = F.one_hot(r.eidx, e).float().sum(1).mean(0)
    aux = e * torch.sum(me * ce)
    return y, aux
