"""AdamW with optional int8-quantized moments (a copy of the JAX package's
``train/optimizer.py``): int8 moments with per-row float32 scales cut the
optimizer state ~4x.

Quantized moments keep the parameter's exact shape; 1-D leaves (norm
scales, biases) stay float32. All arithmetic is float32 tensor math on the
parameters' device, the schedule and the bias corrections included, so it
rounds as the JAX package's float32 ops do. A plain leaf is updated a
block of rows (its last dim) at a time into the new state, so the float32
temporaries are one block's, not a whole leaf's several times over (the
arithmetic is elementwise, and a quantized moment's scale is per row).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models.layers import _plain
from ..models.spec import (PSpec, flatten_up_to, tree_leaves, tree_map,
                           tree_unflatten)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantized_state: bool = False    # int8 m/v with per-row f32 scales


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to 10% of peak, a 0-d float32 tensor
    (on ``step``'s device when it is a tensor, else on the CPU)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * prog))
    return cfg.peak_lr * warm * cos


# the rows of a plain leaf updated at once: the update's float32
# temporaries (~10 of them, the float64 root among them) are this block's
UPDATE_ELEMENTS = 1 << 25


def _quantizable(shape) -> bool:
    return len(shape) >= 2


def _q8_encode(x: torch.Tensor):
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.float()}


def _q8_decode(m) -> torch.Tensor:
    return m["q"].float() * m["s"]


def adamw_init(params, cfg: AdamWConfig):
    def zero_like(p):
        if cfg.quantized_state and _quantizable(p.shape):
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "s": torch.full(p.shape[:-1] + (1,), 1e-12,
                                    dtype=torch.float32, device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    return {"m": tree_map(zero_like, params),
            "v": tree_map(zero_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded as XLA's is: PyTorch's
    vectorised CPU sqrt is an ulp off in ~0.7% of entries, and the root
    taken in float64 rounds exactly to float32."""
    return torch.sqrt(x.double()).float()


def _global_norm(leaves) -> torch.Tensor:
    total = 0
    for g in leaves:  # the JAX order: leaf by leaf, from 0
        total = total + torch.sum(torch.square(g.float()))
    return _sqrt(total)


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig):
    """Returns (new_params, new_state). Gradients may be bf16; math in f32."""
    count = state["count"] + 1
    cf = count.float()
    lr = lr_at(cfg, count)
    flat_p = tree_leaves(params)
    flat_g = flatten_up_to(params, grads)
    gnorm = _global_norm(flat_g)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    def math(g, mf, vf, pf, decay):
        """(new parameter in float32, new m, new v) of one block."""
        g = g.float() * clip
        mf = cfg.b1 * mf + (1 - cfg.b1) * g
        vf = cfg.b2 * vf + (1 - cfg.b2) * g * g
        mh = mf / (1 - cfg.b1 ** cf)
        vh = vf / (1 - cfg.b2 ** cf)
        step_ = mh / (_sqrt(vh) + cfg.eps)
        return pf - lr * (step_ + decay * pf), mf, vf

    def upd(g, m, v, p):
        quant = cfg.quantized_state and _quantizable(p.shape)
        decay = cfg.weight_decay if p.dim() >= 2 else 0.0  # none on norms/bias
        if not _plain(p):  # a DTensor's update stays whole
            mf = _q8_decode(m) if quant else m
            vf = _q8_decode(v) if quant else v
            new_p, mf, vf = math(g, mf, vf, p.float(), decay)
            if quant:
                return new_p.to(p.dtype), _q8_encode(mf), _q8_encode(vf)
            return new_p.to(p.dtype), mf, vf
        new_p = _fresh(p)
        new_m, new_v = (({"q": _fresh(x["q"]), "s": _fresh(x["s"])} if quant
                         else _fresh(x)) for x in (m, v))
        rows = _rows(p)
        step = max(1, UPDATE_ELEMENTS // rows.shape[-1])
        for i in range(0, rows.shape[0], step):
            def block(t):
                return _rows(t)[i:i + step]
            mf = (_q8_decode({k: block(x) for k, x in m.items()}) if quant
                  else block(m))
            vf = (_q8_decode({k: block(x) for k, x in v.items()}) if quant
                  else block(v))
            pf, mf, vf = math(block(g), mf, vf, block(p).float(), decay)
            block(new_p).copy_(pf)
            for new, x in ((new_m, mf), (new_v, vf)):
                if quant:
                    enc = _q8_encode(x)
                    block(new["q"]).copy_(enc["q"])
                    block(new["s"]).copy_(enc["s"])
                else:
                    block(new).copy_(x)
        return new_p, new_m, new_v

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        flat_g, flatten_up_to(params, state["m"]),
        flatten_up_to(params, state["v"]), flat_p)]
    return (tree_unflatten(params, [o[0] for o in out]),
            {"m": tree_unflatten(params, [o[1] for o in out]),
             "v": tree_unflatten(params, [o[2] for o in out]),
             "count": count})


def _fresh(t: torch.Tensor) -> torch.Tensor:
    """An empty contiguous tensor of ``t``'s shape, dtype and device."""
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as rows of its last dim (a view where ``t`` is contiguous, as
    the new state is, else a copy to read)."""
    return t.reshape(-1, t.shape[-1])


def opt_state_specs(param_specs, cfg: AdamWConfig):
    """PSpec tree of the optimizer state: moments have the parameter's
    shape (int8 codes plus [..., 1] float32 scales when quantized)."""

    def mom(s: PSpec):
        if cfg.quantized_state and _quantizable(s.shape):
            return {"q": PSpec(s.shape, torch.int8, "zeros", axes=s.axes),
                    "s": PSpec(s.shape[:-1] + (1,), torch.float32, "zeros",
                               axes=s.axes[:-1] + (None,))}
        return PSpec(s.shape, torch.float32, "zeros", axes=s.axes)

    return {"m": tree_map(mom, param_specs),
            "v": tree_map(mom, param_specs),
            "count": PSpec((), torch.int32, "zeros")}
