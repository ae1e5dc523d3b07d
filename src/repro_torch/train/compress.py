"""Gradient compression for cross-pod reduces (a copy of the JAX package's
``train/compress.py``).

Two schemes, both with error feedback so compression error accumulates into
the next step instead of being lost:

  * top-k sparsification — keep the k largest-|g| entries per tensor; ties
    go to the lower index, as ``jax.lax.top_k`` orders them.
  * int8 quantization   — per-block scale.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..models.spec import flatten_up_to, tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    scheme: str = "int8"          # "int8" | "topk" | "none"
    topk_frac: float = 0.01
    block: int = 256


# ----------------------------------------------------------------- top-k
def topk_compress(g: torch.Tensor, frac: float):
    flat = g.reshape(-1).float()
    k = max(int(flat.shape[0] * frac), 1)
    # descending |g|, the lower index first among equals (a stable sort)
    idx = torch.sort(-flat.abs(), stable=True).indices[:k]
    sel = flat[idx]
    return (idx.to(torch.int32), sel), tuple(g.shape), flat.shape[0]


def topk_decompress(payload, shape, n: int) -> torch.Tensor:
    idx, vals = payload
    out = torch.zeros(n, dtype=torch.float32, device=vals.device)
    out[idx.long()] = vals
    return out.reshape(shape)


# ------------------------------------------------------------------ int8
def int8_compress(g: torch.Tensor, block: int = 256):
    flat = g.reshape(-1).float()
    n = flat.shape[0]
    pad = (-n) % block
    b = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    scale = b.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(b / scale), -127, 127).to(torch.int8)
    return (q, scale.float()), tuple(g.shape), n


def int8_decompress(payload, shape, n: int) -> torch.Tensor:
    q, scale = payload
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


# -------------------------------------------------------- error feedback
def compress_with_feedback(grads, residual, cfg: CompressConfig):
    """(compressed-then-decompressed grads, new residual).

    The returned grads are what the wire delivers; residual carries the
    quantization/sparsification error into the next step (EF-SGD)."""
    if cfg.scheme == "none":
        return grads, residual

    def one(g, r):
        c = g.float() + r
        if cfg.scheme == "topk":
            payload, shape, n = topk_compress(c, cfg.topk_frac)
            d = topk_decompress(payload, shape, n)
        else:
            payload, shape, n = int8_compress(c, cfg.block)
            d = int8_decompress(payload, shape, n)
        return d.to(g.dtype), c - d

    out = [one(g, r) for g, r in zip(tree_leaves(grads),
                                     flatten_up_to(grads, residual))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def zero_residual(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def wire_bytes(grads, cfg: CompressConfig) -> Tuple[int, int]:
    """(uncompressed fp32 bytes, compressed wire bytes)."""
    sizes = [int(np.prod(g.shape)) for g in tree_leaves(grads)]
    raw = sum(n * 4 for n in sizes)
    if cfg.scheme == "int8":
        comp = sum(n * (1 + 4 / cfg.block) for n in sizes)
    elif cfg.scheme == "topk":
        comp = sum(int(n * cfg.topk_frac) * 8 for n in sizes)
    else:
        comp = raw
    return raw, int(comp)
