"""Weights and optimizer state carried across from the JAX package: its
pytrees, as numpy arrays, to the port's trees, bit for bit (and back to
numpy for comparisons).

A JAX bfloat16 array becomes numpy with dtype ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects; its 16-bit words are reinterpreted through
``int16`` instead, so nothing here imports ``ml_dtypes`` or jax."""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.common import resolve_device
from .api import build
from .config import ModelConfig
from .spec import PSpec, tree_map


def tensor_from_numpy(arr: np.ndarray, dtype: torch.dtype,
                      device="cuda") -> torch.Tensor:
    """One leaf: a numpy array (a 2-byte float array is taken as bf16 words
    when ``dtype`` is bf16) -> a tensor of ``dtype`` on ``device``, same
    bits. Without a card this raises unless ``device="cpu"`` is given."""
    device = resolve_device(device)
    arr = np.array(arr, order="C")  # a copy; keeps a 0-d array 0-d
    if dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2:
            raise TypeError(f"expected 2-byte bf16 words, got {arr.dtype}")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
        if t.dtype != dtype:
            raise TypeError(f"expected {dtype}, got {t.dtype}")
    return t.to(device)


def leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host, a bf16 one as its uint16
    words (the form a JAX checkpoint writes)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def tree_to_numpy(tree):
    """A tree of tensors -> the same tree of numpy arrays (bf16 as words)."""
    return tree_map(leaf_to_numpy, tree)


def params_from_jax(cfg: ModelConfig, tree, device="cuda") -> dict:
    """The JAX parameter pytree of ``cfg``'s model (numpy leaves, stacked
    block leaves) -> the port's parameter tree (``build(cfg).param_specs``)
    on ``device``; every leaf's shape must match its spec. Without a card
    this raises unless ``device="cpu"`` is given."""
    return _from_specs(build(cfg).param_specs, tree, device)


def opt_state_from_jax(cfg: ModelConfig, opt_cfg, tree, device="cuda") -> dict:
    """The JAX ``adamw_init`` / ``adamw_update`` state of the parameters of
    ``cfg`` (numpy leaves: ``m``, ``v`` — ``{"q", "s"}`` per quantized
    leaf under ``opt_cfg.quantized_state`` — and ``count``) -> the port's
    state on ``device``, bit for bit."""
    from ..train.optimizer import opt_state_specs  # train imports models
    return _from_specs(opt_state_specs(build(cfg).param_specs, opt_cfg),
                       tree, device)


def _from_specs(specs, tree, device) -> dict:
    device = resolve_device(device)

    def pick(path_tree, spec_tree):
        if isinstance(spec_tree, dict):
            if set(path_tree) != set(spec_tree):
                raise KeyError(f"keys {sorted(path_tree)} vs the specs' "
                               f"{sorted(spec_tree)}")
            return {k: pick(path_tree[k], spec_tree[k]) for k in spec_tree}
        s: PSpec = spec_tree
        arr = np.asarray(path_tree)
        if tuple(arr.shape) != tuple(s.shape):
            raise ValueError(f"shape {arr.shape} vs the spec's {s.shape}")
        return tensor_from_numpy(arr, s.dtype, device)

    return pick(tree, specs)
