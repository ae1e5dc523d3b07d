"""Parameter specs: one declaration drives initialisation and the shapes of
the serving inputs. A parameter tree is a nested dict of tensors with the
JAX package's structure (stacked ``[L, ...]`` block leaves)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PSpec:
    """Shape, dtype and initialiser of one parameter leaf (the JAX spec's
    logical axis names come with the mesh item)."""
    shape: Tuple[int, ...]
    dtype: Any = torch.bfloat16
    init: str = "normal"              # normal | zeros | ones


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested dict / tuple / list (a
    ``PSpec`` or a tensor is a leaf); dict keys are visited sorted."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict / tuple / list in ``tree_map``'s order
    (the JAX flatten order: dict keys sorted)."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in flatten order."""
    it = iter(leaves)
    tree = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return tree


def flatten_up_to(like, tree) -> list:
    """The subtrees of ``tree`` that sit at the leaves of ``like``'s
    structure, in flatten order (``jax.tree`` ``flatten_up_to``)."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in flatten_up_to(like[k],
                                                               tree[k])]
    if isinstance(like, (tuple, list)):
        return [x for a, b in zip(like, tree) for x in flatten_up_to(a, b)]
    return [tree]


def init_params(specs, generator: torch.Generator, scale: float = 0.02,
                device=None):
    """Materialise a parameter tree from a spec tree: "zeros" and "ones"
    leaves, and normal draws from ``generator`` with std
    ``min(scale, fan_in**-0.5)`` (the JAX rule; the draws themselves differ
    from ``jax.random``'s). Tensors land on ``device`` (default: the
    generator's)."""
    dev = torch.device(device) if device is not None else generator.device

    def one(s: PSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = min(scale, (1.0 / max(fan_in, 1)) ** 0.5)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * std).to(dtype=s.dtype, device=dev)

    return tree_map(one, specs)


def param_count(specs) -> int:
    shapes = []
    tree_map(lambda s: shapes.append(s.shape), specs)
    return sum(int(np.prod(shape)) for shape in shapes)

