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


# a normal leaf of more elements than this is drawn a slice at a time
SLICE_ELEMENTS = 1 << 28


def init_params(specs, generator: torch.Generator, scale: float = 0.02,
                device=None):
    """Materialise a parameter tree from a spec tree: "zeros" and "ones"
    leaves, and normal draws from ``generator`` with std
    ``min(scale, fan_in**-0.5)`` (the JAX rule; the draws themselves differ
    from ``jax.random``'s). Tensors land on ``device`` (default: the
    generator's). A leaf of more than ``SLICE_ELEMENTS`` elements is drawn
    along its leading axes, one slice of at most that many at a time, into
    a tensor of its own dtype, so the float32 transient is one slice; when
    ``device`` is not the generator's, its slices are drawn on ``device``
    by a generator seeded from one draw of ``generator`` (a host draw of
    billions of values takes minutes)."""
    dev = torch.device(device) if device is not None else generator.device

    def one(s: PSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = min(scale, (1.0 / max(fan_in, 1)) ** 0.5)
        if int(np.prod(s.shape)) > SLICE_ELEMENTS:
            return _sliced_normal(s, std, generator, dev)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * std).to(dtype=s.dtype, device=dev)

    return tree_map(one, specs)


def _sliced_normal(s: PSpec, std: float, generator: torch.Generator, dev):
    """A normal draw of ``s``'s shape in slices over its leading axes, each
    of at most ``SLICE_ELEMENTS`` elements where the trailing axes allow."""
    j = 0  # the fewest leading axes whose sub-blocks fit in a slice
    while j < len(s.shape) - 1 and \
            int(np.prod(s.shape[j:])) > SLICE_ELEMENTS:
        j += 1
    block = s.shape[j:]
    out = torch.empty(s.shape, dtype=s.dtype, device=dev)
    flat = out.view(-1, *block)
    step = max(1, SLICE_ELEMENTS // int(np.prod(block)))
    gen = generator
    if dev.type != generator.device.type:
        seed = int(torch.randint(1 << 62, (1,), generator=generator))
        gen = torch.Generator(device=dev).manual_seed(seed)
    for i in range(0, flat.shape[0], step):
        rows = min(step, flat.shape[0] - i)
        x = torch.randn((rows,) + tuple(block), generator=gen,
                        dtype=torch.float32, device=dev)
        flat[i:i + rows].copy_(x.mul_(std))
    return out


def param_count(specs) -> int:
    shapes = []
    tree_map(lambda s: shapes.append(s.shape), specs)
    return sum(int(np.prod(shape)) for shape in shapes)

