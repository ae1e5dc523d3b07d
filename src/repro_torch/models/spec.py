"""Parameter specs: one declaration drives initialisation, the dry run's
fake tensors and the mesh placements (logical axis -> mesh axis rules). A
parameter tree is a nested dict of tensors with the JAX package's structure
(stacked ``[L, ...]`` block leaves).

A "pspec" here is a tuple with one entry per tensor dim: a mesh axis name,
a tuple of names (the dim sharded over several mesh axes, outer first), or
``None`` (replicated): the JAX ``PartitionSpec`` as a tuple. ``placements``
turns one into DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils._pytree import tree_map_only


@dataclasses.dataclass(frozen=True)
class PSpec:
    """Shape, dtype, initialiser and logical axis names (one per dim, None
    = replicated; all None when not given) of one parameter leaf."""
    shape: Tuple[int, ...]
    dtype: Any = torch.bfloat16
    init: str = "normal"              # normal | zeros | ones
    axes: Optional[Tuple[Optional[str], ...]] = None

    def __post_init__(self):
        if self.axes is None:
            object.__setattr__(self, "axes", (None,) * len(self.shape))
        if len(self.axes) != len(self.shape):
            raise ValueError(f"PSpec axes {self.axes} do not match shape "
                             f"{self.shape}")


def axis_sizes(mesh) -> dict:
    """{mesh axis name: size} of a ``DeviceMesh`` (or of any object with a
    ``shape`` dict, as a JAX mesh has)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    return dict(zip(names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical axis -> mesh axis mapping (a copy of the JAX package's)."""
    batch: Tuple[str, ...] = ("data",)       # data-parallel axes
    model: str = "model"                     # tensor-parallel axis
    fsdp: Optional[str] = None               # axis for ZeRO-3 param sharding
    seq: Optional[str] = None                # sequence parallelism (acts)
    kv_seq: Optional[str] = None             # decode KV-cache sequence axis
    expert: Optional[str] = "model"          # expert parallelism
    tp_enabled: bool = True                  # False: replicate weights, use
                                             # the model axis for seq/attn_q
    vocab_mode: str = "tp"                   # "tp" | "replicated"
    moe_gather: str = "bf16"                 # "bf16" | "int8": wire format of
                                             # the FSDP expert-weight gather

    def of(self, logical: Optional[str]):
        if logical is None:
            return None
        tp = self.model if self.tp_enabled else None
        vocab_m = self.model if self.vocab_mode == "tp" else None
        seq_in = None if self.tp_enabled else self.seq
        table = {
            "batch": self.batch,
            "vocab": vocab_m,
            "heads": tp,           # flattened n_heads*head_dim dim
            "kv_heads": tp,
            "ff": tp,
            "d_inner": tp,
            "experts": self.expert,
            "attn_q": self.model,   # context-parallel blocked attention
            "embed": self.fsdp,    # d_model dim of weights (ZeRO-3 slot)
            "seq": self.seq,
            # inside TP regions (projections/logits) the model axis is busy
            # with heads/ff/vocab: Megatron-SP gathers seq there. Without TP
            # the model axis is free for seq everywhere.
            "seq_inner": seq_in,
            # unembed: vocab sharding wins the model axis over seq sharding
            "seq_unembed": None if vocab_m else seq_in,
            "kv_seq": self.kv_seq,
            "model_dim_act": None,  # activations' d_model dim
        }
        return table.get(logical, None)

    def pspec(self, axes: Tuple[Optional[str], ...]) -> tuple:
        """The pspec of ``axes``; a one-name tuple becomes the name (as a
        JAX ``PartitionSpec`` normalises it)."""
        out = []
        for a in axes:
            m = self.of(a)
            out.append(m[0] if isinstance(m, tuple) and len(m) == 1 else m)
        return tuple(out)

    def pspec_for_shape(self, shape, axes, mesh) -> tuple:
        """Divisibility- and uniqueness-aware spec: drop mesh axes that do
        not divide the dim (batch=1 long-context cells) or that an earlier
        dim already claimed (e.g. vocab=model + 2D fsdp=(data, model))."""
        sizes = axis_sizes(mesh)
        out = []
        used = set()
        for dim, logical in zip(shape, axes):
            m = self.of(logical)
            if m is None:
                out.append(None)
                continue
            names = [n for n in ((m,) if isinstance(m, str) else tuple(m))
                     if n not in used]
            prod = 1
            for nm in names:
                prod *= sizes[nm]
            if not names or dim % prod != 0:
                out.append(None)
                continue
            used.update(names)
            out.append(names[0] if len(names) == 1 else tuple(names))
        return tuple(out)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of the pspec ``spec`` on ``mesh``: ``Shard(d)`` on
    each mesh dim that ``spec`` names for tensor dim ``d``, ``Replicate()``
    on the others. A dim sharded over several mesh axes must name them in
    mesh order (DTensor shards a dim over its mesh dims outer first, as the
    JAX ``("pod", "data")`` batch does); another order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(n) for n in group]
        if idx != sorted(idx):
            raise ValueError(f"pspec {spec}: dim {d} names mesh axes "
                             f"{group} out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape, pl, mesh) -> tuple:
    """One rank's shard shape of ``shape`` under the placements ``pl``
    (every sharded dim divisible, as ``pspec_for_shape`` makes it)."""
    from torch.distributed.tensor import Shard
    loc = list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            loc[p.dim] //= mesh.shape[i]
    return tuple(loc)


def local_block(full: torch.Tensor, pl, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under the placements ``pl``: each
    ``Shard(d)`` mesh dim, outer first, cuts dim d into as many equal
    parts as it has ranks and keeps the one at this rank's coordinate (a
    view)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    t = full
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            size = t.shape[p.dim] // mesh.shape[i]
            t = t.narrow(p.dim, coord[i] * size, size)
    return t


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


def zeros(s: PSpec, device, sh=None, like=None) -> torch.Tensor:
    """Zeros of the spec ``s`` on ``device``; where ``like`` is a DTensor
    and ``sh`` carries rules, a DTensor on ``like``'s mesh placed as the
    rules place ``s``, each rank allocating only its shard (as XLA
    allocates a sharded array): a decode state made inside a step."""
    rules = getattr(sh, "rules", None)
    if rules is None or like is None or type(like) in (torch.Tensor,
                                                        torch.nn.Parameter):
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    from torch.distributed.tensor import DTensor
    mesh = like.device_mesh
    pl = placements(rules.pspec_for_shape(s.shape, s.axes, mesh), mesh)
    local = torch.zeros(local_shape(s.shape, pl, mesh), dtype=s.dtype,
                        device=device)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(s.shape),
                              stride=contiguous_stride(s.shape))


def shard_mesh_dim(t, dim: int):
    """The mesh dim that shards DTensor ``t``'s dim ``dim``, where exactly
    one does; else None."""
    from torch.distributed.tensor import Shard
    found = [i for i, p in enumerate(t.placements)
             if isinstance(p, Shard) and p.dim == dim % t.dim()]
    return found[0] if len(found) == 1 else None


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (computed: a meta
    tensor would count its bytes in a memory tracker)."""
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def param_count(specs) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_leaves(specs))


def sds_tree(specs):
    """Fake tensors of the specs' shapes and dtypes, made under a new
    ``FakeTensorMode``: stand-ins that allocate nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype),
                        specs)


def pspec_tree(specs, rules: ShardingRules):
    """The rules' pspec of every leaf (divisibility not checked)."""
    return tree_map(lambda s: rules.pspec(s.axes), specs)


def sharding_tree(specs, rules: ShardingRules, mesh):
    """The DTensor placements of every leaf on ``mesh``: the
    divisibility-aware ``pspec_for_shape``, through ``placements``."""
    return tree_map(lambda s: placements(
        rules.pspec_for_shape(s.shape, s.axes, mesh), mesh), specs)


def no_sharding(x, *axes):
    """The identity sharding hook (``sh=None`` in the model code)."""
    return x


@contextlib.contextmanager
def mesh_scope(sh):
    """The context a step runs in under the sharding hook ``sh``: where it
    carries rules, a plain tensor that meets a DTensor (positions, masks,
    constants: the same on every rank) counts as replicated, as a JAX
    constant does under ``jit`` (DTensor's ``implicit_replication``,
    restored on exit so that scopes nest); and on a CUDA mesh over gloo,
    DTensor's collectives go through host buffers (``staged_collectives``).
    Else nothing."""
    if getattr(sh, "rules", None) is None:
        yield
        return
    from torch.distributed.tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    was = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        with staged_collectives(getattr(sh, "mesh", None)):
            yield
    finally:
        dispatcher._allow_implicit_replication = was


def _gloo_cuda(mesh) -> bool:
    import torch.distributed as dist
    return (mesh is not None and mesh.device_type == "cuda"
            and str(dist.get_backend(mesh.get_group(0))) == "gloo")


def staged_collectives(mesh):
    """On a CUDA ``mesh`` whose groups are gloo's (ranks that share one
    card), ``HostStaged()``, unless one is on already; a null context on
    any other mesh."""
    if not _gloo_cuda(mesh) or any(isinstance(m, HostStaged) for m in
                                   _get_current_dispatch_mode_stack()):
        return contextlib.nullcontext()
    return HostStaged()


class HostStaged(TorchDispatchMode):
    """Each of DTensor's collectives (the ``_c10d_functional`` ops) on
    CUDA operands runs on pinned host copies of them, and its result is
    copied back: gloo moves host tensors (its CUDA all-gather crashes), as
    ``db.spmd.exchange_route`` stages the mesh steps' exchange. DTensor
    ops pass to DTensor, which runs its collectives on the local tensors
    under this mode."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        cuda = [t for t in pytree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor) and t.is_cuda]
        wait = torch.ops._c10d_functional.wait_tensor
        if func.namespace != "_c10d_functional" or not cuda or \
                func.overloadpacket is wait:
            return func(*args, **kwargs)

        def host(t):
            if not t.is_cuda:
                return t
            return torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=True).copy_(t)

        h_args, h_kwargs = tree_map_only(torch.Tensor, host, (args, kwargs))
        out = tree_map_only(torch.Tensor, wait, func(*h_args, **h_kwargs))
        if func.overloadpacket.__name__.endswith("_"):  # in place
            for t, h in zip(pytree_leaves((args, kwargs)),
                            pytree_leaves((h_args, h_kwargs))):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.copy_(h)
            return args[0]
        return tree_map_only(torch.Tensor, lambda t: t.to(cuda[0].device),
                             out)


class _Constrain(torch.autograd.Function):
    """``x`` redistributed to ``pl``, and its gradient too: the transpose of
    JAX's ``with_sharding_constraint`` constrains the cotangent as the
    value. (DTensor's own backward of a redistribution goes back to the
    source placement, so a gradient of a sum over the model axis would
    stay ``Partial`` through the backward, and each matmul it meets would
    replicate its weight on that axis rather than reduce the gradient.)"""

    @staticmethod
    def forward(ctx, x, mesh, pl):
        ctx.args = (mesh, pl)
        return x.redistribute(mesh, pl)

    @staticmethod
    def backward(ctx, g):
        mesh, pl = ctx.args
        return g.redistribute(mesh, pl), None, None


def make_sharder(rules: Optional[ShardingRules], mesh=None):
    """Activation-sharding hook threaded through the model code.

    ``sh(x, "batch", None, "heads")`` redistributes a DTensor ``x`` (and,
    in the backward, its gradient) to the placements the rules give its
    shape on ``mesh`` (the DTensor's own mesh when None) and returns a
    plain tensor as it is; with ``rules`` None it
    is the identity. It carries ``.rules`` and ``.mesh`` (the MoE layer's
    expert-parallel path and ``sharded_attention`` read them) and
    ``.fallbacks``, {op name: calls} of the attention that ran replicated
    on an axis for want of a placement (a dry run reports them)."""
    if rules is None:
        return no_sharding

    def sh(x, *axes):
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        m = mesh if mesh is not None else x.device_mesh
        spec = rules.pspec_for_shape(x.shape, axes, m)
        return _Constrain.apply(x, m, placements(spec, m))

    sh.rules = rules
    sh.mesh = mesh
    sh.fallbacks = {}
    return sh

