"""Op-level cost counter: the counterpart of the JAX package's
``launch/hlo_cost.py``, named for what it reads (PyTorch has no HLO).

``OpCost`` is a ``TorchDispatchMode`` that sees every aten and collective
op one rank runs and adds up the JAX ``Cost`` fields, per device:

  flops        — the ``torch.utils.flop_counter`` formulas: 2·M·N·K per
                 mm / bmm / addmm / baddbmm, the convolution and SDPA
                 formulas; the hand attention op
                 (``repro_torch.flash_attention``, #7) by its causal
                 triangle (``kernels.flash_attention.attention_cost``; its
                 backward is plain ops, counted as they run); elementwise
                 flops are left out, as in the JAX counter (the memory
                 term carries them).
  bytes        — operands plus outputs of every op that touches memory:
                 in eager PyTorch every op meets HBM. Views, allocations
                 and metadata ops move nothing.
  bytes_ideal  — the perfect-fusion count: only matmuls, gathers and
                 scatters (the rows they touch: twice the gathered or
                 scattered bytes) and collectives (twice the payload).
  link_bytes, coll_counts, coll_link — the ring cost of each
                 collective over its group (``analysis``), ``c10d`` (the
                 ``torch.distributed`` calls) and ``_c10d_functional``
                 (DTensor's redistributions) alike.

A DTensor op is left to DTensor (the mode returns ``NotImplemented``), so
the counter sees the local ops on each rank's shards: per-device counts.
DTensor's sharding propagation runs each new op once more on fake tensors
of the global shape to learn the output's metadata; those runs compute
nothing on the device. While an ``OpCost`` is entered they run with the
dispatch modes set aside, so neither it nor a memory tracker inside it
counts them.

No trip counts are needed (the JAX counter multiplies loop bodies by
theirs): eager runs every iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels.flash_attention import attention_cost

_aten = torch.ops.aten

# rows touched: a gather moves its output twice (read + write)
_GATHERS = {_aten.index, _aten.index_select, _aten.gather, _aten.embedding,
            _aten.take_along_dim}
# a scatter moves its updates twice
_SCATTERS = {_aten.index_put, _aten.index_put_, _aten._index_put_impl_,
             _aten.scatter, _aten.scatter_, _aten.scatter_add,
             _aten.scatter_add_, _aten.scatter_reduce, _aten.scatter_reduce_,
             _aten.index_add, _aten.index_add_, _aten.index_copy,
             _aten.index_copy_, _aten.slice_scatter, _aten.select_scatter}
# ops that move no bytes: allocations without a fill, metadata
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.new_empty, _aten.new_empty_strided, _aten.detach,
         _aten.lift_fresh, _aten._local_scalar_dense, _aten.sym_size,
         _aten.sym_stride, _aten.sym_numel, _aten.sym_storage_offset}

# collective op name -> the JAX kind
_COLLECTIVES = {
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "allreduce_coalesced_"): "all-reduce",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "allgather_into_tensor_coalesced_"): "all-gather",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "reduce_scatter_tensor_coalesced_"): "reduce-scatter",
    ("c10d", "alltoall_"): "all-to-all",
    ("c10d", "alltoall_base_"): "all-to-all",
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_out"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0        # upper bound: every op meets HBM
    bytes_ideal: float = 0.0  # lower bound: perfect fusion — matmul, gather,
                              # scatter and collective traffic only
    link_bytes: float = 0.0
    coll_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    coll_link: Dict[str, float] = dataclasses.field(default_factory=dict)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def ring_traffic(kind: str, s: float, n: int) -> float:
    """Per-device link bytes of one collective of payload ``s`` (its
    output on this device) over ``n`` ranks, by the ring model."""
    if kind == "all-reduce":
        return 2.0 * s * (n - 1) / n
    if kind in ("all-gather", "all-to-all"):
        return s * (n - 1) / n
    if kind == "reduce-scatter":
        return s * (n - 1)
    return float(s)  # collective-permute


def _group_size(args) -> int:
    for a in tree_leaves(args):
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        if isinstance(a, torch.ScriptObject):  # a c10d op's boxed group
            return dist.ProcessGroup.unbox(a).size()
    for a in reversed(tree_leaves(args)):
        if isinstance(a, str):  # a functional collective's group name
            return dist.distributed_c10d._resolve_process_group(a).size()
    return 1


class OpCost(TorchDispatchMode):
    """``with OpCost() as c: step()`` counts ``c.cost`` (a ``Cost``) of the
    ops this rank runs in ``step``; ``c.by_op`` keeps the flops and bytes
    of each aten op."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.by_op: Dict[str, list] = {}
        self._prop = None

    # DTensor's metadata runs happen inside this method of its sharding
    # propagator: they run with no mode on the stack (and so on fake
    # tensors of a fresh ``FakeTensorMode``)
    def __enter__(self):
        from torch.distributed.tensor import DTensor
        prop = DTensor._op_dispatcher.sharding_propagator
        orig = prop._propagate_tensor_meta_non_cached

        def metadata_only(*a, **kw):
            with _disable_current_modes():
                return orig(*a, **kw)

        prop._propagate_tensor_meta_non_cached = metadata_only
        self._prop = prop
        return super().__enter__()

    def __exit__(self, *exc):
        if self._prop is not None:
            del self._prop._propagate_tensor_meta_non_cached
            self._prop = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        c = self.cost
        packet = func.overloadpacket
        kind = _COLLECTIVES.get((func.namespace, packet.__name__))
        if kind is not None:
            # c10d ops write into their first argument, functional ones
            # return their result
            s = _nbytes(args[0] if func.namespace == "c10d" else out)
            n = _group_size((args, kwargs))
            if n > 1:
                traffic = ring_traffic(kind, s, n)
                c.link_bytes += traffic
                c.coll_counts[kind] = c.coll_counts.get(kind, 0) + 1
                c.coll_link[kind] = c.coll_link.get(kind, 0.0) + traffic
            c.bytes += 2.0 * s
            c.bytes_ideal += 2.0 * s
            return
        if func.namespace == "repro_torch":  # #7: one launch, by formula
            q, k, _, causal, q_offset, return_lse = args[:6]
            moved, flops = attention_cost(q.shape, k.shape, causal, q_offset,
                                          q.element_size(), return_lse)
            c.bytes_ideal += moved
        elif func.namespace != "aten" or packet in _FREE or func.is_view:
            return
        else:
            moved, flops = self._aten_cost(packet, args, kwargs, out)
        c.flops += flops
        c.bytes += moved
        rec = self.by_op.setdefault(str(packet), [0, 0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += moved

    def _aten_cost(self, packet, args, kwargs, out):
        """(bytes, flops) of one aten op; adds its ideal bytes."""
        c = self.cost
        moved = _nbytes((args, kwargs)) + _nbytes(out)
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            c.bytes_ideal += moved
        elif packet in _GATHERS:
            c.bytes_ideal += 2.0 * _nbytes(out)
        elif packet in _SCATTERS:
            c.bytes_ideal += 2.0 * _nbytes(args[1:])
        return moved, flops
