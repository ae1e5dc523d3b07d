"""Mixture-of-Experts layer: top-k router + sort-based scatter dispatch (the
JAX package's ``models/moe.py``).

Tokens are flat-sorted by expert id, positioned within their expert by rank
arithmetic, and scattered into a dense [E, C, d] buffer; overflow beyond the
capacity C = ceil8(T * k / E * capacity_factor + 1) is dropped (the aux
loss tracks the balance). The experts are batched matrix products outside
any hand kernel.

Two paths, chosen as the JAX package chooses them: the local path, and
with a sharding hook that carries rules and a mesh, the expert-parallel
``apply_moe_spmd``: tokens stay on their (data x sequence) shard, the
dispatch sort is local, and only the dense [E, C, d] buffers cross the
expert axis, one ``all_to_all_single`` each way; ``gather_w_int8`` is its
FSDP expert-weight gather with an int8 wire format.

Three choices keep the port's routing and sums the JAX package's: the top
k is the first k of a stable descending sort (on ties the lower expert
first, as ``lax.top_k``), the dispatch sort is stable, and a token's
contributions are added in ascending expert order in the activation dtype
(XLA's scatter-add order on the CPU; ``index_add_`` is atomic on the card,
its order unspecified)."""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import layers
from .config import ModelConfig
from .spec import (PSpec, axis_sizes, contiguous_stride, local_block,
                   local_shape, no_sharding, placements)


def moe_specs(cfg: ModelConfig, L=()) -> Dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.dtype
    lax_ = (None,) * len(L)
    up = lax_ + ("experts", "embed", None)
    specs = {
        "router": PSpec(L + (d, e), torch.float32, axes=lax_ + ("embed", None)),
        "w_gate": PSpec(L + (e, d, f), dt, axes=up),
        "w_up": PSpec(L + (e, d, f), dt, axes=up),
        "w_down": PSpec(L + (e, f, d), dt,
                        axes=lax_ + ("experts", None, "embed")),
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
    starts = _expert_starts(se, e)
    pos_in_e = torch.arange(t * k, device=dev) - starts[se]
    cap = capacity(cfg, t)
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e,
                       torch.full_like(se, e * cap))
    return Routing(probs, eidx, order, stok, sgate, slot, keep, cap)


def _expert_starts(se: torch.Tensor, e: int) -> torch.Tensor:
    """The first dispatch position of each of the ``e`` experts in the
    sorted expert ids ``se``: ``searchsorted``'s integers. DTensor has no
    sharding rule for ``searchsorted`` (XLA replicates it), so on a
    DTensor they are counted: the ids below each expert."""
    ids = torch.arange(e, device=se.device)
    if not _is_dtensor(se):
        return torch.searchsorted(se, ids)
    return (se[None, :] < ids[:, None]).sum(1)


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


def apply_moe(cfg: ModelConfig, p, x: torch.Tensor, sh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y [B, S, D], aux loss, 0-d float32). With a hook
    ``sh`` that carries rules and a mesh, and a sequence that the expert
    axis divides (so not a decode step), the expert-parallel path."""
    rules = getattr(sh, "rules", None)
    mesh = getattr(sh, "mesh", None)
    if (rules is not None and mesh is not None and x.shape[1] > 1
            and x.shape[1] % axis_sizes(mesh)[rules.model] == 0):
        return apply_moe_spmd(cfg, p, x, sh, rules, mesh)
    return _apply_moe_local(cfg, p, x, sh or no_sharding)


def _apply_moe_local(cfg: ModelConfig, p, x: torch.Tensor, sh
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The local routing. On DTensors (a decode step on a mesh) the
    dispatch and the combine move rows by index vectors on each rank's
    own tensors: the tokens and the routing whole (a step's few tokens),
    each rank's experts' rows of the buffers (``_dispatch_on_ranks``,
    ``_combine_on_ranks``). DTensor's rules for ``index_copy`` differ
    between versions (torch 2.11 pairs a whole index with a sharded
    source, and fails)."""
    b, s, d = x.shape
    e = cfg.n_experts
    xt = x.reshape(b * s, d)
    r = route(cfg, p["router"], xt)
    cap = r.cap
    rw = Routing(*(_whole(t) for t in r[:-1]), cap)

    # dispatch: row e * cap takes every dropped pair and is cut off (JAX's
    # scatter with mode="drop")
    if _is_dtensor(xt):
        buf = _dispatch_on_ranks(_whole(xt), rw, e, sh)
    else:
        buf = xt.new_zeros(e * cap + 1, d).index_copy(0, r.slot, xt[r.stok])
        buf = buf[:e * cap].reshape(e, cap, d)
    buf = sh(buf, "experts", None, None)

    # expert FFN (swiglu)
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    h = sh(F.silu(g) * u, "experts", None, None)
    out = sh(torch.bmm(h, p["w_down"]), "experts", None, None)
    if _is_dtensor(out):
        y = _combine_on_ranks(rw, out, x.dtype, xt)
    else:
        y = combine(rw, out.reshape(e * cap, d), x.dtype)
    y = sh(y.reshape(b, s, d), "batch", "seq", "model_dim_act")

    if cfg.n_shared_experts:
        y = y + layers.apply_mlp(_shared_cfg(cfg), p["shared"], x, sh)

    # load-balance aux loss (Switch-style)
    me = rw.probs.mean(0)
    ce = F.one_hot(rw.eidx, e).float().sum(1).mean(0)
    aux = e * torch.sum(me * ce)
    return y, _replicated(aux, x)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value, the same on every rank; else ``t``."""
    return t.full_tensor() if _is_dtensor(t) else t


def _replicated(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (the same on every rank) as a DTensor replicated on the mesh
    of ``like`` where that is a DTensor; else ``t``."""
    from torch.distributed.tensor import DTensor, Replicate
    if not _is_dtensor(like):
        return t
    return DTensor.from_local(t, like.device_mesh,
                              [Replicate()] * like.device_mesh.ndim,
                              run_check=False)


def _dispatch_on_ranks(x: torch.Tensor, r: Routing, e: int, sh
                       ) -> torch.Tensor:
    """The dispatch buffer [E, cap, d] of the whole tokens ``x`` [T, d]
    by the whole routing ``r``, as a DTensor placed on its experts as
    ``sh``'s rules place it: each rank fills its own experts' rows (the
    others' pairs go to the cut-off row)."""
    from torch.distributed.tensor import DTensor
    mesh, cap, d = sh.mesh, r.cap, x.shape[1]
    shape = (e, cap, d)
    pe = placements(sh.rules.pspec_for_shape(shape, ("experts", None, None),
                                             mesh), mesh)
    n = local_shape(shape, pe, mesh)[0]
    slot = r.slot - _block_start(pe, mesh) * n * cap
    mine = r.keep & (slot >= 0) & (slot < n * cap)
    buf = x.new_zeros(n * cap + 1, d).index_copy(
        0, torch.where(mine, slot, n * cap), x[r.stok])
    return DTensor.from_local(buf[:n * cap].reshape(n, cap, d), mesh, pe,
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def _combine_on_ranks(r: Routing, out: torch.Tensor, dtype: torch.dtype,
                      like: torch.Tensor) -> torch.Tensor:
    """``combine`` of the DTensor ``out`` [E, cap, d] placed on its
    experts, ``r`` whole, for this rank's block of the tokens as ``like``
    [T, d] places them: the rank combines the pairs whose rows its experts
    hold (the others count as dropped), and the ranks' sums are added, a
    ``Partial`` over the mesh dims that split the experts (XLA's gather
    from a sharded operand). [T, d]."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = out.device_mesh

    def rows(q):
        return isinstance(q, Shard) and q.dim == 0

    pe = [q if rows(q) else Replicate() for q in out.placements]
    ol = out.redistribute(mesh, pe).to_local()
    n, cap, d = ol.shape
    lp = like.placements if _is_dtensor(like) else [Replicate()] * len(pe)
    pt = [q if rows(q) and not rows(e) else Replicate()
          for q, e in zip(lp, pe)]
    t, k = r.eidx.shape
    tn = t
    for i, q in enumerate(pt):
        tn //= mesh.shape[i] if rows(q) else 1
    t0 = _block_start(pt, mesh) * tn
    # this block's pairs in (token, choice) order, the rows here kept
    pick = torch.argsort(r.order)[t0 * k:(t0 + tn) * k]
    slot = r.slot[pick] - _block_start(pe, mesh) * n * cap
    mine = r.keep[pick] & (slot >= 0) & (slot < n * cap)
    blk = Routing(r.probs[t0:t0 + tn], r.eidx[t0:t0 + tn],
                  torch.arange(tn * k, device=slot.device), r.stok[pick],
                  r.sgate[pick], torch.where(mine, slot, 0), mine, r.cap)
    y = combine(blk, ol.reshape(n * cap, d), dtype)
    return DTensor.from_local(
        y, mesh, [Partial() if rows(e) else q for q, e in zip(pt, pe)],
        run_check=False, shape=torch.Size((t, d)),
        stride=contiguous_stride((t, d)))


def _block_start(pl, mesh) -> int:
    """The index of this rank's block along dim 0 under the placements
    ``pl`` (even splits, the outer mesh dim first, as ``local_block``)."""
    from torch.distributed.tensor import Shard
    b = 0
    for i, q in enumerate(pl):
        if isinstance(q, Shard) and q.dim == 0:
            b = b * mesh.shape[i] + mesh.get_coordinate()[i]
    return b


# ------------------------------------------------------ expert parallelism
def _staged(group, t: torch.Tensor) -> bool:
    """gloo moves host tensors: a CUDA tensor on a gloo group goes through
    pinned host buffers (as ``db.spmd.exchange_route`` decides)."""
    return t.device.type == "cuda" and str(dist.get_backend(group)) == "gloo"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor moves as its bytes (a data move needs no bf16 support
    from the backend; gloo has no 16-bit integers)."""
    return t.view(torch.uint8) if t.dtype == torch.bfloat16 else t


def _collective(op, out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """``op(out, inp, group=group)``, through pinned host buffers when the
    group cannot take ``inp``'s device."""
    if not _staged(group, inp):
        op(out, inp, group=group)
        return
    host_in = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True)
    host_in.copy_(inp)
    host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    op(host_out, host_in, group=group)
    out.copy_(host_out)


def _all_to_all_1d(x, send, recv, group):
    """``x`` (1-D) cut into ``send[s]`` elements for rank s of ``group``;
    the pieces received, ``recv[s]`` from rank s, side by side. Moved as
    bytes (gloo has no bf16)."""
    out = x.new_empty(sum(recv))
    k = x.element_size()
    op = functools.partial(dist.all_to_all_single,
                           output_split_sizes=[c * k for c in recv],
                           input_split_sizes=[c * k for c in send])
    _collective(op, out.view(torch.uint8), x.view(torch.uint8), group)
    return out


class _AllToAll1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send, recv, group):
        ctx.args = (send, recv, group)
        return _all_to_all_1d(x, send, recv, group)

    @staticmethod
    def backward(ctx, g):
        send, recv, group = ctx.args
        return _all_to_all_1d(g.contiguous(), recv, send, group), None, \
            None, None


def exchange(pieces, shapes, group, dim: int) -> torch.Tensor:
    """One all-to-all over ``group`` (differentiable: the backward is the
    reverse exchange): ``pieces[s]`` goes to rank s, and what rank s sends
    here arrives in ``shapes[s]``; returns those, concatenated along
    ``dim`` from rank 0 up. Pieces and shapes may differ from rank to
    rank (an uneven split)."""
    send = [p.numel() for p in pieces]
    recv = [math.prod(s) for s in shapes]
    got = _AllToAll1d.apply(torch.cat([p.reshape(-1) for p in pieces]),
                            send, recv, group)
    return torch.cat([t.view(s) for t, s in zip(got.split(recv), shapes)],
                     dim)


def _all_gather(t: torch.Tensor, group, axis: int) -> torch.Tensor:
    """The group's shards of ``t`` side by side along ``axis`` in rank
    order (``all_gather(..., tiled=True)``)."""
    n = group.size()
    src = t.movedim(axis, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _collective(dist.all_gather_into_tensor, _wire(out), _wire(src), group)
    return out.movedim(0, axis)


class _GatherReplicated(torch.autograd.Function):
    """Forward: the shards gathered along ``axis``, the same on every rank
    of the group. Each rank then goes on with the same replicated value,
    and so gets the same gradient of it, whose slice is the gradient of
    its own shard: no exchange."""

    @staticmethod
    def forward(ctx, t, group, axis, index):
        ctx.args = (axis, index, t.shape[axis])
        return _all_gather(t, group, axis)

    @staticmethod
    def backward(ctx, g):
        axis, index, n = ctx.args
        return g.narrow(axis, index * n, n), None, None, None


def _all_reduce(t: torch.Tensor, groups) -> torch.Tensor:
    """A copy of ``t`` summed over the ranks of ``groups`` (in turn)."""
    out = t.detach().clone()
    for group in groups:
        if _staged(group, out):
            host = out.cpu()
            dist.all_reduce(host, group=group)
            out.copy_(host)
        else:
            dist.all_reduce(out, group=group)
    return out


class _MeanReplicated(torch.autograd.Function):
    """The mean of a value over the ranks of ``groups``, the same on every
    rank; the gradient of each rank's value is 1 / n of the mean's."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.n = 1
        for group in groups:
            ctx.n *= group.size()
        return _all_reduce(t, groups) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _int8_codes(w: torch.Tensor, axis: int):
    """int8 codes and float32 scales of ``w`` per slice along ``axis``:
    scale = max|w| / 127 + 1e-12, code = clip(round(w / scale), -127, 127)
    (``torch.round`` rounds half to even, as ``jnp.round`` does)."""
    wf = w.float()
    scale = wf.abs().amax(dim=axis, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, s: torch.Tensor, axis: int,
                dtype) -> torch.Tensor:
    """Codes ``q`` of n slices along ``axis`` times their scales ``s`` (n
    along ``axis``), cast to ``dtype``."""
    n = s.shape[axis]
    shape = q.shape
    qr = q.reshape(shape[:axis] + (n, shape[axis] // n) + shape[axis + 1:])
    return (qr.float() * s.unsqueeze(axis + 1)).reshape(shape).to(dtype)


class _GatherWInt8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_local, group, gather_axis):
        ctx.args = (group, gather_axis)
        q, scale = _int8_codes(w_local, gather_axis)
        qg = _all_gather(q, group, gather_axis)
        sg = _all_gather(scale, group, gather_axis)
        return _dequantize(qg, sg, gather_axis, w_local.dtype)

    @staticmethod
    def backward(ctx, g):
        # the transpose of the gather: a reduce-scatter, in the gradient's
        # own dtype
        group, axis = ctx.args
        src = g.movedim(axis, 0).contiguous()
        out = src.new_empty((src.shape[0] // group.size(),)
                            + tuple(src.shape[1:]))
        _collective(dist.reduce_scatter_tensor, out, src, group)
        return out.movedim(0, axis), None, None


def gather_w_int8(w_local: torch.Tensor, group, gather_axis: int
                  ) -> torch.Tensor:
    """FSDP weight gather with an int8 wire format (+ per-slice float32
    scales) over the process group ``group``: the shards gathered along
    ``gather_axis`` in rank order, each dequantised from its own codes.

    Halves the dominant collective term of giant-MoE training (the expert
    weight gathers) at the cost of int8-quantized weights in the forward
    and recompute passes. The backward is exact: the gradient's
    reduce-scatter (the transpose of the gather) stays in its dtype."""
    return _GatherWInt8.apply(w_local, group, gather_axis)


def gather_w_int8_ref(shards, gather_axis: int) -> torch.Tensor:
    """Plain version of ``gather_w_int8`` given every rank's shard (in rank
    order): each quantised, the codes and scales concatenated, then
    dequantised."""
    codes = [_int8_codes(w, gather_axis) for w in shards]
    q = torch.cat([c[0] for c in codes], dim=gather_axis)
    s = torch.cat([c[1] for c in codes], dim=gather_axis)
    return _dequantize(q, s, gather_axis, shards[0].dtype)


class _SumGrads(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the ranks of
    ``groups``."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.groups), None


class _Local:
    """This rank's block of a tensor under a pspec on ``mesh``, and back
    (``shard_map``'s in and out specs, for x's spec ``x_spec``).

    The tokens differ across the mesh dims that ``x_spec`` names, so the
    gradient of a block that is replicated over one of those dims is this
    rank's part of a sum over it; over the other dims every rank computes
    the same thing. A DTensor is redistributed to the spec and its local
    tensor taken, its gradient marked ``Partial`` on the former dims (the
    sum that JAX's ``shard_map`` transpose adds). A plain tensor (the full
    value, the same on every rank) is sliced at the rank's coordinate, its
    gradient summed over the former dims and over the dims it is sliced
    on, so that every rank holds the whole gradient as it does of the
    replicated rest of the model; a result is gathered back to the full
    value on every rank."""

    def __init__(self, mesh, x_spec):
        from torch.distributed.tensor import Shard
        self.mesh = mesh
        self.names = list(mesh.mesh_dim_names)
        self.coord = dict(zip(self.names, mesh.get_coordinate()))
        self.sizes = axis_sizes(mesh)
        self.data_dims = {i for i, q in enumerate(placements(x_spec, mesh))
                          if isinstance(q, Shard)}

    @staticmethod
    def _axes(entry):
        if entry is None:
            return ()
        return (entry,) if isinstance(entry, str) else tuple(entry)

    def enter(self, t: torch.Tensor, spec) -> torch.Tensor:
        from torch.distributed.tensor import DTensor, Partial, Shard
        pl = placements(spec, self.mesh)
        if isinstance(t, DTensor):
            grad = [q if isinstance(q, Shard) or i not in self.data_dims
                    else Partial() for i, q in enumerate(pl)]
            return t.redistribute(self.mesh, pl).to_local(
                grad_placements=grad)
        groups = [self.mesh.get_group(n) for i, n in enumerate(self.names)
                  if self.mesh.shape[i] > 1
                  and (isinstance(pl[i], Shard) or i in self.data_dims)]
        if groups and t.requires_grad:
            t = _SumGrads.apply(t, groups)
        return local_block(t, pl, self.mesh)

    def leave(self, t: torch.Tensor, spec, like: torch.Tensor):
        from torch.distributed.tensor import DTensor
        if isinstance(like, DTensor):
            return DTensor.from_local(t, self.mesh,
                                      placements(spec, self.mesh),
                                      run_check=False, shape=like.shape,
                                      stride=like.stride())
        for d, entry in enumerate(spec):
            for name in reversed(self._axes(entry)):  # the inner axis first
                if self.sizes[name] > 1:
                    t = _GatherReplicated.apply(
                        t, self.mesh.get_group(name), d, self.coord[name])
        return t


def apply_moe_spmd(cfg: ModelConfig, p, x: torch.Tensor, sh, rules, mesh
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism the way real MoE frameworks run it (JAX
    ``_apply_moe_spmd``): tokens stay local to their (data x sequence)
    shard, the dispatch is a local sort, and only the dense [E, C, d]
    buffers cross the expert axis, by ``all_to_all_single``.

    Per rank: x [b/|batch|, s/|model|, d]; w_gate / w_up / w_down
    [E/|model|, ...] (the expert weights; with ``moe_gather="int8"`` also
    fsdp-sharded on d_model and gathered by ``gather_w_int8``);
    buf [E, C_loc, d] --all_to_all--> [E/|model|, |model| * C_loc, d].
    ``x`` and the parameters are DTensors (a dry run) or the full values,
    the same on every rank (then y and the gradients come back whole on
    every rank). The aux loss is averaged over every mesh axis."""
    sizes = axis_sizes(mesh)
    ep = rules.model
    batch = tuple(rules.batch)
    e = cfg.n_experts
    f_ax = rules.fsdp
    use_int8 = (rules.moe_gather == "int8" and f_ax is not None
                and cfg.d_model % sizes[f_ax] == 0)
    if use_int8:  # weights enter still fsdp-sharded
        w_specs = ((ep, f_ax, None), (ep, f_ax, None), (ep, None, f_ax))
    else:         # the fsdp dim gathered (in the weights' dtype) on entry
        w_specs = ((ep, None, None),) * 3
    x_spec = (batch, ep, None)
    loc = _Local(mesh, x_spec)
    xl = loc.enter(x, x_spec)
    router = loc.enter(p["router"], (None, None))
    wg, wu, wd = (loc.enter(p[k], s) for k, s in
                  zip(("w_gate", "w_up", "w_down"), w_specs))
    if use_int8:
        fsdp = mesh.get_group(f_ax)
        wg = gather_w_int8(wg, fsdp, 1)
        wu = gather_w_int8(wu, fsdp, 1)
        wd = gather_w_int8(wd, fsdp, 2)
    ep_group = mesh.get_group(ep)

    b_l, s_l, d = xl.shape
    xt = xl.reshape(b_l * s_l, d)
    r = route(cfg, router, xt)  # the local sort, at capacity(cfg, t_local)
    cap = r.cap
    buf = xt.new_zeros(e * cap + 1, d).index_copy(0, r.slot, xt[r.stok])
    # the exchange: experts to their owning rank, tokens from every rank
    n_ep = ep_group.size()
    buf = exchange(list(buf[:e * cap].reshape(e, cap, d).chunk(n_ep, 0)),
                   [(e // n_ep, cap, d)] * n_ep, ep_group, 1)
    g = torch.bmm(buf, wg)
    u = torch.bmm(buf, wu)
    out = torch.bmm(F.silu(g) * u, wd)
    out = exchange(list(out.chunk(n_ep, 1)), [(e // n_ep, cap, d)] * n_ep,
                   ep_group, 0).reshape(e * cap, d)
    y = combine(r, out, xl.dtype).reshape(b_l, s_l, d)

    me = r.probs.mean(0)
    ce = F.one_hot(r.eidx, e).float().sum(1).mean(0)
    aux = _MeanReplicated.apply(e * torch.sum(me * ce),
                                [mesh.get_group(a) for a in batch + (ep,)])
    y = sh(loc.leave(y, x_spec, x), "batch", "seq", "model_dim_act")
    if cfg.n_shared_experts:
        y = y + layers.apply_mlp(_shared_cfg(cfg), p["shared"], x, sh)
    return y, _replicated(aux, x)
