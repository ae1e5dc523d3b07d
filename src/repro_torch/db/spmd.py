"""SPMD ingest over a process mesh — the distributed BatchWriter, on
``torch.distributed``.

The paper runs k SPMD ingest processes against Accumulo tablet servers.
Here every rank along the mesh axis is at once an ingestor (it brings its
own triple batch) and a tablet server (it owns a key range). One step =

  1. each rank buckets its batch by owner (range pre-split, or a tablet
     map's routing arrays),
  2. one ``all_to_all_single`` exchanges the buckets (BatchWriter ->
     tablet routing); rank s's rows arrive in source-rank order,
  3. each rank merges what it received into its tablet (``tablet_insert``)
     or sorts, dedups and appends it to its L0 stack as one run.

One process per rank. A step builder takes ``(mesh, axis, ...)``: ``mesh``
is a ``torch.distributed.device_mesh.DeviceMesh`` (``make_mesh`` builds
the 1-D one) and ``axis`` one of its ``mesh_dim_names``. The step it
returns is a function of THIS rank's state and batch, with the shapes one
shard of the JAX package's stacked state has: a ``Tablet`` of ``[cap]``
with a 0-d ``n``, an ``L0Stack`` of ``[slots, run_cap]`` with a 0-d ``k``,
a batch of ``[bcap]``. Tensors stay on the device the state lives on.
``from_jax_stacked`` / ``to_stacked_numpy`` convert between one rank's
state and the JAX step's stacked numpy form.

The exchange runs on the mesh axis's process group, whose backend the
caller chose: NCCL when each rank has its own card, gloo otherwise. gloo
with CUDA tensors stages both sides of the exchange through pinned host
buffers (``exchange_route`` says which route a group and device take).
"""
from __future__ import annotations

import dataclasses
import logging
from time import perf_counter
from typing import Mapping, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.common import I32_MAX, resolve_device
from ..kernels.merge_rank import kway_merge
from ..kernels.merge_rank.ref import pair_key
from ..obs import default_registry, merge_snapshots
from .kvstore import Tablet, _dedup_combine, tablet_empty, tablet_insert
from .lsm.engine import _compact

_log = logging.getLogger(__name__)
_routes_logged: set = set()


# --------------------------------------------------------------- the mesh
def make_mesh(axis: str = "data"):
    """A 1-D ``DeviceMesh`` named ``axis`` over the initialised world. Its
    device type follows the default group's backend: ``"cuda"`` under
    NCCL, ``"cpu"`` under gloo (gloo ranks may share one card; their
    tensors stay where the caller puts them)."""
    from torch.distributed.device_mesh import DeviceMesh
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, list(range(dist.get_world_size())),
                      mesh_dim_names=(axis,))


def _axis_group(mesh, axis: str, num_shards: int = None):
    group = mesh.get_group(axis)
    size = dist.get_world_size(group)
    if num_shards is not None and size != num_shards:
        raise ValueError(f"mesh axis {axis!r} has {size} ranks, "
                         f"num_shards={num_shards}")
    return group


def exchange_route(group, device: torch.device) -> dict:
    """How the exchange of ``device`` tensors runs on ``group``:
    ``{"backend": ..., "staged": bool}``. NCCL exchanges CUDA tensors in
    place; gloo exchanges host tensors, so CUDA tensors are staged through
    pinned host buffers. Decided from the backend and the device alone,
    and logged once per route."""
    backend = str(dist.get_backend(group))
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL mesh exchanges CUDA tensors only, got "
                         f"{device}")
    route = {"backend": backend,
             "staged": backend == "gloo" and device.type == "cuda"}
    key = (backend, device.type)
    if key not in _routes_logged:
        _routes_logged.add(key)
        _log.info("spmd exchange: backend %s, %s tensors, host-staged %s",
                  backend, device.type, route["staged"])
    return route


def _exchange(group, sends):
    """Every exchange of the mesh steps. ``sends`` are ``[S, bcap]``
    buffers (int32, or float32 moved as its bits) whose row d goes to rank
    d; returns the received ``[S, bcap]`` buffers, row s from rank s —
    source-rank order, as ``jax.lax.all_to_all(x, axis, 0, 0)`` returns
    them. All buffers travel in one ``all_to_all_single``."""
    dev = sends[0].device
    packed = torch.stack([x.view(torch.int32) for x in sends], dim=1)
    if exchange_route(group, dev)["staged"]:
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed)
        got = torch.empty_like(host)
        dist.all_to_all_single(got, host, group=group)
        recv = got.to(dev)
    else:
        recv = torch.empty_like(packed)
        dist.all_to_all_single(recv, packed, group=group)
    return [recv[:, i].view(x.dtype) for i, x in enumerate(sends)]


# ------------------------------------------------------- instrumentation
def _instrumented(fn, op: str):
    """Per-process step counters (``spmd_steps{op}``) and wall-time
    histograms (``db_op_latency_s{table=spmd,op}``; eager launches are
    asynchronous, so a step on the card is timed to its last host wait).
    The series ``lsm_retraces{table=spmd}`` and ``lsm_compiled_shapes``
    exist for schema parity with the JAX package and stay at zero: eager
    PyTorch has no compile cache to grow. The raw step stays reachable as
    ``step.__wrapped__``."""
    reg = default_registry()
    c_steps = reg.counter("spmd_steps", op=op)
    reg.counter("lsm_retraces", table="spmd", op=op)
    reg.gauge("lsm_compiled_shapes", table="spmd", op=op)
    h_step = reg.histogram("db_op_latency_s", table="spmd", op=op)

    def step(*args, **kw):
        if not reg.enabled:
            return fn(*args, **kw)
        t0 = perf_counter()
        out = fn(*args, **kw)
        c_steps.inc()
        h_step.observe(perf_counter() - t0)
        return out

    step.__wrapped__ = fn
    step.__name__ = f"spmd_{op}_step"
    return step


def merge_process_metrics(snapshots) -> dict:
    """Merge per-process ``Registry.snapshot()`` dicts at the host (one
    registry per rank): counters sum, histograms bucket-merge with
    recomputed percentiles."""
    return merge_snapshots(snapshots)


# ------------------------------------------------------------- bucketing
def _scatter_send(dest, br, bc, bv, num_shards: int):
    """Stable sort of one batch by destination rank, then a scatter into
    ``[S, bcap]`` send buffers (pads I32_MAX / 0)."""
    bcap = br.shape[0]
    dev = br.device
    dest, order = torch.sort(dest, stable=True)
    starts = torch.searchsorted(
        dest, torch.arange(num_shards, dtype=dest.dtype, device=dev))
    slot = torch.arange(bcap, device=dev) - starts[dest]
    sends = []
    for x, fill, dtype in ((br, I32_MAX, torch.int32),
                           (bc, I32_MAX, torch.int32), (bv, 0, torch.float32)):
        buf = torch.full((num_shards, bcap), fill, dtype=dtype, device=dev)
        sends.append(buf.index_put_((dest, slot), x[order].to(dtype)))
    return tuple(sends)


def _bucket_local(br, bc, bv, num_shards: int, id_capacity: int):
    """Bucket one ingestor's batch ``[bcap]`` into ``[S, bcap]`` send
    buffers by the range pre-split; pads (I32_MAX rows) go to rank S-1."""
    owner = torch.clamp((br.to(torch.int64) * num_shards) // id_capacity,
                        max=num_shards - 1)
    dest = torch.where(br == I32_MAX, num_shards - 1, owner)
    return _scatter_send(dest, br, bc, bv, num_shards)


def _bucket_local_tablets(br, bc, bv, splits, owners, num_shards: int):
    """Tablet-map variant of ``_bucket_local``: the owner rank is
    ``owners[searchsorted(splits, id, 'right')]``, ``splits`` / ``owners``
    from ``TabletMap.device_routing(max_T)`` (padded split slots hold
    ``id_capacity``, which no valid id reaches). A split or move changes
    their values, never their shapes."""
    dev = br.device
    splits = torch.as_tensor(splits, device=dev).to(br.dtype)
    owners = torch.as_tensor(owners, device=dev).to(torch.int64)
    t = torch.searchsorted(splits, br, right=True)
    dest = torch.where(br == I32_MAX, num_shards - 1, owners[t])
    return _scatter_send(dest, br, bc, bv, num_shards)


# ------------------------------------------------------------ the states
@dataclasses.dataclass
class L0Stack:
    """One rank's stack of L0 sorted runs: ``[slots, run_cap]`` and the
    number of used slots ``k`` (0-d int32)."""
    rows: torch.Tensor  # int32 [slots, run_cap]
    cols: torch.Tensor  # int32 [slots, run_cap]
    vals: torch.Tensor  # float32 [slots, run_cap]
    k: torch.Tensor     # int32 0-d


def stacked_empty(capacity: int,
                  device: Union[str, torch.device] = "cuda") -> Tablet:
    """This rank's empty tablet of ``capacity``: one row of the JAX
    package's ``stacked_empty(S, capacity)``."""
    return tablet_empty(capacity, device=device)


def l0_stacked_empty(slots: int, run_cap: int,
                     device: Union[str, torch.device] = "cuda") -> L0Stack:
    """This rank's empty L0 stack: one row of the JAX package's
    ``l0_stacked_empty(S, slots, run_cap)``."""
    dev = resolve_device(device)
    rows = torch.full((slots, run_cap), I32_MAX, dtype=torch.int32,
                      device=dev)
    return L0Stack(rows=rows, cols=rows.clone(),
                   vals=torch.zeros((slots, run_cap), dtype=torch.float32,
                                    device=dev),
                   k=torch.zeros((), dtype=torch.int32, device=dev))


def from_jax_stacked(arrays: Mapping[str, np.ndarray], rank: int,
                     device: Union[str, torch.device] = "cuda"):
    """Rank ``rank``'s state from a JAX step's stacked state, given as its
    fields in numpy (``[S, ...]``): a ``Tablet`` for fields with ``n``, an
    ``L0Stack`` for fields with ``k``."""
    dev = resolve_device(device)
    kind, count = (Tablet, "n") if "n" in arrays else (L0Stack, "k")
    out = {f: torch.as_tensor(np.array(arrays[f][rank]), device=dev)
           for f in ("rows", "cols", "vals", count)}
    return kind(**out)


def to_stacked_numpy(states: Sequence) -> dict:
    """The ranks' states (in rank order, each a ``Tablet`` or ``L0Stack``
    on any device) stacked into the JAX step's numpy form: ``{field: [S,
    ...]}``."""
    fields = [f.name for f in dataclasses.fields(states[0])]
    return {f: np.stack([getattr(s, f).cpu().numpy() for s in states])
            for f in fields}


def _append(me: L0Stack, run) -> L0Stack:
    """Write ``run`` into slot ``k`` and count it. A full stack (``k ==
    slots``) matches no slot: the step is a no-op for this rank and ``k``
    stays at ``slots`` (the JAX ``mode="drop"`` scatter)."""
    slots = me.rows.shape[0]
    at = (torch.arange(slots, device=me.k.device) == me.k)[:, None]
    return L0Stack(rows=torch.where(at, run[0], me.rows),
                   cols=torch.where(at, run[1], me.cols),
                   vals=torch.where(at, run[2], me.vals),
                   k=torch.clamp(me.k + 1, max=slots))


def _sorted_run(recv, combiner: str):
    """The received ``[S, bcap]`` buffers as one L0 run of ``S * bcap``:
    a stable sort by (row, col), the combiner, the kept entries compacted
    to the front."""
    rr, rc, rv = (x.reshape(-1) for x in recv)
    _, order = torch.sort(pair_key(rr, rc), stable=True)
    sr, sc, sv = rr[order], rc[order], rv[order]
    keep, out_v = _dedup_combine(sr, sc, sv, combiner)
    run_r, run_c, run_v, _ = _compact(keep, sr, sc, out_v, sr.shape[0])
    return run_r, run_c, run_v


# ----------------------------------------------------------- step builders
def make_spmd_ingest_step(mesh, axis: str, num_shards: int, id_capacity: int,
                          combiner: str = "last"):
    """The legacy step: route a batch, then merge what this rank received
    into its tablet (``tablet_insert``: the merge-path rank kernel on the
    card). The new ``n`` may exceed the capacity: the caller checks it."""
    group = _axis_group(mesh, axis, num_shards)

    def step(tablet: Tablet, br, bc, bv) -> Tablet:
        recv = _exchange(group, _bucket_local(br, bc, bv, num_shards,
                                              id_capacity))
        return tablet_insert(tablet, *(x.reshape(-1) for x in recv),
                             combiner=combiner)

    return _instrumented(step, "spmd_ingest")


def make_spmd_lsm_ingest_step(mesh, axis: str, num_shards: int,
                              id_capacity: int, combiner: str = "last"):
    """LSM ingest step: route a batch, sort + dedup what arrived, append it
    as one L0 run. Per-rank cost is O(S * bcap log) whatever the table
    holds; compaction is ``make_spmd_lsm_compact_step``. The caller MUST
    compact when ``k`` reaches ``slots`` before the next step: a step
    against a full stack is a no-op for that rank (``k`` stays at
    ``slots`` so the host check keeps firing, and the batch is NOT
    ingested — re-submit it after compacting)."""
    group = _axis_group(mesh, axis, num_shards)

    def step(l0: L0Stack, br, bc, bv) -> L0Stack:
        recv = _exchange(group, _bucket_local(br, bc, bv, num_shards,
                                              id_capacity))
        return _append(l0, _sorted_run(recv, combiner))

    return _instrumented(step, "spmd_lsm_ingest")


def make_spmd_tablet_ingest_step(mesh, axis: str, num_shards: int,
                                 combiner: str = "last"):
    """The LSM ingest step routed by a dynamic tablet map: each call takes
    the map's current ``(splits, owners)`` from
    ``TabletMap.device_routing(max_T)``. The host rebalances by passing
    new arrays of the same shapes; the step is built once. Same full-stack
    contract as ``make_spmd_lsm_ingest_step``."""
    group = _axis_group(mesh, axis, num_shards)

    def step(l0: L0Stack, br, bc, bv, splits, owners) -> L0Stack:
        recv = _exchange(group, _bucket_local_tablets(br, bc, bv, splits,
                                                      owners, num_shards))
        return _append(l0, _sorted_run(recv, combiner))

    return _instrumented(step, "spmd_tablet_ingest")


def make_spmd_lsm_pair_ingest_step(mesh, axis: str, num_shards: int,
                                   id_capacity: int,
                                   combiner: str = "last"):
    """Dual ingest for an engine-maintained transpose pair: one step routes
    the batch twice — forward triples by row owner into ``A``'s L0 stack,
    swapped triples by column owner into ``A^T``'s — in one exchange, so
    both sides advance together. Same full-stack contract as
    ``make_spmd_lsm_ingest_step``: when either ``k`` reaches ``slots``,
    compact BOTH and re-submit the batch."""
    group = _axis_group(mesh, axis, num_shards)

    def step(l0: L0Stack, l0t: L0Stack, br, bc, bv):
        # rows and cols share one id space: the same partition routes both
        fwd = _bucket_local(br, bc, bv, num_shards, id_capacity)
        twd = _bucket_local(bc, br, bv, num_shards, id_capacity)
        recv = _exchange(group, fwd + twd)
        return (_append(l0, _sorted_run(recv[:3], combiner)),
                _append(l0t, _sorted_run(recv[3:], combiner)))

    return _instrumented(step, "spmd_lsm_pair_ingest")


def make_spmd_lsm_query_step(mesh, axis: str, combiner: str = "last",
                             max_return: int = 64, q_tile: int = None):
    """Fused point reads on the mesh: each rank searches its level run and
    its whole L0 stack for its own queries and combines the candidates on
    its device (no exchange). Queries arrive owner-routed as ``q[Qb]``
    (pad -1, which matches no row id). Age order: level run (oldest) = 1,
    L0 slot k = 2 + k. Returns ``(cols[Qb, W], vals[Qb, W], keep[Qb, W])``
    with ``W = (slots + 1) * max_return``: per query, the kept entries are
    its combined (col, val) results, cols ascending. A run contributes at
    most ``max_return`` entries of a row; nothing flags a longer row.

    ``q_tile`` splits batches wider than it along the query axis into
    ``q_tile``-wide blocks (the last padded with -1) and concatenates the
    blocks' outputs back to ``Qb``; ``None`` reads a batch in one block."""
    _axis_group(mesh, axis)

    def probe(rows, cols, vals, q):
        """Rank search of each sorted run ``[K, cap]``: ``[K, Q, R]``."""
        n_k, cap = rows.shape
        qk = q.expand(n_k, -1).contiguous()
        start = torch.searchsorted(rows, qk, out_int32=True)
        end = torch.searchsorted(rows, qk, right=True, out_int32=True)
        idx = start[..., None] + torch.arange(max_return, dtype=torch.int32,
                                              device=q.device)
        ok = idx < end[..., None]
        at = idx.clamp(0, cap - 1).long().reshape(n_k, -1)
        shape = (n_k, q.shape[0], max_return)
        return (cols.gather(1, at).reshape(shape),
                vals.gather(1, at).reshape(shape), ok)

    def flat(x):  # [K, Q, R] -> [Q, K * R], run after run
        return x.permute(1, 0, 2).reshape(x.shape[1], -1)

    def base(l0: L0Stack, level: Tablet, q):
        q = q.to(torch.int32)
        segs = [probe(level.rows[None], level.cols[None], level.vals[None],
                      q),
                probe(l0.rows, l0.cols, l0.vals, q)]
        cols_all, vals_all, ok_all = (
            torch.cat([flat(s[i]) for s in segs], dim=1) for i in range(3))
        # a stable sort by col keeps equal cols in age (segment) order
        col_s, perm = torch.sort(torch.where(ok_all, cols_all, I32_MAX),
                                 dim=1, stable=True)
        val_s = vals_all.gather(1, perm)
        keep, out_v = _dedup_combine(col_s, torch.zeros_like(col_s), val_s,
                                     combiner)
        return col_s, torch.where(keep, out_v, 0.0), keep

    if q_tile is None:
        return _instrumented(base, "spmd_lsm_query")

    def tiled(l0: L0Stack, level: Tablet, q):
        n_q = q.shape[0]
        if n_q <= q_tile:
            return base(l0, level, q)
        outs = []
        for t in range(0, n_q, q_tile):
            blk = q[t:t + q_tile]
            pad = q_tile - blk.shape[0]
            if pad:
                blk = torch.cat([blk, blk.new_full((pad,), -1)])
            outs.append(base(l0, level, blk))
        return tuple(torch.cat([o[i] for o in outs])[:n_q] for i in range(3))

    return _instrumented(tiled, "spmd_lsm_query")


def make_spmd_lsm_scan_step(mesh, axis: str, combiner: str = "last",
                            width: int = 128,
                            transpose_output: bool = False):
    """Fused range scans on the mesh: each rank answers its own ``[lo,
    hi)`` row-range scan (``bounds[2]``; a rank outside the global range
    passes ``lo == hi``) over its level run and whole L0 stack, merged and
    deduped on its device. Both endpoints rank with ``side='left'``. Age
    order as in the point step. Returns ``(rows[W], cols[W], vals[W],
    keep[W], cnt_max)`` with ``W = (slots + 1) * width``, kept entries
    sorted by (row, col); ``cnt_max`` > width means some run's slice
    overflowed the window — re-make the step wider (batch-scanner
    semantics).

    ``transpose_output=True`` serves COLUMN-range scans over a pair's
    transpose sibling stacks: the scan ranks over the sibling's row axis
    (``A``'s columns) and the outputs come back swapped into ``A``'s
    orientation, kept entries sorted by (col, row)."""
    _axis_group(mesh, axis)

    def window(rows, cols, vals, bounds):
        """The ``[lo, hi)`` window of each sorted run ``[K, cap]``."""
        n_k, cap = rows.shape
        lohi = bounds.to(torch.int32).expand(n_k, 2).contiguous()
        ends = torch.searchsorted(rows, lohi, out_int32=True)
        idx = ends[:, :1] + torch.arange(width, dtype=torch.int32,
                                         device=rows.device)
        at = idx.clamp(0, cap - 1).long()
        cnt = ends[:, 1] - ends[:, 0]
        return (rows.gather(1, at).reshape(-1), cols.gather(1, at).reshape(-1),
                vals.gather(1, at).reshape(-1),
                (idx < ends[:, 1:]).reshape(-1), cnt)

    def step(l0: L0Stack, level: Tablet, bounds):
        segs = [window(level.rows[None], level.cols[None], level.vals[None],
                       bounds),
                window(l0.rows, l0.cols, l0.vals, bounds)]
        rows_all, cols_all, vals_all, ok_all = (
            torch.cat([s[i] for s in segs]) for i in range(4))
        row_m = torch.where(ok_all, rows_all, I32_MAX)
        col_m = torch.where(ok_all, cols_all, I32_MAX)
        # a stable sort by (row, col) keeps equal keys in age order
        _, perm = torch.sort(pair_key(row_m, col_m), stable=True)
        row_s, col_s, val_s = row_m[perm], col_m[perm], vals_all[perm]
        keep, out_v = _dedup_combine(row_s, col_s, val_s, combiner)
        cnt_max = torch.cat([s[4] for s in segs]).max()
        if transpose_output:  # sibling rows ARE A's cols: swap back
            row_s, col_s = col_s, row_s
        return row_s, col_s, torch.where(keep, out_v, 0.0), keep, cnt_max

    return _instrumented(step, "spmd_lsm_scan")


def make_spmd_lsm_compact_step(mesh, axis: str, combiner: str = "last"):
    """Major compaction on the mesh: each rank k-way merges its level run
    (oldest) and its L0 slots, oldest first (``kway_merge``: the
    merge-path rank kernel on the card), applies the combiner and compacts
    into the level's capacity; ``n`` is the kept count, which the caller
    checks for overflow. L0 empties. Returns ``(l0, level)``."""
    _axis_group(mesh, axis)

    def step(l0: L0Stack, level: Tablet):
        runs = [(level.rows, level.cols, level.vals)]
        runs += [(l0.rows[i], l0.cols[i], l0.vals[i])
                 for i in range(l0.rows.shape[0])]
        mr, mc, mv = kway_merge(runs)
        keep, out_v = _dedup_combine(mr, mc, mv, combiner)
        r, c, v, n = _compact(keep, mr, mc, out_v, level.rows.shape[0])
        empty = L0Stack(rows=torch.full_like(l0.rows, I32_MAX),
                        cols=torch.full_like(l0.cols, I32_MAX),
                        vals=torch.zeros_like(l0.vals),
                        k=torch.zeros_like(l0.k))
        return empty, Tablet(rows=r, cols=c, vals=v, n=n.to(torch.int32))

    return _instrumented(step, "spmd_lsm_compact")
