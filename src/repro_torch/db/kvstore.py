"""Sharded sorted key-value store — the Accumulo analogue, on PyTorch.

Each *tablet* holds (row_id, col_id) -> value entries on one shard,
range-partitioned by row id (pre-split tablets). Two storage engines:

  * ``engine="lsm"`` (default) — leveled sorted runs
    (``repro_torch.db.lsm``): memtable flushes are O(memtable), major
    compactions k-way merge runs with the merge-path rank kernel, and reads
    go through bloom filters + fence pointers without flushing.
  * ``engine="single"`` — one fixed-capacity sorted run per shard; every
    flush merges the memtable into it (merge-path rank kernel). Point reads
    are one two-sided rank search (the 1-D rank kernel) and one compacting
    gather (``tablet_read``). Kept as the A/B baseline of the paper-era
    benchmarks.

Duplicate keys combine with Accumulo iterator semantics (last-wins
versioning, sum/min/max combiners — ``db.iterators``). ``ShardedTable``
keeps S shards' state stacked [S, ...] on one device.
"""
from __future__ import annotations

import dataclasses
from time import perf_counter
from typing import Union

import numpy as np
import torch

from ..kernels.common import I32_MAX, resolve_device
from ..kernels.merge_rank import merge_sorted, merge_sorted_ref
from ..kernels.segment_reduce import segment_sum
from ..kernels.sorted_search import sorted_search, tablet_read
from ..obs import default_registry, default_tracer

COMBINERS = ("last", "sum", "min", "max")


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """Engine/topology configuration for one store, field for field the
    JAX package's, so a config dict means the same in both packages.

    Built ONCE (``db.connector.dbsetup``) and passed by reference down the
    DBserver → Table → ShardedTable chain. ``transpose=True`` makes the
    store maintain its transpose ``A^T`` as an engine-level sibling shard
    set (``ShardedTable.t_store``): every ingest batch lands in both, and
    column selectors become fence-rangeable scans on the sibling.
    ``use_pallas`` selects the hand kernels. The device is not a field:
    it is a keyword of the constructors.
    """
    num_shards: int = 4
    capacity_per_shard: int = 1 << 18
    batch_cap: int = 1 << 15
    id_capacity: int = 1 << 22
    use_pallas: bool = False
    engine: str = "lsm"
    fused_reads: bool = True
    fused_q_limit: int = 512
    l0_slots: int = 4
    fanout: int = 4
    memtable_cap: int = None
    transpose: bool = False
    dynamic_tablets: bool = False

    def replace(self, **kw) -> "StoreConfig":
        return dataclasses.replace(self, **kw)


def _dedup_combine(mr, mc, mv, combiner: str):
    """Collapse adjacent duplicate keys of merged sorted runs (along the
    last axis). Returns (keep mask, combined values)."""
    valid = mr != I32_MAX
    new = torch.ones_like(valid)
    new[..., 1:] = (mr[..., 1:] != mr[..., :-1]) | (mc[..., 1:] != mc[..., :-1])
    if combiner == "last":
        keep = valid & torch.cat([new[..., 1:], torch.ones_like(new[..., :1])],
                                 dim=-1)
        return keep, mv
    seg = torch.cumsum(new, dim=-1) - 1
    if combiner == "sum":
        agg = torch.zeros_like(mv).scatter_add_(
            -1, seg, torch.where(valid, mv, torch.zeros_like(mv)))
    elif combiner == "min":
        agg = torch.full_like(mv, float("inf")).scatter_reduce_(
            -1, seg, torch.where(valid, mv, float("inf")), "amin",
            include_self=True)
    elif combiner == "max":
        agg = torch.full_like(mv, float("-inf")).scatter_reduce_(
            -1, seg, torch.where(valid, mv, float("-inf")), "amax",
            include_self=True)
    else:
        raise ValueError(f"unknown combiner {combiner!r}")
    return valid & new, agg.gather(-1, seg)


@dataclasses.dataclass
class Tablet:
    """One sorted run per shard (the legacy engine's storage). Fields are
    1-D ``[cap]``, or stacked ``[S, cap]`` for S shards (counts ``[S]``)."""
    rows: torch.Tensor  # int32; valid prefix sorted lex by (row, col); pad I32_MAX
    cols: torch.Tensor  # int32
    vals: torch.Tensor  # float32
    n: torch.Tensor     # int32 valid count


def tablet_empty(capacity: int, shards: int = None,
                 device: Union[str, torch.device] = "cuda") -> Tablet:
    """An empty tablet of ``capacity``; ``shards`` stacks S of them."""
    dev = resolve_device(device)
    shape = (capacity,) if shards is None else (shards, capacity)
    return Tablet(
        rows=torch.full(shape, I32_MAX, dtype=torch.int32, device=dev),
        cols=torch.full(shape, I32_MAX, dtype=torch.int32, device=dev),
        vals=torch.zeros(shape, dtype=torch.float32, device=dev),
        n=torch.zeros(shape[:-1], dtype=torch.int32, device=dev),
    )


def tablet_insert(t: Tablet, br, bc, bv, combiner: str = "last",
                  use_pallas: bool = True) -> Tablet:
    """Minor compaction: merge a batch (pads = I32_MAX keys) into the run.

    ``t`` is 1-D with a batch ``[b]``, or stacked ``[S, cap]`` with
    batches ``[S, b]``: the merge ranks every shard in one merge-path
    launch (the JAX engine ``vmap``s this function over shards).
    Returns the new tablet; ``new.n`` may exceed capacity — the caller
    MUST check for overflow (Accumulo back-pressure analogue).
    """
    from .lsm.engine import _compact
    # stable lexsort of the batch by (row, col): keys are non-negative
    # int32 with I32_MAX pads, so one int64 key keeps the age order
    key = (br.to(torch.int64) << 32) | bc.to(torch.int64)
    _, order = torch.sort(key, dim=-1, stable=True)
    br, bc, bv = br.gather(-1, order), bc.gather(-1, order), bv.gather(-1, order)
    merge = merge_sorted if use_pallas else merge_sorted_ref
    mr, mc, mv = merge(t.rows, t.cols, t.vals, br, bc, bv)
    keep, out_v = _dedup_combine(mr, mc, mv, combiner)
    rr, cc, vv, n = _compact(keep, mr, mc, out_v, t.rows.shape[-1])
    return Tablet(rows=rr, cols=cc, vals=vv, n=n.to(torch.int32))


def tablet_query_rows(t: Tablet, q: torch.Tensor, max_return: int,
                      use_pallas: bool = True):
    """Point row queries: all (col, val) for each row id in ``q``.

    Returns (cols[Q, max_return], vals[Q, max_return], valid[Q, max_return],
    counts[Q]); counts may exceed max_return (the caller re-queries with a
    larger bound — Accumulo batch-scanner buffer semantics).
    """
    q = q.to(torch.int32)
    if use_pallas:
        start, end = sorted_search(t.rows, q, "both")
    else:
        start = torch.searchsorted(t.rows, q, out_int32=True)
        end = torch.searchsorted(t.rows, q, right=True, out_int32=True)
    cap = t.rows.shape[0]
    idx = start[:, None] + torch.arange(max_return, dtype=torch.int32,
                                        device=q.device)[None, :]
    ok = idx < end[:, None]
    idxc = idx.clamp(0, cap - 1).long()
    return t.cols[idxc], t.vals[idxc], ok, end - start


def degree_update(deg: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
                  use_pallas: bool = True) -> torch.Tensor:
    """Combiner-iterator analogue: accumulate counts into a dense degree
    row. Ids < 0 (and past the row) are dropped."""
    if use_pallas:
        return deg + segment_sum(ids, weights, n_segments=deg.shape[0])
    valid = (ids >= 0) & (ids < deg.shape[0])
    return deg.index_add(0, torch.where(valid, ids, 0).long(),
                         torch.where(valid, weights.to(deg.dtype), 0.0))


# --------------------------------------------------------------------------
# Range partitioning (pre-split tablets)
# --------------------------------------------------------------------------
def shard_of(ids: np.ndarray, num_shards: int, id_capacity: int) -> np.ndarray:
    """Owner shard by range partition of the id space (uniform pre-split)."""
    return np.minimum(
        (ids.astype(np.int64) * num_shards) // id_capacity, num_shards - 1
    ).astype(np.int32)


def _memtable_append_flat(mem_r, mem_c, mem_v, counts, dest, slot, r, c, v):
    """Flat append, in place: entry i of the (dest-sorted) batch lands at
    memtable[dest_i, counts[dest_i] + slot_i]. The memtables are
    ``[S, m + 1]`` tensors whose last column takes what is dropped: pads
    (dest == S) and entries past the capacity. ``counts`` and the batch are
    host numpy arrays; returns the new host counts."""
    s, width = mem_r.shape
    cap = width - 1
    valid = dest < s
    dsafe = np.where(valid, dest, 0)
    col = np.where(valid, counts[dsafe] + slot, cap)
    col = np.minimum(col, cap)
    dev = mem_r.device
    idx = (torch.as_tensor(dsafe, dtype=torch.int64, device=dev),
           torch.as_tensor(col, dtype=torch.int64, device=dev))
    mem_r.index_put_(idx, torch.as_tensor(r, dtype=torch.int32, device=dev))
    mem_c.index_put_(idx, torch.as_tensor(c, dtype=torch.int32, device=dev))
    mem_v.index_put_(idx, torch.as_tensor(v, dtype=torch.float32, device=dev))
    return counts + np.bincount(dsafe[valid], minlength=s).astype(counts.dtype)


# what each deferred option waits for (ROADMAP, Queue 1)
_LATER = {
    "wal_dir": "Queue 1 item 5 (durability)",
    "dynamic_tablets": "Queue 1 item 7 (dynamic tablets)",
    "fused_reads=False": "Queue 1 item 3 (per-run read path)",
}


def _not_yet(option: str):
    return NotImplementedError(
        f"{option} is not ported yet: see ROADMAP.md, {_LATER[option]}")


class ShardedTable:
    """Stacked-tablet driver: S tablet servers' state on one device.

    Writes land in a per-shard *memtable* (unsorted fixed buffer on the
    device); a minor compaction happens only when a shard's memtable would
    overflow. Two storage engines sit under that memtable:

      * ``engine="lsm"`` (default) — the leveled LSM engine
        (``db.lsm.LSMRuns``): flushes cost O(memtable), major compactions
        k-way merge runs, and reads serve from memtable + runs (mirrored
        on the host) through bloom filters and fence pointers WITHOUT
        flushing.
      * ``engine="single"`` — the legacy single-sorted-run tablet: every
        flush merges the memtable into one O(capacity) run; reads flush
        the queried shards first.

    ``device`` (default ``"cuda"``) holds the memtables and runs; without a
    card, construction raises unless ``device="cpu"`` is given.
    """

    def __init__(self, name: str, num_shards: int = None,
                 capacity_per_shard: int = None, batch_cap: int = None,
                 id_capacity: int = None, combiner: str = "last",
                 use_pallas: bool = None, memtable_cap: int = None,
                 engine: str = None, l0_slots: int = None, fanout: int = None,
                 wal_dir: str = None, fused_reads: bool = None,
                 fused_q_limit: int = None, bloom_bits_per_key=None,
                 bloom_hashes=None, transpose: bool = None,
                 dynamic_tablets: bool = None,
                 config: StoreConfig = None,
                 device: Union[str, torch.device] = "cuda"):
        if combiner not in COMBINERS:
            raise ValueError(f"unknown combiner {combiner!r}")
        # config is the canonical record (StoreConfig defaults when absent);
        # explicit kwargs override it
        cfg = config if config is not None else StoreConfig()
        overrides = {k: v for k, v in dict(
            num_shards=num_shards, capacity_per_shard=capacity_per_shard,
            batch_cap=batch_cap, id_capacity=id_capacity,
            use_pallas=use_pallas, memtable_cap=memtable_cap, engine=engine,
            l0_slots=l0_slots, fanout=fanout, fused_reads=fused_reads,
            fused_q_limit=fused_q_limit, transpose=transpose,
            dynamic_tablets=dynamic_tablets).items()
            if v is not None}
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        if cfg.engine not in ("lsm", "single"):
            raise ValueError(f"unknown engine {cfg.engine!r}")
        if cfg.transpose and cfg.engine != "lsm":
            raise ValueError("transpose pairs require engine='lsm'")
        if cfg.dynamic_tablets and cfg.engine != "lsm":
            raise ValueError("dynamic_tablets requires engine='lsm'")
        if wal_dir is not None:
            raise _not_yet("wal_dir")
        if cfg.dynamic_tablets:
            raise _not_yet("dynamic_tablets")
        if cfg.engine == "lsm" and not cfg.fused_reads:
            raise _not_yet("fused_reads=False")
        self.device = resolve_device(device)
        self.config = cfg
        self.name = name
        self.engine = cfg.engine
        self.S = cfg.num_shards
        self.cap = cfg.capacity_per_shard
        self.batch_cap = cfg.batch_cap
        self.id_capacity = cfg.id_capacity
        self.combiner = combiner
        self.use_pallas = cfg.use_pallas
        # fused_q_limit is the QUERY TILE: batches beyond the tiny point
        # bucket pad up to it, and larger ones split into tiles of it
        self.fused_reads = cfg.fused_reads
        self.fused_q_limit = cfg.fused_q_limit
        self.mem_cap = cfg.memtable_cap or max(
            cfg.batch_cap * 4, min(cfg.capacity_per_shard, 1 << 18))
        self._closed = False
        # engine-maintained transpose sibling: rows and cols share one id
        # space (one keydict), so A^T routes through the same shard_of
        self.t_store = None
        if cfg.transpose:
            self.t_store = ShardedTable(
                name + "@T", combiner=combiner,
                bloom_bits_per_key=bloom_bits_per_key,
                bloom_hashes=bloom_hashes,
                config=dataclasses.replace(cfg, transpose=False,
                                           memtable_cap=self.mem_cap),
                device=self.device)
        # per-batch latency histograms + per-shard op counters/histograms
        # (series reset here so a fresh table reads zeros)
        S = self.S
        self._reg = default_registry()
        self._trace = default_tracer()
        self._h_ingest = self._reg.histogram("db_op_latency_s", table=name,
                                             op="ingest")
        self._h_query = self._reg.histogram("db_op_latency_s", table=name,
                                            op="query")
        self._h_scan = self._reg.histogram("db_op_latency_s", table=name,
                                           op="scan")
        # whole-table scans (the O(nnz) path selectors should avoid)
        self._c_full_scans = self._reg.counter("db_full_scans", table=name)
        self._c_shard_ingest = [
            self._reg.counter("db_ingest_entries", table=name, shard=s)
            for s in range(S)]
        self._c_shard_query = [
            self._reg.counter("db_point_queries", table=name, shard=s)
            for s in range(S)]
        self._c_shard_scan = [
            self._reg.counter("db_range_scans", table=name, shard=s)
            for s in range(S)]
        self._h_shard_query = [
            self._reg.histogram("db_shard_op_latency_s", table=name,
                                shard=s, op="query")
            for s in range(S)]
        self._h_shard_scan = [
            self._reg.histogram("db_shard_op_latency_s", table=name,
                                shard=s, op="scan")
            for s in range(S)]
        for inst in ([self._h_ingest, self._h_query, self._h_scan,
                      self._c_full_scans]
                     + self._c_shard_ingest + self._c_shard_query
                     + self._c_shard_scan + self._h_shard_query
                     + self._h_shard_scan):
            inst.reset()
        if self.engine == "lsm":
            from .lsm.bloom import BITS_PER_KEY, NUM_HASHES
            from .lsm.engine import LSMRuns
            self._runs = LSMRuns(
                S, cfg.capacity_per_shard, self.mem_cap, combiner,
                cfg.use_pallas, l0_slots=cfg.l0_slots, fanout=cfg.fanout,
                bloom_bits_per_key=(BITS_PER_KEY if bloom_bits_per_key is None
                                    else bloom_bits_per_key),
                bloom_hashes=(NUM_HASHES if bloom_hashes is None
                              else bloom_hashes),
                id_capacity=cfg.id_capacity, name=name, device=self.device)
            self.tablets = None
        else:
            self._runs = None
            self.tablets = tablet_empty(self.cap, shards=S,
                                        device=self.device)
            # the LSM engine's counter schema (zeros where an op doesn't
            # apply), so A/B stats line up
            from .lsm.engine import STAT_KEYS
            self._ctr_single = {
                k: self._reg.counter("lsm_" + k, table=name)
                for k in STAT_KEYS}
            self._c_shard_flush_single = [
                self._reg.counter("lsm_shard_flushes", table=name, shard=s)
                for s in range(S)]
            self._h_flush_single = self._reg.histogram(
                "db_op_latency_s", table=name, op="flush")
            # retrace/write-amp series parity with the LSM engine (always
            # zero here)
            single_extra = [
                self._reg.counter("lsm_retraces", table=name, op="query"),
                self._reg.counter("lsm_retraces", table=name, op="scan"),
                self._reg.counter("lsm_flush_entries", table=name),
                self._reg.counter("lsm_compact_entries", table=name)]
            for inst in (list(self._ctr_single.values())
                         + self._c_shard_flush_single + single_extra
                         + [self._h_flush_single]):
                inst.reset()
        # device memtables [S, m + 1]: the spare column takes dropped
        # appends (see _memtable_append_flat); readers see [:, :m]
        self._mem_r = torch.full((S, self.mem_cap + 1), I32_MAX,
                                 dtype=torch.int32, device=self.device)
        self._mem_c = torch.full_like(self._mem_r, I32_MAX)
        self._mem_v = torch.zeros((S, self.mem_cap + 1), dtype=torch.float32,
                                  device=self.device)
        self._mem_n = np.zeros((S,), np.int64)
        # host mirror of memtable appends (per shard): LSM reads serve the
        # unflushed tail without pulling device buffers
        self._mem_mirror = [[] for _ in range(S)]
        # (row, col)-sorted + combiner-deduped mirror per shard, computed
        # lazily for the fused reads and reused until the next insert
        self._mem_sorted: dict = {}

    def close(self) -> None:
        """Release buffers and refuse further use (connector delete())."""
        if self._closed:
            return
        if self.t_store is not None:
            self.t_store.close()
        self._runs = None
        self.tablets = None
        self._mem_r = self._mem_c = self._mem_v = None
        self._mem_n = np.zeros((self.S,), np.int64)
        self._closed = True

    def _check_open(self):
        if self._closed:
            raise RuntimeError(f"table {self.name!r} has been deleted")

    def _mem_views(self):
        m = self.mem_cap
        return self._mem_r[:, :m], self._mem_c[:, :m], self._mem_v[:, :m]

    def warmup(self) -> None:
        """Run the flush/compaction path once on the current state without
        mutating it (builds the kernels before a timed window)."""
        self._check_open()
        if self.engine == "lsm":
            self._runs.warmup(*self._mem_views())
        else:
            tablet_insert(self.tablets, *self._mem_views(), self.combiner,
                          self.use_pallas)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        if self.t_store is not None:
            self.t_store.warmup()

    def warm_reads(self) -> None:
        """Run the read path's two serving shapes — the point bucket and
        the ``fused_q_limit`` query tile — once against the current state,
        on spread-out ids so that every shard dispatches. The legacy engine
        has no batch-size-independent read shape: it runs a point read."""
        self._check_open()
        self.query_rows(np.zeros(1, np.int32))  # point bucket
        if self.engine == "lsm":
            probe = np.linspace(0, self.id_capacity - 1,
                                2 * self.S * 8 + 2).astype(np.int32)
            self.query_rows(np.unique(probe))   # > 8 ids/shard: the tile
        if self.t_store is not None:  # column selectors serve from A^T
            self.t_store.warm_reads()

    def engine_stats(self) -> dict:
        """Observability: flush/compaction counts and bloom skip rates,
        in the JAX engine's counter schema. Both engines emit the SAME
        schema (the single-run engine reports zeros where an op doesn't
        apply)."""
        if self.engine == "lsm":
            st = dict(self._runs.stats)
            st["l0_used"] = [int(x) for x in self._runs.l0_used]
            st["level_entries"] = [int(lv["n"].sum())
                                   for lv in self._runs.levels]
            return st
        st = {k: int(c.value) for k, c in self._ctr_single.items()}
        st["l0_used"] = [0] * self.S
        st["level_entries"] = []
        return st

    def refresh_health_gauges(self, bloom_probes: int = 0) -> None:
        """Recompute the derived health gauges for this table (and its
        transpose sibling): memtable occupancy per shard, resident runs,
        compaction debt, read/write amplification, and
        (``bloom_probes > 0``) the observed-vs-theoretical bloom fp rate."""
        self._check_open()
        for s in range(self.S):
            self._reg.gauge("db_memtable_occupancy", table=self.name,
                            shard=s).set(int(self._mem_n[s]) / self.mem_cap)
        if self.engine == "lsm":
            self._runs.refresh_health_gauges(bloom_probes=bloom_probes)
        else:
            # series parity with the LSM engine: one sorted run per shard
            # once flushed, never any compaction debt
            n_host = self.tablets.n.cpu().numpy()
            for s in range(self.S):
                self._reg.gauge("lsm_resident_runs", table=self.name,
                                shard=s).set(int(n_host[s] > 0))
                self._reg.gauge("lsm_compaction_debt_entries",
                                table=self.name, shard=s).set(0)
            self._reg.gauge("lsm_read_amplification",
                            table=self.name).set(0.0)
            self._reg.gauge("lsm_write_amplification",
                            table=self.name).set(0.0)
        if self.t_store is not None:
            self.t_store.refresh_health_gauges(bloom_probes=bloom_probes)

    def nnz(self) -> int:
        self._check_open()
        if self.engine == "lsm":
            return sum(len(self.scan_shard(s)[0]) for s in range(self.S))
        self.flush()
        return int(self.tablets.n.sum())

    # ------------------------------------------------------------- ingest
    def insert(self, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray):
        """Host-side BatchWriter: bucket by owner + flat memtable append.
        Transpose-enabled stores dual-ingest: the batch lands in the
        primary (routed by row) AND the sibling (routed by col, rows and
        cols swapped)."""
        self._check_open()
        rows = np.asarray(rows, np.int32)
        cols = np.asarray(cols, np.int32)
        vals = np.asarray(vals, np.float32)
        n = len(rows)
        if n == 0:
            return
        if n > self.mem_cap:
            raise OverflowError(f"batch {n} exceeds memtable {self.mem_cap}")
        t0 = perf_counter()
        with self._trace.span("ingest", table=self.name, n=n):
            self._insert_batch(rows, cols, vals)
            if self.t_store is not None:
                self.t_store._insert_batch(cols, rows, vals)
        self._h_ingest.observe(perf_counter() - t0)

    def _insert_batch(self, rows, cols, vals):
        n = len(rows)
        if n > self.mem_cap:
            raise OverflowError(f"batch {n} exceeds memtable {self.mem_cap}")
        dest = shard_of(rows, self.S, self.id_capacity)
        order = np.argsort(dest, kind="stable")
        dest, rows, cols, vals = dest[order], rows[order], cols[order], vals[order]
        counts_b = np.bincount(dest, minlength=self.S)
        if self._reg.enabled:
            for s in np.nonzero(counts_b)[0]:
                self._c_shard_ingest[s].inc(int(counts_b[s]))
        if (self._mem_n + counts_b > self.mem_cap).any():
            self.flush()
        ends = np.cumsum(counts_b)
        starts = ends - counts_b
        if self.engine == "lsm":  # only LSM reads the mirror
            for s in np.nonzero(counts_b)[0]:
                self._mem_mirror[s].append(
                    (rows[starts[s]:ends[s]], cols[starts[s]:ends[s]],
                     vals[starts[s]:ends[s]]))
                self._mem_sorted.pop(int(s), None)
        slot = np.arange(n, dtype=np.int64) - starts[dest]
        self._mem_n = _memtable_append_flat(
            self._mem_r, self._mem_c, self._mem_v, self._mem_n, dest, slot,
            rows, cols, vals)

    def flush(self) -> None:
        """Minor compaction: memtable -> L0 run (LSM, O(memtable)) or merge
        into the single sorted run (legacy, O(capacity)). On the legacy
        engine a merge that would overflow a tablet raises OverflowError
        and leaves the tablets and the memtable as they were."""
        self._check_open()
        if self._mem_n.max(initial=0) > 0:
            if self.engine == "lsm":
                self._runs.flush_memtable(*self._mem_views())
            else:
                self._flush_single()
            self._mem_r.fill_(I32_MAX)
            self._mem_c.fill_(I32_MAX)
            self._mem_v.zero_()
            self._mem_n = np.zeros((self.S,), np.int64)
            self._mem_mirror = [[] for _ in range(self.S)]
            self._mem_sorted.clear()
        if self.t_store is not None:
            self.t_store.flush()

    def _flush_single(self) -> None:
        t0 = perf_counter()
        with self._trace.span("flush", table=self.name):
            new = tablet_insert(self.tablets, *self._mem_views(),
                                self.combiner, self.use_pallas)
            n_max = int(new.n.max())
            if n_max > self.cap:
                raise OverflowError(
                    f"tablet overflow in {self.name}: {n_max} > {self.cap}")
            self.tablets = new
        self._h_flush_single.observe(perf_counter() - t0)
        self._ctr_single["flushes"].inc()
        for s in np.nonzero(self._mem_n)[0]:
            self._c_shard_flush_single[s].inc()

    def _shard_tablet(self, s: int) -> Tablet:
        """Shard ``s``'s run of the stacked tablets (views, no copy)."""
        t = self.tablets
        return Tablet(rows=t.rows[s], cols=t.cols[s], vals=t.vals[s], n=t.n[s])

    def tablet_arrays(self) -> dict:
        """The legacy engine's stacked tablets as numpy copies: ``rows``,
        ``cols``, ``vals`` [S, cap] and ``n`` [S], the fields of the JAX
        engine's ``Tablet`` (``load_jax_tablets`` takes them back)."""
        self._check_open()
        if self.engine != "single":
            raise ValueError("tablet_arrays() requires engine='single'")
        return {k: getattr(self.tablets, k).to("cpu", copy=True).numpy()
                for k in ("rows", "cols", "vals", "n")}

    def _mem_host(self, s: int):
        """Host mirror of shard ``s``'s memtable."""
        if not self._mem_mirror[s]:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.float32))
        return tuple(np.concatenate([b[i] for b in self._mem_mirror[s]])
                     for i in range(3))

    def _mem_host_sorted(self, s: int):
        """The mirror, (row, col)-sorted and pre-combined for the fused
        reads (commutes with the cross-run combine, exactly like a flush
        would); cached until the next insert touches the shard. None when
        the shard's memtable is empty."""
        if not self._mem_n[s]:
            return None
        got = self._mem_sorted.get(s)
        if got is None:
            from .lsm.engine import combine_triples
            mh = self._mem_host(s)
            got = combine_triples(mh[0], mh[1], mh[2],
                                  np.arange(len(mh[0]), dtype=np.int32),
                                  self.combiner)
            self._mem_sorted[s] = got
        return got

    def major_compact(self) -> None:
        """Force a major compaction (LSM): flush, then merge all runs. The
        legacy engine has nothing to compact."""
        self._check_open()
        if self.engine != "lsm":
            return
        self.flush()
        self._runs.major_compact()
        if self.t_store is not None:
            self.t_store.major_compact()

    # -------------------------------------------------------------- query
    def query_rows(self, row_ids: np.ndarray, max_return: int = 256,
                   col_filter: np.ndarray = None):
        """Point queries; returns (row_id, col_id, val) numpy triples.

        LSM engine: served from memtable + runs by the fused read (no
        flush). Legacy engine: flushes only when a QUERIED shard's memtable
        is non-empty, then rank-searches each owner shard's run.
        Duplicate query ids return duplicate results.

        ``col_filter`` restricts results to a column id set; on the LSM
        engine the membership test runs on the device inside the
        dispatch, on the legacy engine on the host.
        """
        self._check_open()
        t_call = perf_counter()
        host_filter = None
        if col_filter is not None:
            col_filter = np.asarray(col_filter, np.int32)
            if self.engine != "lsm":
                host_filter, col_filter = col_filter, None
        row_ids = np.asarray(row_ids, np.int32)
        owner = shard_of(row_ids, self.S, self.id_capacity)
        if self.engine == "lsm":
            out = self._query_rows_lsm(row_ids, owner, max_return, col_filter)
        else:
            out = self._query_rows_single(row_ids, owner, max_return)
        if len(row_ids):
            self._h_query.observe(perf_counter() - t_call)
        return _finish(out, host_filter)

    def _query_rows_lsm(self, row_ids, owner, max_return, col_filter):
        out = []
        for s in np.unique(owner):
            s = int(s)
            q = row_ids[owner == s]
            self._c_shard_query[s].inc(len(q))
            t_sh = perf_counter()
            # duplicate query ids return duplicate results: query unique
            # ids, then re-expand
            uq, ucnt = np.unique(q, return_counts=True)
            fmem = self._mem_host_sorted(s)
            if fmem is None and not self._runs.resident_runs(s):
                # empty shard: nothing to dispatch — still observed
                self._h_shard_query[s].observe(perf_counter() - t_sh)
                continue
            r, c, v = self._runs.query_shard_fused(
                s, uq, mem_host=fmem, max_return=max_return,
                mem_sorted=True, q_tile=self.fused_q_limit,
                col_filter=col_filter)
            if len(r) and (ucnt > 1).any():
                rep = ucnt[np.searchsorted(uq, r)]
                r, c, v = np.repeat(r, rep), np.repeat(c, rep), np.repeat(v, rep)
            self._h_shard_query[s].observe(perf_counter() - t_sh)
            out.append((r, c, v))
        return out

    def _query_rows_single(self, row_ids, owner, max_return):
        owners = np.unique(owner)
        if self._mem_n[owners].max(initial=0) > 0:
            self.flush()
        out = []
        for s in owners:
            s = int(s)
            q = row_ids[owner == s]
            self._c_shard_query[s].inc(len(q))
            t_sh = perf_counter()
            t = self._shard_tablet(s)
            q_dev = torch.as_tensor(q, device=self.device)
            if self.use_pallas:  # one compacting read, one copy to the host
                from .lsm.engine import _to_host
                r, c, v = _to_host(tablet_read(t.rows, t.cols, t.vals, q_dev))
            else:  # the JAX engine's padded block, widened, then nonzero
                cols, vals, ok, cnt = tablet_query_rows(
                    t, q_dev, max_return, use_pallas=False)
                top = int(cnt.max())
                if top > max_return:  # widen (batch scanner)
                    cols, vals, ok, cnt = tablet_query_rows(
                        t, q_dev, top, use_pallas=False)
                qi, ki = torch.nonzero(ok, as_tuple=True)  # row-major order
                r = q[qi.cpu().numpy()]
                c = cols[qi, ki].cpu().numpy()
                v = vals[qi, ki].cpu().numpy()
            self._h_shard_query[s].observe(perf_counter() - t_sh)
            out.append((r, c, v))
        return out

    def scan_range(self, lo: int, hi: int, width: int = 64,
                   col_filter: np.ndarray = None):
        """Row-range scan: all (row, col, val) with ``lo <= row < hi``,
        sorted lex by (row, col) — each overlapping shard is answered by
        ONE fused fence-to-fence pass (``scan_shard_fused``) on the LSM
        engine; the legacy engine flushes the overlapping shards and slices
        each run between the endpoint ranks. ``col_filter`` restricts
        results to a column id set (on the device on the LSM engine, on
        the host on the legacy one)."""
        self._check_open()
        t_call = perf_counter()
        lo, hi = int(lo), int(hi)
        host_filter = None
        if col_filter is not None:
            col_filter = np.asarray(col_filter, np.int32)
            if self.engine != "lsm":
                host_filter, col_filter = col_filter, None
        out = []
        if hi > lo:
            s_lo = int(shard_of(np.asarray([lo]), self.S,
                                self.id_capacity)[0])
            s_hi = int(shard_of(np.asarray([max(hi - 1, lo)]), self.S,
                                self.id_capacity)[0])
            shards = range(s_lo, s_hi + 1)  # each shard clips the range
            if (self.engine != "lsm"
                    and self._mem_n[list(shards)].max(initial=0) > 0):
                self.flush()
            for s in shards:
                self._c_shard_scan[s].inc()
                t_sh = perf_counter()
                if self.engine == "lsm":
                    r, c, v = self._runs.scan_shard_fused(
                        s, lo, hi, mem_host=self._mem_host_sorted(s),
                        width=width, mem_sorted=True, col_filter=col_filter)
                else:  # legacy single run: slice between endpoint ranks
                    t = self._shard_tablet(s)
                    ends = torch.tensor([lo, hi], dtype=torch.int32,
                                        device=self.device)
                    a, b = torch.searchsorted(t.rows, ends).tolist()
                    r, c, v = (x[a:b].cpu().numpy()
                               for x in (t.rows, t.cols, t.vals))
                self._h_shard_scan[s].observe(perf_counter() - t_sh)
                if len(r):
                    out.append((r, c, v))
            self._h_scan.observe(perf_counter() - t_call)
        return _finish(out, host_filter)

    # ------------------------------------------------ column-axis reads
    def _require_sibling(self):
        if self.t_store is None:
            raise ValueError(
                f"table {self.name!r} has no transpose sibling "
                "(ShardedTable(transpose=True))")
        return self.t_store

    def query_cols(self, col_ids: np.ndarray, max_return: int = 256):
        """Point COLUMN queries via the transpose sibling: all
        (row, col, val) whose col is in ``col_ids``."""
        self._check_open()
        tr, tc, tv = self._require_sibling().query_rows(
            col_ids, max_return=max_return)
        return tc, tr, tv  # sibling rows ARE our cols (and vice versa)

    def scan_col_range(self, lo: int, hi: int, width: int = 64,
                       row_filter: np.ndarray = None):
        """Column-range scan ``lo <= col < hi`` via the transpose sibling's
        fused scan. Returns (rows, cols, vals) sorted lex by (col, row);
        ``row_filter`` pushes a residual row id set into the dispatch."""
        self._check_open()
        tr, tc, tv = self._require_sibling().scan_range(
            lo, hi, width=width, col_filter=row_filter)
        return tc, tr, tv  # sibling rows ARE our cols (and vice versa)

    def scan_shard(self, s: int):
        """One shard's combined sorted triples (LSM; no flush)."""
        self._check_open()
        if self.engine != "lsm":
            raise ValueError("scan_shard() requires engine='lsm'")
        return self._runs.scan_shard(s, mem_host=self._mem_host(s))

    def scan(self):
        """Full-table scan -> (row_ids, col_ids, vals), sorted per shard."""
        self._check_open()
        self._c_full_scans.inc()
        if self.engine == "lsm":
            return _finish([self.scan_shard(s) for s in range(self.S)])
        self.flush()
        t = self.tablets
        keep = (torch.arange(self.cap, device=self.device)[None, :]
                < t.n[:, None])
        return tuple(x[keep].cpu().numpy() for x in (t.rows, t.cols, t.vals))


def _finish(parts, host_filter: np.ndarray = None):
    """Concatenate per-shard (rows, cols, vals) results; ``host_filter``
    keeps only the columns in that id set."""
    if not parts:
        z = np.zeros(0, np.int32)
        return z, z.copy(), np.zeros(0, np.float32)
    r, c, v = (np.concatenate([p[i] for p in parts]) for i in range(3))
    if host_filter is not None:
        keep = np.isin(c, host_filter)
        r, c, v = r[keep], c[keep], v[keep]
    return r, c, v


def load_jax_tablets(store: ShardedTable, arrays: dict) -> None:
    """Load a JAX legacy-engine store's stacked ``Tablet`` arrays (numpy
    ``rows``, ``cols``, ``vals`` [S, cap] and ``n`` [S]) into the port's
    ``store`` (``engine="single"``, same shards and capacity). The
    memtable is left as it is."""
    store._check_open()
    if store.engine != "single":
        raise ValueError("load_jax_tablets() requires engine='single'")
    want = {"rows": (store.S, store.cap), "cols": (store.S, store.cap),
            "vals": (store.S, store.cap), "n": (store.S,)}
    for key, shape in want.items():
        got = np.shape(arrays.get(key))
        if got != shape:
            raise ValueError(f"tablet {key!r} has shape {got}, this store "
                             f"needs {shape}")
    dtypes = {"rows": torch.int32, "cols": torch.int32,
              "vals": torch.float32, "n": torch.int32}
    store.tablets = Tablet(**{   # copies: never alias the caller's arrays
        k: torch.tensor(np.asarray(arrays[k]), dtype=dt, device=store.device)
        for k, dt in dtypes.items()})
