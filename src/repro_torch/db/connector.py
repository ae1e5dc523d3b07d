"""The D4M.jl database connector API — paper Listing 1, verbatim workflow:

    dbinit()
    DB = dbsetup("mydb02", "db.conf")
    Tedge = DB["my_Tedge", "my_TedgeT"]     # table pair (auto-transpose)
    TedgeDeg = DB["my_TedgeDeg"]
    put(Tedge, A)
    Arow = Tedge["e1,", :]
    Acol = Tedge[:, "v1,"]
    delete(Tedge); delete(TedgeDeg)

The connector hides dictionary-encoding, fixed-capacity padding and
sharding behind the paper's API. Binding a pair creates ONE
engine-maintained transpose pair: ``put`` lands each batch in ``A`` and
``A^T``, and ``Tedge[:, "v1,"]`` compiles to a fence-bracketed range scan
or point read on the transpose sibling instead of an O(nnz)
full-scan-and-filter. Selectors compile to ``ReadPlan`` values
(``resolve_selector_plan``) that record axis, kind and routing for both the
row and the column dimension.

The stores live on ``device`` (default ``"cuda"``): ``dbsetup`` and
``DBserver`` take it as a keyword, apart from the config, so a config dict
means the same here and in the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.assoc import Assoc, split_str
from ..core.dictionary import StringDict
from ..kernels.common import resolve_device
from ..obs import Histogram, default_registry, default_tracer
from ..obs import span as obs_span
from ..obs.export import write_debug_bundle
from . import batching
from .kvstore import ShardedTable, StoreConfig

_INITIALIZED = False


def _sel_is_all(sel) -> bool:
    """Is this selector the unconstrained axis (``:`` / ``None`` /
    ``slice(None)``)? The ONE place this check lives — every consumer
    goes through ``resolve_selector_plan``."""
    if sel is None:
        return True
    if isinstance(sel, str):
        return sel == ":"
    return isinstance(sel, slice) and sel == slice(None)


@dataclasses.dataclass(frozen=True)
class ReadPlan:
    """A compiled selector for ONE axis of a D4M read.

    ``resolve_selector_plan`` produces these for rows AND columns alike;
    only the *execution* differs (``route``): a column plan executes
    natively as a residual filter on a row-driven read, or routes to the
    transpose sibling when the store maintains one.

    Fields (unused ones stay None):

    * ``axis``  — "row" | "col": which axis the selector constrains
    * ``kind``  — "all" (unconstrained), "ids" (point id set), or
      "range" (contiguous id range [lo, hi))
    * ``ids``   — kind="ids": sorted unique int32 ids to point-query
    * ``lo, hi``— kind="range": the id range endpoints
    * ``filter``— kind="range" with dict-absent holes: the sorted id
      subset actually selected (scan the dense superset, keep these)
    * ``route`` — "native" | "transpose": set at execution time
    """
    axis: str = "row"
    kind: str = "all"
    ids: Optional[np.ndarray] = None
    lo: Optional[int] = None
    hi: Optional[int] = None
    filter: Optional[np.ndarray] = None
    route: str = "native"

    def with_route(self, route: str) -> "ReadPlan":
        return dataclasses.replace(self, route=route)

    def filter_ids(self) -> Optional[np.ndarray]:
        """The id set this plan keeps (for residual-filter use): ``ids``
        for point plans, ``filter`` (or the dense [lo, hi) range) for
        range plans, None for "all" (keeps everything)."""
        if self.kind == "all":
            return None
        if self.kind == "ids":
            return self.ids
        return (self.filter if self.filter is not None
                else np.arange(self.lo, self.hi, dtype=np.int32))


def dbinit() -> None:
    """JVM-init analogue: bring up the CUDA runtime once per process (where
    there is a card)."""
    global _INITIALIZED
    if not _INITIALIZED:
        if torch.cuda.is_available():
            torch.cuda.init()
        _INITIALIZED = True


def dbsetup(instance: str, conf: Optional[dict] = None,
            device: Union[str, torch.device] = "cuda", **kw) -> "DBserver":
    """Create a server binding (conf dict stands in for db.conf).

    The engine/topology keys of ``conf`` build ONE ``StoreConfig`` here;
    every table the server binds shares that record by reference.
    ``device`` holds every table's state."""
    dbinit()
    cfg = dict(conf or {})
    cfg.update(kw)
    char_budget = cfg.pop("char_budget", batching.DEFAULT_CHAR_BUDGET)
    if cfg.pop("wal_root", None) is not None:
        raise NotImplementedError(
            "wal_root is not ported yet: see ROADMAP.md, Queue 1 item 5 "
            "(durability)")
    config = cfg.pop("config", None)
    if config is None:
        config = StoreConfig(**cfg)
    elif cfg:
        config = config.replace(**cfg)
    return DBserver(instance, config=config, char_budget=char_budget,
                    device=device)


class DBserver:
    """Connection holder; indexing binds tables (creating them on demand).

    ``config`` (a ``kvstore.StoreConfig``) is the single source of truth
    for engine/topology settings; the per-field attributes (``num_shards``,
    ``engine``, ...) are read-only views of it. Extra keyword arguments
    override config fields. ``device`` (default ``"cuda"``) holds every
    bound table; without a card, construction raises unless
    ``device="cpu"`` is given."""

    def __init__(self, instance: str, config: StoreConfig = None,
                 char_budget: int = batching.DEFAULT_CHAR_BUDGET,
                 device: Union[str, torch.device] = "cuda", **kw):
        cfg = config if config is not None else StoreConfig()
        if kw:
            cfg = cfg.replace(**kw)  # unknown keys raise
        if cfg.num_shards * cfg.id_capacity >= 2 ** 31:
            raise ValueError("id space must fit int32 routing")
        self.device = resolve_device(device)
        self.instance = instance
        self.config = cfg
        self.char_budget = char_budget
        self.keydict = StringDict()          # shared row/col key universe
        self._sorted_keys: Optional[np.ndarray] = None
        self.tables: dict = {}

    # read-only views of the shared StoreConfig
    num_shards = property(lambda self: self.config.num_shards)
    capacity_per_shard = property(lambda self: self.config.capacity_per_shard)
    batch_cap = property(lambda self: self.config.batch_cap)
    id_capacity = property(lambda self: self.config.id_capacity)
    use_pallas = property(lambda self: self.config.use_pallas)
    engine = property(lambda self: self.config.engine)
    fused_reads = property(lambda self: self.config.fused_reads)
    fused_q_limit = property(lambda self: self.config.fused_q_limit)
    l0_slots = property(lambda self: self.config.l0_slots)
    fanout = property(lambda self: self.config.fanout)

    # ------------------------------------------------------------- binding
    def __getitem__(self, names: Union[str, Tuple[str, str]]):
        if isinstance(names, tuple):
            t, tt = names
            return self._bind_pair(t, tt)
        return self._bind(names)

    def _bind(self, name: str) -> "Table":
        if name not in self.tables:
            self.tables[name] = Table(self, name)
        return self.tables[name]

    def _bind_pair(self, t: str, tt: str) -> "TablePair":
        """Bind ``DB[t, tt]``: ONE transpose-enabled store (the engine
        maintains ``A^T`` as a sibling shard set), with ``tt`` bound as a
        read-facing transposed view of it."""
        tbl = self.tables.get(t)
        if tbl is None:
            tbl = Table(self, t, transpose=True)
            self.tables[t] = tbl
        elif getattr(getattr(tbl, "store", None), "t_store", None) is None:
            raise ValueError(
                f"table {t!r} is already bound without a transpose "
                "sibling; delete it before re-binding as a pair")
        view = self.tables.get(tt)
        if not isinstance(view, TransposedView):
            view = TransposedView(tbl, tt)
            self.tables[tt] = view
        return TablePair(tbl, view)

    def ls(self):
        return sorted(self.tables)

    def drop(self, name: str) -> None:
        """Unbind a table AND release its store buffers."""
        t = self.tables.pop(name, None)
        if isinstance(t, Table) and not t._deleted:
            t._mark_deleted()

    # ----------------------------------------------------- key resolution
    def encode_keys(self, strs: np.ndarray) -> np.ndarray:
        ids = self.keydict.encode(strs)
        if ids.size and ids.max() >= self.id_capacity:
            raise OverflowError("key universe exceeded id_capacity")
        self._sorted_keys = None  # invalidate range-query snapshot
        return ids

    def _snapshot(self):
        if self._sorted_keys is None or len(self._sorted_keys) != len(self.keydict):
            keys = self.keydict.decode(np.arange(len(self.keydict)))
            order = np.argsort(keys)
            self._sorted_keys = keys[order]
            self._sorted_ids = np.arange(len(keys), dtype=np.int32)[order]
        return self._sorted_keys, self._sorted_ids

    def _span_ids(self, lo_key: str, hi_key: str) -> np.ndarray:
        """Sorted dict ids of every key in the STRING range
        [lo_key, hi_key] (both inclusive — the one searchsorted span both
        the range and prefix selectors reduce to)."""
        skeys, sids = self._snapshot()
        lo = np.searchsorted(skeys, lo_key, side="left")
        hi = np.searchsorted(skeys, hi_key, side="right")
        return np.sort(sids[lo:hi]).astype(np.int32)

    def _point_ids(self, toks) -> np.ndarray:
        """Expand explicit key tokens (and ``prefix*`` tokens) to the
        sorted unique id set present in the dictionary."""
        out = []
        for t in toks:
            if t.endswith("*"):
                out.append(self._span_ids(t[:-1], t[:-1] + "￿"))
            else:
                i = self.keydict.get(t)
                if i >= 0:
                    out.append(np.asarray([i], dtype=np.int32))
        if not out:
            return np.zeros(0, dtype=np.int32)
        return np.unique(np.concatenate(out))

    # a dict-range id set denser than this scans the covering id range in
    # one fused dispatch and filters the stragglers on the host; sparser
    # sets fall back to batched point queries
    RANGE_SCAN_DENSITY = 0.5

    def resolve_selector_plan(self, sel, axis: str = "row") -> ReadPlan:
        """D4M selector -> ``ReadPlan``, WITHOUT materializing an id list
        when a server-side range scan can serve it.

        The plan's ``kind`` is "all" (unconstrained axis), "ids" (point
        queries over an explicit id set), or "range" ([lo, hi) id-range
        scan, with ``filter`` carrying the dict-present subset when the
        string range has id holes denser than ``RANGE_SCAN_DENSITY``).
        The SAME compilation serves both axes (rows and columns share one
        key dictionary). Range/prefix selectors map through the key
        dictionary's sorted-key snapshot: the matching ids are contiguous
        whenever keys were interned in lexicographic order.
        """
        if _sel_is_all(sel):
            return ReadPlan(axis=axis, kind="all")
        toks = split_str(sel) if isinstance(sel, str) else np.asarray(
            [str(t) for t in np.asarray(sel).ravel()], dtype=object)
        span_ids = None
        if len(toks) == 3 and toks[1] == ":":
            span_ids = self._span_ids(toks[0], toks[2])
        elif len(toks) == 1 and toks[0].endswith("*"):
            span_ids = self._span_ids(toks[0][:-1], toks[0][:-1] + "￿")
        if span_ids is None:
            return ReadPlan(axis=axis, kind="ids", ids=self._point_ids(toks))
        if len(span_ids) == 0:
            return ReadPlan(axis=axis, kind="ids", ids=span_ids)
        lo_id, hi_id = int(span_ids[0]), int(span_ids[-1]) + 1
        span = hi_id - lo_id
        if span == len(span_ids):
            return ReadPlan(axis=axis, kind="range", lo=lo_id, hi=hi_id)
        if len(span_ids) >= self.RANGE_SCAN_DENSITY * span:
            return ReadPlan(axis=axis, kind="range", lo=lo_id, hi=hi_id,
                            filter=span_ids)
        return ReadPlan(axis=axis, kind="ids", ids=span_ids)

    # -------------------------------------------------------- observability
    # per-op latency histograms emitted by ShardedTable / LSMRuns
    _METRIC_OPS = ("ingest", "query", "scan", "flush", "major_compaction")

    def metrics(self) -> dict:
        """Aggregated observability snapshot of every live bound table:
        per-shard and per-table counters, per-op latency percentiles,
        derived health gauges, plus a cross-table aggregate. JSON-ready.
        The ``wal`` sections keep the JAX package's schema and read zero
        (the port has no WAL yet)."""
        for name, t in self.tables.items():
            store = getattr(t, "store", None)
            if store is not None and not store._closed:
                store.refresh_health_gauges()
        reg = default_registry()

        def gauge_val(name, **labels):
            insts = reg.series(name, **labels)
            return insts[0].value if insts else 0

        def pooled(name, tables, **extra):
            h = Histogram(reg, name, {})
            for t in tables:
                key = "table" if not name.startswith("wal_") else "log"
                for inst in reg.series(name, **{key: t}, **extra):
                    h.merge(inst)
            return h.snapshot()

        def ctr_sum(name, tables, **extra):
            key = "table" if not name.startswith("wal_") else "log"
            return sum(sum(c.value for c in reg.series(name, **{key: t},
                                                       **extra))
                       for t in tables)

        live = [n for n, t in self.tables.items()
                if getattr(t, "store", None) is not None
                and not t.store._closed]
        out = {"instance": self.instance, "num_shards": self.num_shards,
               "tables": {}, "aggregate": {}}
        for name in live:
            store = self.tables[name].store
            tbl = {"engine": store.engine,
                   "counters": store.engine_stats(),
                   "latency_s": {op: pooled("db_op_latency_s", [name], op=op)
                                 for op in self._METRIC_OPS},
                   "wal": {
                       "appends": ctr_sum("wal_appends", [name]),
                       "append_bytes": ctr_sum("wal_append_bytes", [name]),
                       "fsyncs": ctr_sum("wal_fsyncs", [name]),
                       "replay_batches": ctr_sum("wal_replay_batches",
                                                 [name]),
                       "append_s": pooled("wal_latency_s", [name],
                                          op="append"),
                       "fsync_s": pooled("wal_latency_s", [name],
                                         op="fsync"),
                       "backlog_bytes": gauge_val("wal_backlog_bytes",
                                                  log=name),
                   },
                   "health": {
                       "read_amplification": gauge_val(
                           "lsm_read_amplification", table=name),
                       "write_amplification": gauge_val(
                           "lsm_write_amplification", table=name),
                       "retraces": ctr_sum("lsm_retraces", [name]),
                       "compiled_shapes": sum(
                           g.value for g in
                           reg.series("lsm_compiled_shapes")),
                   },
                   "shards": {}}
            for s in range(store.S):
                tbl["shards"][str(s)] = {
                    "memtable_occupancy": gauge_val(
                        "db_memtable_occupancy", table=name, shard=s),
                    "resident_runs": gauge_val("lsm_resident_runs",
                                               table=name, shard=s),
                    "compaction_debt_entries": gauge_val(
                        "lsm_compaction_debt_entries", table=name, shard=s),
                    "ingest_entries": ctr_sum("db_ingest_entries", [name],
                                              shard=s),
                    "point_queries": ctr_sum("db_point_queries", [name],
                                             shard=s),
                    "range_scans": ctr_sum("db_range_scans", [name],
                                           shard=s),
                    "flushes": ctr_sum("lsm_shard_flushes", [name], shard=s),
                    "compactions": ctr_sum("lsm_shard_compactions", [name],
                                           shard=s),
                    "query_s": pooled("db_shard_op_latency_s", [name],
                                      shard=s, op="query"),
                    "scan_s": pooled("db_shard_op_latency_s", [name],
                                     shard=s, op="scan"),
                }
            if getattr(store, "t_store", None) is not None:
                tbl["transpose"] = {
                    "sibling": store.t_store.name,
                    "counters": store.t_store.engine_stats(),
                }
            out["tables"][name] = tbl
        agg_counters: dict = {}
        for name in live:
            for k, v in out["tables"][name]["counters"].items():
                if isinstance(v, (int, float)):
                    agg_counters[k] = agg_counters.get(k, 0) + v
        out["aggregate"] = {
            "counters": agg_counters,
            "latency_s": {op: pooled("db_op_latency_s", live, op=op)
                          for op in self._METRIC_OPS},
            "wal": {"appends": ctr_sum("wal_appends", live),
                    "append_bytes": ctr_sum("wal_append_bytes", live),
                    "fsyncs": ctr_sum("wal_fsyncs", live),
                    "fsync_s": pooled("wal_latency_s", live, op="fsync")},
        }
        return out

    def dump_metrics(self, path: str) -> dict:
        """Write ``metrics()`` to ``path`` as JSON; returns the snapshot."""
        snap = self.metrics()
        with open(path, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        return snap

    def debug_bundle(self, path: str, bloom_probes: int = 256) -> str:
        """One-stop diagnostic archive (zip): raw registry snapshot +
        Prometheus exposition + slow traces, plus the store config, each
        table's resident geometry and the aggregated ``metrics()`` view.
        Health gauges (incl. the bloom fp probe) are refreshed first.
        Returns ``path``."""
        geometry = {}
        for name, t in self.tables.items():
            store = getattr(t, "store", None)
            if store is None or store._closed:
                continue
            store.refresh_health_gauges(bloom_probes=bloom_probes)
            geo = {"engine": store.engine,
                   "num_shards": store.S,
                   "memtable_cap": store.mem_cap,
                   "memtable_n": [int(x) for x in store._mem_n],
                   "stats": store.engine_stats()}
            if store.engine == "lsm":
                runs = store._runs
                geo["level_caps"] = list(runs.level_caps)
                geo["l0_slots"] = runs.K0
                geo["resident_runs"] = [runs.resident_runs(s)
                                        for s in range(store.S)]
                geo["level_entries_per_shard"] = [
                    [int(n) for n in lv["n"]] for lv in runs.levels]
            geometry[name] = geo
        extra = {
            "store_config": dataclasses.asdict(self.config),
            "device": str(self.device),
            "resident_geometry": geometry,
            "metrics_view": self.metrics(),
        }
        return write_debug_bundle(path, reg=default_registry(),
                                  tracer=default_tracer(), extra=extra)


class Table:
    """A bound table: ingest Assocs/triples, query with Assoc syntax."""

    def __init__(self, server: DBserver, name: str, combiner: str = "last",
                 transpose: bool = False):
        self.server = server
        self.name = name
        cfg = server.config
        if transpose:
            cfg = cfg.replace(transpose=True)
        self.store = ShardedTable(name, combiner=combiner, config=cfg,
                                  device=server.device)
        self.valdict: Optional[StringDict] = None  # set on first string put
        self._deleted = False

    def _check_live(self) -> None:
        if self._deleted:
            raise RuntimeError(
                f"table {self.name!r} was deleted; re-bind via DB[name]")

    def _mark_deleted(self) -> None:
        """delete(): free the store's buffers and poison this handle."""
        if self._deleted:
            return
        self._deleted = True
        self.store.close()

    def nnz(self) -> int:
        self._check_live()
        return self.store.nnz()

    # -------------------------------------------------------------- ingest
    def put(self, a: Assoc) -> None:
        r, c, v = a.triples()
        self.put_triple(r, c, v)

    def put_triple(self, rows, cols, vals) -> None:
        self._check_live()
        rows = np.asarray(rows, dtype=object)
        cols = np.asarray(cols, dtype=object)
        vals = np.asarray(vals)
        # connector-level root span: every batch (dict encode, memtable
        # insert, any flush/compaction) shares ONE trace id
        with obs_span("connector.put", table=self.name, n=len(rows)):
            self._put_triple_batches(rows, cols, vals)

    def _put_triple_batches(self, rows, cols, vals) -> None:
        for br, bc, bv in batching.batch_triples(rows, cols, vals,
                                                 self.server.char_budget):
            rid = self.server.encode_keys(br)
            cid = self.server.encode_keys(bc)
            if bv.dtype.kind in "OUS":
                if self.valdict is None:
                    self.valdict = StringDict()
                val = self.valdict.encode(bv.astype(object)).astype(np.float32) + 1.0
            else:
                val = bv.astype(np.float32)
            self.store.insert(rid, cid, val)

    putTriple = put_triple

    # --------------------------------------------------------------- query
    def _assemble(self, rid, cid, val) -> Assoc:
        if len(rid) == 0:
            return Assoc()
        rows = self.server.keydict.decode(rid)
        cols = self.server.keydict.decode(cid)
        if self.valdict is not None:
            vals = self.valdict.decode(val.astype(np.int64) - 1)
        else:
            vals = val.astype(np.float64)
        return Assoc(rows, cols, vals)

    def __getitem__(self, key) -> Assoc:
        self._check_live()
        rsel, csel = key
        rplan = self.server.resolve_selector_plan(rsel, axis="row")
        cplan = self.server.resolve_selector_plan(csel, axis="col")
        r, c, v = self._execute(rplan, cplan)
        return self._assemble(r, c, v)

    def _execute(self, rplan: ReadPlan, cplan: ReadPlan):
        with obs_span("connector.read", table=self.name,
                      row_kind=rplan.kind, col_kind=cplan.kind):
            return self._execute_plans(rplan, cplan)

    def _execute_plans(self, rplan: ReadPlan, cplan: ReadPlan):
        """Run a (row-plan, col-plan) pair against the store.

        * unconstrained rows + constrained cols on a pair table → route
          the column plan to the transpose sibling's fused scan/query;
        * otherwise the row plan drives the dispatch and the column
          plan's id set pushes down as an on-device residual filter
          (``col_filter``) inside the fused reads.
        """
        store = self.store
        if (rplan.kind == "all" and cplan.kind != "all"
                and getattr(store, "t_store", None) is not None):
            cplan = cplan.with_route("transpose")
            if cplan.kind == "range":
                r, c, v = store.scan_col_range(cplan.lo, cplan.hi)
                if cplan.filter is not None:  # dict-absent id holes
                    keep = np.isin(c, cplan.filter)
                    r, c, v = r[keep], c[keep], v[keep]
            else:
                r, c, v = store.query_cols(cplan.ids)
            return r, c, v
        cfilt = cplan.filter_ids()  # pushed into the fused dispatch
        if rplan.kind == "range":  # contiguous rows: ONE scan per shard
            r, c, v = store.scan_range(rplan.lo, rplan.hi, col_filter=cfilt)
            if rplan.filter is not None:  # dense superset: drop absents
                keep = np.isin(r, rplan.filter)
                r, c, v = r[keep], c[keep], v[keep]
            return r, c, v
        if rplan.kind == "ids":
            return store.query_rows(rplan.ids, col_filter=cfilt)
        r, c, v = store.scan()  # full scan; filter columns client-side
        if cfilt is not None:
            keep = np.isin(c, cfilt)
            r, c, v = r[keep], c[keep], v[keep]
        return r, c, v


class TransposedView:
    """Read/write-facing ``A^T`` binding over a pair table.

    The second name of ``DB["my_Tedge", "my_TedgeT"]`` is a VIEW of the
    first — the engine already maintains the transpose sibling shard set,
    so the view swaps selectors (and transposes results) rather than owning
    storage. ``store`` is None on purpose: server bookkeeping skips views
    and reports the pair once, under the primary's name."""

    store = None

    def __init__(self, table: Table, name: str):
        self.table = table
        self.name = name

    @property
    def _deleted(self) -> bool:
        return self.table._deleted

    def nnz(self) -> int:
        return self.table.nnz()

    def put(self, a: Assoc) -> None:
        self.table.put(a.transpose())

    def put_triple(self, rows, cols, vals) -> None:
        self.table.put_triple(cols, rows, vals)

    putTriple = put_triple

    def __getitem__(self, key) -> Assoc:
        rsel, csel = key
        return self.table[csel, rsel].transpose()


class TablePair:
    """Edge table + its transpose; column queries auto-route to the
    transpose sibling 'for speed' (paper §III-B). Ingest and queries go to
    the primary table, whose ``_execute`` routes column plans."""

    def __init__(self, table: Table, table_t: TransposedView):
        self.table = table
        self.table_t = table_t

    @property
    def name(self) -> str:
        return self.table.name

    @property
    def name_t(self) -> str:
        return self.table_t.name

    def nnz(self) -> int:
        return self.table.nnz()

    def put(self, a: Assoc) -> None:
        self.table.put(a)  # the engine dual-ingests

    def put_triple(self, rows, cols, vals) -> None:
        self.table.put_triple(rows, cols, vals)

    putTriple = put_triple

    def metrics(self) -> dict:
        """This pair's slice of ``server.metrics()`` (primary table entry,
        which carries the sibling under ``"transpose"``)."""
        snap = self.table.server.metrics()
        return snap["tables"].get(self.table.name, {})

    def __getitem__(self, key) -> Assoc:
        return self.table[key]


def put(table, a: Assoc) -> None:
    table.put(a)


def putTriple(table, rows, cols, vals) -> None:
    table.put_triple(rows, cols, vals)


def delete(table) -> None:
    """Drop a table (or pair) from its server AND release its storage.

    The bound handle is poisoned: subsequent put/__getitem__/nnz raise
    RuntimeError. Re-binding the same name via ``DB[name]`` creates a fresh
    table. Deleting a pair drops BOTH bindings; the sibling shard set is
    freed by the primary store's close (it owns the sibling).
    """
    if isinstance(table, TablePair):
        server = table.table.server
        server.drop(table.table_t.name)  # view: pop only (no store)
        server.drop(table.table.name)    # closes primary + sibling
        return
    table.server.drop(table.name)
    table._mark_deleted()  # idempotent if drop() already closed it
