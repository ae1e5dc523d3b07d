"""The system under test for the D4M configurations: the port's connector
(``repro_torch.db``) over its store, set up as a configuration file says,
driven by one traffic mix, and judged against ``d4m_reference``.

A configuration names its edge ``generator`` (``generators/<name>.py``),
the server's settings (``server``: every key goes to ``dbsetup`` as it
stands, ``capacity_per_shard`` worked out from the data where the file does
not give it) and its ``schema``: ``"d4m2"`` binds the D4M 2.0 bundle
(``EdgeSchema``: ``Tedge``, ``TedgeT``, ``TedgeDeg``), ``"listing1"`` the
paper's Listing-1 pair (``DB["Tedge", "TedgeT"]``). ``durability.wal`` turns
on the port's write-ahead log and dictionary journals under the run's
``TMPDIR``; the pair is then checkpointed once while empty, so that
``recover_connector`` finds its manifest and replays the whole log.

The traffic's handlers (``ops/*.py``) act on a ``Cell`` through
``request`` / ``put``, ``read``, ``warm_puts`` / ``warm_reads``,
``numbers`` and ``reference``.
"""
from __future__ import annotations

import importlib
import shutil
import tempfile
from typing import Iterator

import numpy as np
import torch

from ..graphs import name_index, vertex_names
from ..traffic import Traffic
from .d4m_reference import EdgeReference

ENTRY_BYTES = 12  # int32 row, int32 col, float32 value


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def capacity_per_shard(graphs, num_shards: int, id_capacity: int,
                       headroom: float) -> int:
    """Room for every distinct entry the run can put, on its fullest shard,
    for the rows (``Tedge``) and the columns (``TedgeT``), times
    ``headroom``: the sizing of the port's Listing-1 smoke test. Vertex
    numbers are the key ids, since set-up interns the sorted key universe
    first."""
    key = torch.unique(torch.cat([(u << 32) | v for u, v in graphs]))
    most = 0
    for ids in (key >> 32, key & ((1 << 32) - 1)):
        shard = torch.clamp(ids * num_shards // id_capacity, max=num_shards - 1)
        most = max(most, int(torch.bincount(shard, minlength=num_shards).max()))
    return max(1 << 12, int(most * headroom))


class Cell:
    """Set-up of one cell: the data from the seed, the server, the preload
    and the traffic's warm-up. ``ops()`` then yields the client's
    operations, ``spans()`` the points a traced run times, ``check()`` the
    comparison."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device: str):
        from repro_torch.db import EdgeSchema, dbsetup

        self.device = dev = torch.device(device)
        server = dict(cfg["server"])
        edges = importlib.import_module(
            f"portbench.generators.{cfg['generator']}")
        n = edges.vertices(cfg)
        self.num_shards = server["num_shards"]
        self.id_capacity = server["id_capacity"]
        if self.id_capacity < n:
            raise ValueError("id_capacity holds fewer ids than vertices")
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        dev_graphs = [edges.edges(cfg, gen, dev)
                      for _ in range(mix["graphs"])]
        if "capacity_per_shard" not in server:
            server["capacity_per_shard"] = capacity_per_shard(
                dev_graphs, self.num_shards, self.id_capacity,
                cfg["capacity_headroom"])
        # a triple's value is its place in its graph, 1..m: exact in
        # float32, never 0, and unequal between duplicates, so a store that
        # keeps another duplicate than the last shows
        self.graphs = []
        for u, v in dev_graphs:
            vals = np.arange(1, len(u) + 1, dtype=np.float32)
            self.graphs.append((u.cpu().numpy(), v.cpu().numpy(), vals))
        del dev_graphs
        # the peak the run reports is the program's: set-up's own data
        # arrays and sort temporaries are gone from the card by now
        _free(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        self.names = vertex_names(n)
        self.acked = []  # (graph, lo, hi) of every put, in order
        self._ref = (None, None)

        wal = cfg["durability"]
        self.wal_root = (tempfile.mkdtemp(prefix="portbench-wal-")
                         if wal["wal"] else None)
        self.server = dbsetup(cfg["name"], device=dev,
                              wal_root=self.wal_root, **server)
        # the sorted key universe first (a sorted bulk load): a vertex's id
        # is its number, and a key range is an id range the store scans
        ids = self.server.encode_keys(self.names)
        if not np.array_equal(ids, np.arange(n)):
            raise ValueError("the vertex keys did not take their numbers "
                             "as ids")
        if cfg["schema"] == "d4m2":
            self.schema = EdgeSchema(self.server, "g500")
            self.pair = self.schema.pair
            self.table = self.schema
        elif cfg["schema"] == "listing1":
            self.schema = None
            self.pair = self.server["Tedge", "TedgeT"]
            self.table = self.pair
        else:
            raise ValueError(f"unknown schema {cfg['schema']!r}")
        self.store = self.pair.table.store
        if self.wal_root is not None:
            if self.store._wal.sync != wal["sync"]:
                raise ValueError("the WAL's sync policy is not the "
                                 "configuration's")
            self.pair.checkpoint()

        self._preload(mix.get("preload", 0), server["batch_cap"])
        self.traffic = Traffic(mix, self, seed)
        self.traffic.warm()
        _sync(dev)

    def _preload(self, graphs: int, step: int) -> None:
        """Set-up's bulk load of the first ``graphs`` graphs, ``step``
        triples an insert, straight into the store's batch writer
        (``ShardedTable.insert``: the WAL, both sides of the pair, flushes
        and compactions) and the degree table. Every key was interned
        before, with its vertex number as its id, so this skips only the
        connector's encoding of strings, which the window's puts time."""
        for g in range(graphs):
            u, v, val = self.graphs[g]
            for lo in range(0, len(u), step):
                hi = min(lo + step, len(u))
                self.store.insert(u[lo:hi], v[lo:hi], val[lo:hi])
                if self.schema is not None:
                    self.schema.deg.update(u[lo:hi], v[lo:hi])
                self.acked.append((g, lo, hi))

    # ------------------------------------------------------ for the ops
    def request(self, g, lo, hi):
        """A put's request: the keys of graph ``g``'s triples lo..hi."""
        u, v, val = self.graphs[g]
        return (self.names[u[lo:hi]], self.names[v[lo:hi]], val[lo:hi],
                (g, lo, hi))

    def put(self, rows, cols, vals, span) -> int:
        self.table.put_triple(rows, cols, vals)
        self.acked.append(span)
        return len(rows)

    def read(self, key):
        return self.table[key]

    def warm_puts(self) -> None:
        self.store.warmup()

    def warm_reads(self) -> None:
        self.store.warm_reads()

    def ops(self) -> Iterator[tuple]:
        """(kind, tag, call): ``call()`` runs one operation and returns the
        entries it put or read."""
        return self.traffic.ops()

    def spans(self) -> list:
        """(label, object, attribute, counter) of the calls a traced run
        times: the connector's encode and planning, the schema's degree
        upkeep, the store's insert and reads, the WAL append, and the
        engine's flush and compaction, which count the bytes they merge."""
        server, store, table = self.server, self.store, self.pair.table
        out = [("connector.encode", server, "encode_keys", None),
               ("connector.plan", server, "resolve_selector_plan", None),
               ("connector.execute", table, "_execute_plans", None),
               ("connector.assemble", table, "_assemble", None),
               ("store.insert", store, "insert", None)]
        out += [("store.read", store, name, None)
                for name in ("query_rows", "query_cols", "scan_range",
                             "scan_col_range", "scan")]
        if self.schema is not None:
            out += [("pair.put", self.pair, "put_triple", None),
                    ("schema.degree_update", self.schema.deg, "update", None)]
        if store._wal is not None:
            out.append(("wal.append", store._wal, "append", None))
        for owner in (store, store.t_store):
            runs = owner._runs
            out.append(("lsm.flush", runs, "flush_memtable",
                        _flush_bytes(owner)))
            out.append(("lsm.compaction", runs, "_major_compact",
                        _compaction_bytes(runs)))
        return out

    # ------------------------------------------------------------- check
    def check(self) -> dict:
        """{name: (value, limit)} of the comparison with the reference,
        after the window. The program's outputs go to the host first, its
        state is freed, then the reference runs."""
        from repro_torch.db import delete, recover_connector

        # made only now: the window's heap holds the program's and as
        # little of the harness's as it can
        self.name_ids = name_index(self.names)
        got = {}
        if "put" in self.traffic.kinds:
            got["tedge"] = self._contents(self.server, self.store)
            got["tedget"] = self._contents(self.server, self.store.t_store)
            if self.schema is not None:
                got["degree"] = self._degrees()
        self.traffic.collect()
        names = (self.pair.name, self.pair.name_t)
        if self.schema is not None:
            self.schema.delete()
        else:
            delete(self.pair)
        self.server = self.store = self.pair = self.table = self.schema = None
        _free(self.device)

        checks = {}
        ref = self.reference(len(self.acked))
        if "tedge" in got:
            checks["tedge_wrong"] = (ref.table_wrong(*got["tedge"]), 0)
            checks["tedget_wrong"] = (ref.table_wrong(*got["tedget"],
                                                      transpose=True), 0)
        if "degree" in got:
            out, ind, stray = got["degree"]
            checks["degree_wrong"] = (ref.degree_wrong(out, ind) + stray, 0)
        checks.update(self.traffic.judge())
        if self.wal_root is not None:
            server, pair = recover_connector(self.wal_root, names,
                                             device=self.device)
            store = pair.table.store
            ref = self.reference(len(self.acked))
            wrong = (ref.table_wrong(*self._contents(server, store))
                     + ref.table_wrong(*self._contents(server, store.t_store),
                                       transpose=True))
            delete(pair)
            checks["recovered_wrong"] = (wrong, 0)
        return checks

    def reference(self, k: int) -> EdgeReference:
        """The reference after the first ``k`` acknowledged puts (the
        last one asked for is kept)."""
        if self._ref[0] != k:
            self._ref = (None, None)
            parts = [(self.graphs[g][0][lo:hi], self.graphs[g][1][lo:hi],
                      self.graphs[g][2][lo:hi])
                     for g, lo, hi in self.acked[:k]]
            cat = [torch.as_tensor(np.concatenate([p[i] for p in parts]),
                                   device=self.device) for i in range(3)]
            self._ref = (k, EdgeReference(*cat, n_vertices=len(self.names)))
        return self._ref[1]

    def _id_numbers(self, server) -> np.ndarray:
        """The vertex number behind each id of the program's dictionary
        (-1 for a key that is no vertex's)."""
        keys = server.keydict.decode(np.arange(len(server.keydict)))
        return np.fromiter((self.name_ids.get(k, -1) for k in keys),
                           np.int64, len(keys))

    def numbers(self, rows, cols, vals):
        """An answer's keys as vertex numbers (-1 for a key that is no
        vertex's)."""
        get = self.name_ids.get
        return (np.fromiter((get(k, -1) for k in rows), np.int64, len(rows)),
                np.fromiter((get(k, -1) for k in cols), np.int64, len(cols)),
                np.asarray(vals))

    def _contents(self, server, store):
        """A table's every entry as vertex numbers, through the engine's
        full scan and the connector's dictionary (the transpose sibling's
        rows are the table's columns)."""
        nums = self._id_numbers(server)
        r, c, v = store.scan()
        return nums[r], nums[c], v

    def _degrees(self):
        nums = self._id_numbers(self.server)
        state = self.schema.deg.state_arrays()
        out = np.zeros(len(self.names), np.int64)
        ind = np.zeros(len(self.names), np.int64)
        k = len(nums)
        out[nums] = state["out_deg"][:k]
        ind[nums] = state["in_deg"][:k]
        # a degree under an id the dictionary never gave is a wrong one
        stray = (state["out_deg"][k:] != 0) | (state["in_deg"][k:] != 0)
        return out, ind, int(stray.sum())

    def close(self) -> None:
        if self.wal_root is not None:
            shutil.rmtree(self.wal_root, ignore_errors=True)


def _free(device: torch.device) -> None:
    _sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _flush_bytes(owner):
    """Counter for a flush: the memtable's entries read once, the L0 run's
    written once (the engine's ``lsm_flush_entries``)."""
    runs = owner._runs

    def before(*args, **kw):
        return (int(np.minimum(owner._mem_n, owner.mem_cap).sum()),
                runs._c_flush_entries.value)

    def after(tok):
        n_in, out0 = tok
        return ENTRY_BYTES * (n_in + runs._c_flush_entries.value - out0)
    return before, after


def _compaction_bytes(runs):
    """Counter for a major compaction: the entries of the runs it merges
    (L0 and levels down to the target) read once, the target's written
    once."""
    def before(mask):
        mask = np.asarray(mask, bool)
        d = runs._pick_depth(mask)
        n_in = int(runs.l0_n[mask].sum()) + sum(
            int(runs.levels[i]["n"][mask].sum()) for i in range(d + 1))
        return n_in, runs._c_compact_entries.value

    def after(tok):
        n_in, out0 = tok
        return ENTRY_BYTES * (n_in + runs._c_compact_entries.value - out0)
    return before, after
