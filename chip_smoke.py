#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Drives the paper's Listing-1 database path through the connector a user
calls — ``dbsetup`` → bind the ``Tedge``/``TedgeT`` pair → ``put`` →
row, column and range reads → ``delete`` — on a Graph500 graph, then the
D4M 2.0 schema with its degree table and the Fig. 4 reads, the legacy
single-run engine, and Graphulo's SpMV; builds the hand-written CUDA
kernels from ``src/repro_torch/csrc``, shows that each path launched its
kernels, and holds each kernel against its plain PyTorch version at the
path's shapes.

    python3 chip_smoke.py [--seed N] [--scale S] [--profile DIR]

Phases (each raises on failure):
  1. device line (name and power limit, as nvidia-smi reports them);
  2. kernel build (one nvcc per source, in parallel);
  3. Listing-1 at scale 16 with ``use_pallas=True`` (the hand kernels);
     every read equals the host ``Assoc`` algebra's answer;
  4. the same workload on the port's PyTorch-ops path
     (``use_pallas=False``); every read equals phase 3's. Both paths
     first run once untimed, then twice each in the order kernels,
     PyTorch ops, PyTorch ops, kernels, so that neither path takes every
     first use;
  4b. the D4M 2.0 schema (``EdgeSchema``: Tedge / TedgeT / TedgeDeg) on the
     raw triples of the same graph, on both paths: the degree vectors
     equal ``np.bincount`` of the raw key ids, and the Fig. 4 SV/MV row and
     column reads of vertices picked by degree equal the host ``Assoc``
     algebra and a ``NaiveTable`` fed the same triples;
  4c. the legacy single-run engine (``engine="single"``) on both paths:
     the phase-3 row-id read, row range and a column read (host scan +
     filter) equal phase 3's reads;
  4d. Graphulo ``table_spmv`` on the schema's Tedge, both routes (the ELL
     kernel and the PyTorch product on the card) against a float64 product
     on the host, for a one-hot x at the largest out-degree and a random x;
  5. each kernel against its plain version on the card at every input
     each path gave it (recorded in phases 3, 4b, 4c and 4d: per geometry
     for the LSM kernels, per call for the 1-D rank, segment sum and SpMV),
     ranks and degree sums exactly equal, SpMV within rtol=1e-5, with
     kernel / plain / library-call times per launch (CUDA graphs and CUDA
     events), averaged over all the paths' launches.

The second-to-last line is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device
or without the repository's sources.
"""
import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks: the HBM rate and the float32 rate outside the tensor
# cores (NVIDIA data sheet), and the 32-bit integer rate for the rank
# kernels' compares and adds: 64 int32 add/compare results per clock per
# SM (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0) x 132 SMs x 1.98 GHz
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 64 * 132 * 1.98e9
PEAK_F32_PER_S = 67e12

ROOT = Path(__file__).resolve().parent


def log(msg):
    print(msg, flush=True)


def sync():
    import torch
    torch.cuda.synchronize()


def clock():
    sync()
    return time.perf_counter()


def cuda_ms(fn, reps, warm=3):
    """Mean ms of ``fn()`` over ``reps`` eager calls, CUDA events, after
    warm-up. Host launch overhead counts when it exceeds the device time."""
    import torch
    for _ in range(warm):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """(``fn()``, its ms) for one eager call, timed with CUDA events."""
    import torch
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    return result, start.elapsed_time(end)


def graph_ms(fn, reps):
    """Mean device ms of ``fn()`` over ``reps`` calls captured in one CUDA
    graph and replayed: the host's launch overhead is out of the number."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled(label, fn, out_dir):
    """Run ``fn`` under torch.profiler: log wall time, the summed device
    time of the kernels and copies it ran and the busy share, and write
    the top ops by device time to ``out_dir/profile_<label>.txt``.
    Returns (result, wall seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = clock()
        result = fn()
        wall = clock() - t0
    ka = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(ka[0], "self_device_time_total") else
           "self_cuda_time_total")
    # device-side events only: a host op's self device time repeats that
    # of the kernels and copies it issued
    dev_ms = sum(getattr(e, key) for e in ka
                 if e.device_type != DeviceType.CPU) / 1e3
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"profile_{label}.txt").write_text(
        ka.table(sort_by=key, row_limit=25))
    log(f"profile {label}: wall {wall * 1e3:.3f} ms, device {dev_ms:.3f} ms, "
        f"busy {100 * dev_ms / (wall * 1e3):.1f}%")
    return result, wall


def bound_ms(n_bytes, n_ops, peak_ops=PEAK_OPS_PER_S):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def same_triples(a, b, what):
    """Two Assocs hold the same (row, col, value) triples."""
    import numpy as np
    ta, tb = a.triples(), b.triples()
    if len(ta[0]) != len(tb[0]):
        raise AssertionError(f"{what}: {len(ta[0])} vs {len(tb[0])} entries")
    oa = np.lexsort((ta[1], ta[0]))
    ob = np.lexsort((tb[1], tb[0]))
    for x, y, name in zip(ta, tb, ("rows", "cols", "vals")):
        if not np.array_equal(np.asarray(x)[oa], np.asarray(y)[ob]):
            raise AssertionError(f"{what}: {name} differ")


# ------------------------------------------------------------------ phase 3/4
class Recorder:
    """Stands in for a kernel wrapper where a module of the path calls it:
    every call goes on to the wrapper (which launches and counts as
    before), and the recorder keeps a copy of the inputs and the number of
    calls for each distinct input geometry, or with ``every_call`` for each
    call."""

    def __init__(self, module, name, every_call=False):
        self.module, self.name, self.every_call = module, name, every_call
        self.fn = getattr(module, name)
        self.calls = {}  # key -> [calls, (args, kwargs) copy]

    def __call__(self, *args, **kw):
        geo = (tuple(tuple(a.shape) if hasattr(a, "shape") else a
                     for a in args), tuple(sorted(kw.items())))
        if self.every_call:
            geo += (len(self.calls),)
        if geo not in self.calls:
            self.calls[geo] = [0, ([a.clone() if hasattr(a, "clone") else a
                                    for a in args], dict(kw))]
        self.calls[geo][0] += 1
        return self.fn(*args, **kw)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def listing1(graph, use_pallas, cap, stash=None, profile_dir=None):
    """Listing-1 through the connector. Returns (reads, stats, timings,
    kernel launches of the put and the reads). With ``stash`` set, the
    inputs of every kernel launch are recorded for phase 5. With
    ``profile_dir`` set, the put and each read run under torch.profiler
    (their times then include its cost)."""
    import numpy as np
    from repro_torch.db import delete, put

    A, verts, sels = graph["A"], graph["verts"], graph["sels"]
    DB = server("smoke", cap, use_pallas)
    # the vertex names are interned in sorted order first (a sorted bulk
    # load), so string ranges map to contiguous ids and run as scans
    DB.encode_keys(np.asarray(verts, dtype=object))
    Tedge = DB["Tedge", "TedgeT"]
    # flush + compaction once on the empty store (no state changes): the
    # kernel build, CUDA context and allocator warm-up stay off the clock
    Tedge.table.store.warmup()

    timed = path_timer(profile_dir, "kernels" if use_pallas else "ops")
    with kernel_run(stash) as launches:
        _, t_put = timed("put", lambda: put(Tedge, A))
        reads, times = {}, {"put_s": t_put,
                            "ingest_entries_per_s": A.nnz() / t_put}
        for name, sel in sels.items():
            reads[name], times[name + "_s"] = timed(name, lambda: Tedge[sel])
    store = Tedge.table.store
    stats = {"Tedge": store.engine_stats(),
             "TedgeT": store.t_store.engine_stats()}
    delete(Tedge)
    if DB.ls():
        raise AssertionError(f"tables left after delete: {DB.ls()}")
    return reads, stats, times, launches


def make_graph(scale, seed):
    import numpy as np
    from repro_torch.core import Assoc
    from repro_torch.data.graph500 import graph500_triples
    from repro_torch.db.kvstore import shard_of

    t0 = time.perf_counter()
    r, c, v = graph500_triples(scale, 16, seed=seed)
    A = Assoc(r, c, v)
    verts = np.union1d(A.row, A.col)
    ids = {s: i for i, s in enumerate(verts)}
    ar, ac, _ = A.triples()
    rid = np.fromiter((ids[x] for x in ar), np.int64, len(ar))
    cid = np.fromiter((ids[x] for x in ac), np.int64, len(ac))
    # capacity from the actual shard skew (the ingest benchmark's sizing)
    counts = np.maximum(np.bincount(shard_of(rid, 4, 1 << 16), minlength=4),
                        np.bincount(shard_of(cid, 4, 1 << 16), minlength=4))
    cap = max(1 << 12, int(counts.max() * 1.3))
    rng = np.random.default_rng(seed)
    # 1,024 row vertices owned by one shard: two query tiles of 512
    row_v = np.unique(rid)
    owner = shard_of(row_v, 4, 1 << 16)
    own = row_v[owner == np.argmax(np.bincount(owner, minlength=4))]
    row_ids = verts[rng.choice(own, min(1024, len(own)), replace=False)]
    col_v = np.unique(cid)
    col_ids = verts[rng.choice(col_v, min(256, len(col_v)), replace=False)]
    lo, hi = len(verts) // 64, min(len(verts) // 64 + 999, len(verts) - 1)
    clo, chi = lo * 8, min(lo * 8 + 999, len(verts) - 1)
    sels = {
        "row_ids": (",".join(row_ids) + ",", ":"),
        "col_ids": (":", ",".join(col_ids) + ","),
        "row_range": (f"{verts[lo]},:,{verts[hi]},", ":"),
        "col_range": (":", f"{verts[clo]},:,{verts[chi]},"),
    }
    log(f"graph: scale {scale}, {len(r)} edges, {A.nnz()} distinct entries, "
        f"{len(verts)} vertices, capacity_per_shard {cap}, host build "
        f"{time.perf_counter() - t0:.3f} s")
    # the raw triples (duplicates included) for the schema phases, their
    # key ids (verts is sorted and interned first, so id = position), and
    # the last-wins Assoc the edge table must equal
    raw_ids = (np.searchsorted(verts, r), np.searchsorted(verts, c))
    return {"A": A, "verts": verts, "sels": sels, "raw": (r, c, v),
            "raw_ids": raw_ids, "last": Assoc(r, c, v, func="last")}, cap


def server(name, cap, use_pallas, **kw):
    """A server in the phase-3 configuration (``kw`` overrides fields)."""
    from repro_torch.db import dbsetup
    conf = dict(num_shards=4, id_capacity=1 << 16, batch_cap=1 << 15,
                memtable_cap=1 << 16, capacity_per_shard=cap,
                use_pallas=use_pallas)
    conf.update(kw)
    return dbsetup(name, **conf)


# the slice's new kernels are checked at each call's inputs (their calls
# are few, and the same geometry comes with different data: the one-hot
# and random x of the SpMV, the out- and in-degree ids of the segment sum)
EVERY_CALL = ("rank", "segment_sum", "spmv_ell")


def wrapper_sites():
    """Where the paths call each kernel's wrapper: (module, attribute)."""
    from repro_torch.db import graphulo, kvstore
    from repro_torch.kernels.merge_rank import ops as merge_ops
    from repro_torch.kernels.sorted_search import ops as search_ops
    return {"rank_batched": (search_ops, "rank_batched"),
            "row_rank": (merge_ops, "row_rank"),
            "pair_rank": (merge_ops, "pair_rank"),
            "rank": (search_ops, "rank"),
            "segment_sum": (kvstore, "segment_sum"),
            "spmv_ell": (graphulo, "spmv_ell")}


@contextlib.contextmanager
def kernel_run(stash=None):
    """Counts every kernel's launches from 0 over the block; the dict it
    yields is filled on exit. With ``stash`` a dict, a Recorder stands at
    each wrapper's call site for the block, under the kernel's name."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    launches = {}
    with contextlib.ExitStack() as rec:
        if stash is not None:
            for name, (module, attr) in wrapper_sites().items():
                stash[name] = rec.enter_context(
                    Recorder(module, attr, every_call=name in EVERY_CALL))
        reset_launches()
        yield launches
        launches.update(LAUNCHES)


def timed_call(fn):
    t0 = clock()
    result = fn()
    return result, clock() - t0


def path_timer(profile_dir, tag):
    """``timed(label, fn)`` -> (result, seconds): host clock, or under
    torch.profiler (its cost included) when ``profile_dir`` is set."""
    def timed(label, fn):
        if profile_dir is not None:
            return profiled(f"{tag}_{label}", fn, profile_dir)
        return timed_call(fn)
    return timed


# ------------------------------------------------------------------ phase 4b
def fig4(graph, cap, use_pallas, naive, seed, stash=None, profile_dir=None):
    """The D4M 2.0 schema on the raw triples, then the Fig. 4 reads
    (``benchmarks/query_bench.py::fig4``): for degree targets {1, 10, 100,
    1000} x {out: row read, in: column read}, one vertex (SV) and five (MV)
    picked by ``vertices_with_degree``, seeded. Returns (schema, server,
    launches of the put and the reads, times)."""
    import numpy as np
    from repro_torch.db import EdgeSchema

    DB = server("fig4", cap, use_pallas)
    DB.encode_keys(np.asarray(graph["verts"], dtype=object))
    g = EdgeSchema(DB, "g")
    g.pair.table.store.warmup()
    timed = path_timer(profile_dir, "fig4_" + ("kernels" if use_pallas
                                               else "ops"))
    with kernel_run(stash) as launches:
        times = fig4_put_and_reads(g, graph, naive, seed, timed)
    if use_pallas and not (launches["segment_sum"] == 2
                           and launches["pair_rank"] > 0
                           and launches["rank_batched"] > 0):
        raise AssertionError(f"phase 4b: kernel launches {launches}")
    if not use_pallas and any(launches.values()):
        raise AssertionError(f"phase 4b launched a hand kernel: {launches}")
    return g, DB, launches, times


def fig4_put_and_reads(g, graph, naive, seed, timed):
    """Phase 4b's put, degree checks and Fig. 4 reads; returns the times."""
    import numpy as np
    verts, (r, c, v) = graph["verts"], graph["raw"]
    _, t_put = timed("put", lambda: g.put_triple(r, c, v))
    n = len(verts)
    for k, ids in (("out_deg", graph["raw_ids"][0]),
                   ("in_deg", graph["raw_ids"][1])):
        deg = getattr(g.deg, k).cpu().numpy()
        want = np.bincount(ids, minlength=n).astype(np.float32)
        if not (np.array_equal(deg[:n], want) and not deg[n:].any()):
            raise AssertionError(f"phase 4b: {k} differs from the bincount")
    times = {"put_s": t_put, "triples_per_s": len(r) / t_put}
    rng = np.random.default_rng(seed)
    last, summed = graph["last"], graph["A"]
    for target in (1, 10, 100, 1000):
        for kind, axis in (("out", "R"), ("in", "C")):
            vs = g.deg.vertices_with_degree(target, kind=kind)
            if len(vs) == 0:
                log(f"phase 4b: no vertex of {kind}-degree ~{target}")
                continue
            single = str(rng.choice(vs)) + ","
            multi = "".join(str(x) + "," for x in rng.choice(
                vs, size=min(5, len(vs)), replace=False))
            for qname, q in (("SV", single), ("MV", multi)):
                key = (q, ":") if axis == "R" else (":", q)
                label = f"deg{target}_{qname}{axis}"
                got, times[label + "_s"] = timed(label, lambda: g[key])
                if got.nnz() == 0:
                    raise AssertionError(f"phase 4b {label}: empty read")
                same_triples(got, last[key], f"phase 4b {label} vs Assoc")
                nv = naive[key]
                same_triples(nv, summed[key], f"phase 4b {label} naive")
                if not (np.array_equal(np.sort(nv.row), np.sort(got.row))
                        and np.array_equal(np.sort(nv.col),
                                           np.sort(got.col))):
                    raise AssertionError(f"phase 4b {label}: naive keys")
    return times


# ------------------------------------------------------------------ phase 4c
def single_engine(graph, cap, use_pallas, lsm_reads, stash=None,
                  profile_dir=None):
    """The legacy single-run engine, bulk-load sized as in
    ``benchmarks/ingest_bench.py``: the phase-3 put, then the row-id read,
    the row range and a column read (host scan + filter on this engine).
    Returns (times, launches)."""
    import numpy as np
    from repro_torch.db import delete, put

    A, verts, sels = graph["A"], graph["verts"], graph["sels"]
    batch_cap = 1 << 15
    DB = server("single", cap, use_pallas, engine="single",
                memtable_cap=max(cap, 4 * batch_cap))
    DB.encode_keys(np.asarray(verts, dtype=object))
    T = DB["Tsingle"]
    T.store.warmup()
    timed = path_timer(profile_dir, "single_" + ("kernels" if use_pallas
                                                 else "ops"))
    with kernel_run(stash) as launches:
        _, t_put = timed("put", lambda: put(T, A))
        times = {"put_s": t_put, "ingest_entries_per_s": A.nnz() / t_put}
        for name in ("row_ids", "row_range", "col_ids"):
            sel = sels[name]
            got, times[name + "_s"] = timed(name, lambda: T[sel])
            same_triples(got, lsm_reads[name], f"phase 4c {name} vs LSM")
            same_triples(got, A[sel], f"phase 4c {name} vs Assoc")
    st = T.store.engine_stats()
    if st["flushes"] < 1:
        raise AssertionError(f"phase 4c: no flush ({st})")
    if use_pallas and not (launches["rank"] > 0 and launches["pair_rank"] > 0):
        raise AssertionError(f"phase 4c: rank / pair_rank never launched "
                             f"({launches})")
    if not use_pallas and any(launches.values()):
        raise AssertionError(f"phase 4c launched a hand kernel: {launches}")
    delete(T)
    return times, launches


# ------------------------------------------------------------------ phase 4d
def graphulo_spmv(g, DB, seed, stash=None):
    """``table_spmv`` on the schema's Tedge, on both routes (the ELL kernel,
    and the PyTorch product on the card), against a float64 product on the
    host from the table's scan: exactly for a one-hot x at the largest
    out-degree vertex, within rtol=1e-5 (kernel, float32) or 1e-12 (the
    float64 PyTorch route) for a random x. Returns (times, launches)."""
    import numpy as np
    from repro_torch.db import graphulo

    n = len(DB.keydict)
    r, c, v = DB["g_Tedge"].store.scan()
    counts = np.bincount(r, minlength=n)
    log(f"phase 4d: ELL {n} rows x {int(counts.max())} slots, "
        f"{8 * n * int(counts.max())} bytes of cols + vals for {len(r)} "
        "entries")
    hub = int(np.argmax(g.deg.out_deg[:n].cpu().numpy()))
    one_hot = np.zeros(n)
    one_hot[hub] = 1.0
    x_rand = np.random.default_rng(seed).random(n)
    times = {}
    with kernel_run(stash) as launches:
        for label, x in (("one_hot", one_hot), ("random", x_rand)):
            want = np.zeros(n)
            np.add.at(want, r, v.astype(np.float64) * x[c])
            yk, times[label + "_kernel_s"] = timed_call(
                lambda: graphulo.table_spmv(g.pair, x, use_pallas=True))
            yd, times[label + "_ops_s"] = timed_call(
                lambda: graphulo.table_spmv(g.pair, x, use_pallas=False))
            m = int(r.max()) + 1
            if yk.shape != (n,) or yd.shape != (m,) or want[m:].any():
                raise AssertionError(f"phase 4d {label}: shapes")
            if label == "one_hot":
                if not (np.array_equal(yk, want)
                        and np.array_equal(yd, want[:m])):
                    raise AssertionError("phase 4d one_hot: not exact")
            else:
                np.testing.assert_allclose(yk, want, rtol=1e-5,
                                           err_msg="phase 4d random, kernel")
                np.testing.assert_allclose(yd, want[:m], rtol=1e-12,
                                           err_msg="phase 4d random, ops")
    if launches["spmv_ell"] != 2 or sum(launches.values()) != 2:
        raise AssertionError(f"phase 4d: kernel launches {launches}")
    return times, launches


# ------------------------------------------------------------------ phase 5
def kernel_checks(stash, launches):
    """Each kernel against its plain version at every input each path gave
    it (``stash[path][kernel]``, recorded in phases 3, 4b, 4c and 4d: one
    per geometry for #1-#3, every call for #4-#6). ``launches[path]`` are
    the paths' launch counts. Every time is the mean per launch over all
    the paths' launches, so ms x launches is the kernel's device time on
    the paths."""
    import numpy as np
    import torch
    from repro_torch.kernels.common import I32_MAX
    from repro_torch.kernels.merge_rank import (pair_rank, pair_rank_ref,
                                                row_rank, row_rank_ref)
    from repro_torch.kernels.segment_reduce import (segment_sum,
                                                    segment_sum_ref)
    from repro_torch.kernels.sorted_search import (rank, rank_batched,
                                                   rank_batched_ref, rank_ref)
    from repro_torch.kernels.spmv import spmv_ell, spmv_ell_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    out = []

    def check(name, got, want):
        """Ranks and degree sums (integer-valued) must be exactly equal."""
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{name}: {bad} results differ from plain")
        return float((got.double() - want.double()).abs().max())

    def check_close(name, got, want):
        """SpMV: float atomics / the warp reduction add in another order
        than the plain row sum, so within rtol=1e-5."""
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                                   msg=lambda m: f"{name}: {m}")
        return float((got.double() - want.double()).abs().max())

    def steps(n):  # probe steps of a binary search over n entries
        return max(1, math.ceil(math.log2(n + 1)))

    def probed(n, n_q):  # table entries a binary search must read
        return min(n, n_q * steps(n))

    # bytes: the queries read and the output written once, and of each
    # searched table only the entries the queries' binary searches probe
    # (at most the table); operations: a compare and an add per probe step
    # (rank search) or per pair (row rank), three compares and a select per
    # probe step (pair rank)
    def search_cost(args, kw):
        tabs, qq = args
        k, n = tabs.shape
        return (4 * (k * probed(n, qq.numel()) + qq.numel()
                     + k * qq.numel()),
                2 * k * qq.numel() * steps(n))

    def row_cost(args, kw):
        (keys,) = args
        return 4 * 2 * keys.numel(), 2 * keys.shape[0] * keys.shape[1] ** 2

    def pair_cost(args, kw):
        tr, _, qr, _ = args
        (n_s, m), n = tr.shape, qr.shape[1]
        return (4 * (2 * n_s * probed(m, n) + 3 * qr.numel()),
                4 * qr.numel() * steps(m))

    def rank_cost(args, kw):
        tab, qq = args[:2]
        return search_cost((tab[None], qq), kw)

    # segment sum: ids and values read, the [S] sums written; one float add
    # per entry (at the float32 rate, below)
    def segsum_cost(args, kw):
        ids = args[0]
        return 8 * ids.numel() + 4 * kw["n_segments"], ids.numel()

    # ELL SpMV: every slot's column is read (it says whether the slot is a
    # pad), but a value only where the slot holds an entry of this run's
    # ELL; x read and y written once; a multiply and an add per entry
    def spmv_cost(args, kw):
        cols, _, x = args
        nnz = int(((cols >= 0) & (cols < x.numel())).sum())
        return (4 * (cols.numel() + nnz + x.numel() + cols.shape[0]),
                2 * nnz)

    # one PyTorch call computing the same function
    def search_lib(args, kw):
        tabs, qq = args
        qk = qq[None].expand(tabs.shape[0], -1).contiguous()
        return lambda: torch.searchsorted(tabs, qk, right=not kw["strict"],
                                          out_int32=True)

    def pair_lib(args, kw):
        tr, tc, qr, qc = args
        tkey = (tr.long() << 32) | tc.long()
        qkey = (qr.long() << 32) | qc.long()
        return lambda: torch.searchsorted(tkey, qkey, right=not kw["strict"],
                                          out_int32=True)

    def rank_lib(args, kw):
        tab, qq = args
        return lambda: torch.searchsorted(tab, qq, right=not kw["strict"],
                                          out_int32=True)

    def segsum_lib(args, kw):  # index_add_ on the valid ids (off the clock)
        ids, vals = args
        n_seg = kw["n_segments"]
        ok = (ids >= 0) & (ids < n_seg)
        vi, vv = ids[ok].long(), vals[ok]
        return lambda: torch.zeros(n_seg, device=dev).index_add_(0, vi, vv)

    def spmv_lib(args, kw):  # cuSPARSE CSR product (CSR built off the clock)
        cols, vals, x = args
        ok = cols >= 0
        crow = torch.zeros(cols.shape[0] + 1, dtype=torch.int64, device=dev)
        crow[1:] = ok.sum(1).cumsum(0)
        a = torch.sparse_csr_tensor(crow, cols[ok].long(), vals[ok],
                                    size=(cols.shape[0], x.shape[0]))
        xc = x[:, None]
        return lambda: a @ xc

    # name, kernel, plain, cost, library, plain timing reps, check, op
    # peak, library timed eagerly (cuSPARSE is not captured in a graph)
    specs = (
        ("rank_batched", rank_batched, rank_batched_ref, search_cost,
         search_lib, (20, 3), check, PEAK_OPS_PER_S, False,
         "src/repro_torch/csrc/rank_batched.cu",
         "src/repro/kernels/sorted_search/kernel.py:66"),
        ("row_rank", row_rank, row_rank_ref, row_cost, None, (20, 3), check,
         PEAK_OPS_PER_S, False, "src/repro_torch/csrc/row_rank.cu",
         "src/repro/kernels/merge_rank/kernel.py:67"),
        # the plain pair rank is a chunked quadratic count (up to ~7e11
        # compares per shard at the single engine's flush): its time is
        # that of the one call the check makes, no warm-up
        ("pair_rank", pair_rank, pair_rank_ref, pair_cost, pair_lib, (0, 0),
         check, PEAK_OPS_PER_S, False, "src/repro_torch/csrc/pair_rank.cu",
         "src/repro/kernels/merge_rank/kernel.py:36"),
        # the plain 1-D rank is the compare count over the whole tablet
        ("rank", rank, rank_ref, rank_cost, rank_lib, (3, 1), check,
         PEAK_OPS_PER_S, False, "src/repro_torch/csrc/rank.cu",
         "src/repro/kernels/sorted_search/kernel.py:30"),
        ("segment_sum", segment_sum, segment_sum_ref, segsum_cost,
         segsum_lib, (20, 3), check, PEAK_F32_PER_S, False,
         "src/repro_torch/csrc/segment_sum.cu",
         "src/repro/kernels/segment_reduce/kernel.py:33"),
        ("spmv_ell", spmv_ell, spmv_ell_ref, spmv_cost, spmv_lib, (3, 1),
         check_close, PEAK_F32_PER_S, True, "src/repro_torch/csrc/spmv_ell.cu",
         "src/repro/kernels/spmv/kernel.py:34"),
    )
    for (name, fn, ref, cost, lib, (p_reps, p_warm), chk, peak, lib_eager,
         src, tpu) in specs:
        by_path, inputs = {}, []
        for path, recorders in stash.items():
            calls = recorders[name].calls
            by_path[path] = sum(c for c, _ in calls.values())
            if by_path[path] != launches[path][name]:
                raise AssertionError(
                    f"{name} in {path}: recorded {by_path[path]} calls, "
                    f"{launches[path][name]} launches")
            inputs += [(path, key, *calls[key])
                       for key in sorted(calls, key=lambda g: -calls[g][0])]
        n_calls = sum(by_path.values())
        if n_calls == 0:
            raise AssertionError(f"{name}: launched on no path")
        err, tot = 0.0, dict.fromkeys(("ms", "eager", "plain", "lib", "bound"),
                                      0.0)
        ops_by = [0.0, 0.0]
        for _, _, cnt, (args, kw) in inputs:
            want, t_plain = timed_once(lambda: ref(*args, **kw))
            err = max(err, chk(name, fn(*args, **kw), want))
            del want
            w = cnt / n_calls
            tot["ms"] += w * graph_ms(lambda: fn(*args, **kw), 50)
            tot["eager"] += w * cuda_ms(lambda: fn(*args, **kw), 50)
            tot["plain"] += w * (cuda_ms(lambda: ref(*args, **kw), p_reps,
                                         warm=p_warm) if p_reps else t_plain)
            if lib is not None:
                timer = cuda_ms if lib_eager else graph_ms
                tot["lib"] += w * timer(lib(args, kw), 50)
            b, by = bound_ms(*cost(args, kw), peak_ops=peak)
            tot["bound"] += w * b
            ops_by[by == "operations"] += w * b
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": tpu, "launches": n_calls,
                    "max_abs_err": err, "ms": tot["ms"],
                    "plain_ms": tot["plain"], "bound_ms": tot["bound"],
                    "bound_by": ("operations" if ops_by[1] > ops_by[0]
                                 else "bytes"),
                    "library_ms": tot["lib"] if lib else None,
                    "eager_ms": tot["eager"],
                    "launches_by_path": {k: v for k, v in by_path.items()
                                         if v},
                    "inputs": "; ".join(
                        f"{path} {cnt}x " + " ".join(
                            str(list(x)) if isinstance(x, tuple) else str(x)
                            for x in key[0]) + "".join(
                            f" {k}={v}" for k, v in key[1])
                        for path, key, cnt, _ in inputs)})

    # #2 also at the widest row the path sends it ([512, 256]: 8 runs x 32),
    # as a check (not part of the path's mean)
    keys = (rng.integers(0, 1 << 14, (512, 256)) * 256
            + np.arange(256)).reshape(512, 8, 32)  # unique within a row
    keys.sort(axis=2)
    fill = rng.integers(0, 33, (512, 8, 1))
    keys = np.where(np.arange(32) < fill, keys, I32_MAX).reshape(512, 256)
    kt = torch.as_tensor(keys.astype(np.int32), device=dev)
    check("row_rank", row_rank(kt), row_rank_ref(kt))
    log(f"row_rank [512,256]: equal to plain; "
        f"{graph_ms(lambda: row_rank(kt), 100):.6f} ms per launch")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=int, default=16)
    ap.add_argument("--profile", metavar="DIR", type=Path,
                    help="after the timed runs, run each path once more "
                         "with its put and reads traced by torch.profiler, "
                         "and write the per-op tables into DIR")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import common
    except ImportError as e:
        print(f"chip_smoke: the port's sources are missing ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    # 2. build
    t0 = time.perf_counter()
    common.build()
    common.lib()
    log(f"build: {time.perf_counter() - t0:.3f} s")

    # 3. Listing-1 on the hand kernels. Both paths first run once untimed
    # (their cold times are logged), so that first uses of the device code
    # (lazy module loads, allocator growth) stay off the compared clocks
    graph, cap = make_graph(args.scale, args.seed)
    for use_pallas in (True, False):
        cold = listing1(graph, use_pallas, cap)[2]
        log(f"cold run (use_pallas={use_pallas}): {json.dumps(cold)}")
    # each path's recorded kernel inputs and launch counts, for phase 5
    stash = {p: {} for p in ("listing1", "fig4", "graphulo", "single")}
    launches = {}
    reads, stats, times, launches["listing1"] = listing1(
        graph, True, cap, stash["listing1"])
    A = graph["A"]
    for key, sel in graph["sels"].items():
        same_triples(reads[key], A[sel], f"phase 3 {key} vs Assoc")
        if reads[key].nnz() == 0:
            raise AssertionError(f"phase 3 {key}: empty read")
    tot = {k: stats["Tedge"][k] + stats["TedgeT"][k]
           for k in ("major_compactions", "fused_dispatches",
                     "scan_dispatches", "fused_tiles")}
    for k, v in tot.items():
        if v <= 0:
            raise AssertionError(f"phase 3: {k} = {v}")
    for k in ("rank_batched", "row_rank", "pair_rank"):
        if launches["listing1"][k] <= 0:
            raise AssertionError(f"phase 3: kernel {k} never launched")
    log("phase 3 (use_pallas=True): " + json.dumps(
        {"times": times, "engine": tot, "launches": launches["listing1"],
         "nnz": {k: reads[k].nnz() for k in reads}}))

    # 4. the PyTorch-ops path on the card, then both paths again in the
    # other order (kernels, ops, ops, kernels); every read equals phase 3's
    timing = {True: [times], False: []}
    for use_pallas in (False, False, True):
        again = listing1(graph, use_pallas, cap)
        if not use_pallas and any(again[3].values()):
            raise AssertionError(f"phase 4 launched a hand kernel: {again[3]}")
        for key in reads:
            same_triples(again[0][key], reads[key],
                         f"use_pallas={use_pallas} {key} vs phase 3")
        timing[use_pallas].append(again[2])
    log("phase 4 (use_pallas=False): " + json.dumps({"times": timing[False]}))
    log("phase 3-4 timing, kernels, ops, ops, kernels: " + json.dumps(
        {"use_pallas=True": timing[True], "use_pallas=False": timing[False]}))
    if args.profile is not None:  # one more run of each path, traced
        for use_pallas in (True, False):
            traced = listing1(graph, use_pallas, cap, profile_dir=args.profile)
            for key in reads:
                same_triples(traced[0][key], reads[key],
                             f"traced use_pallas={use_pallas} {key}")

    # 4b-4d. the D4M 2.0 schema and the Fig. 4 reads, Graphulo's SpMV on
    # the schema's Tedge, and the legacy single-run engine, each on both
    # paths; each path's kernel launches are counted from 0 around it
    from repro_torch.db import NaiveTable
    naive = NaiveTable("naive")
    _, t_naive = timed_call(lambda: naive.put_triple(*graph["raw"]))
    log(f"phase 4b: NaiveTable put of {len(graph['raw'][0])} triples "
        f"{t_naive:.3f} s")
    for use_pallas in (False, True):
        g, DB, fl, ft = fig4(graph, cap, use_pallas, naive, args.seed,
                             stash["fig4"] if use_pallas else None)
        log(f"phase 4b (schema, use_pallas={use_pallas}): "
            + json.dumps({"times": ft, "launches": fl}))
        if use_pallas:
            launches["fig4"] = fl
            gt, launches["graphulo"] = graphulo_spmv(g, DB, args.seed,
                                                     stash["graphulo"])
            log("phase 4d (graphulo): " + json.dumps(
                {"times": gt, "launches": launches["graphulo"]}))
        g.delete()
        if DB.ls():
            raise AssertionError(f"tables left after delete: {DB.ls()}")
    for use_pallas in (True, False):
        st, sl = single_engine(graph, cap, use_pallas, reads,
                               stash["single"] if use_pallas else None)
        if use_pallas:
            launches["single"] = sl
        log(f"phase 4c (single engine, use_pallas={use_pallas}): "
            + json.dumps({"times": st, "launches": sl}))
    if args.profile is not None:  # one more run of each path, traced
        for use_pallas in (True, False):
            g, DB, _, _ = fig4(graph, cap, use_pallas, naive, args.seed,
                               profile_dir=args.profile)
            g.delete()
            single_engine(graph, cap, use_pallas, reads,
                          profile_dir=args.profile)

    # 5. kernels against their plain versions
    kernels = kernel_checks(stash, launches)
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
