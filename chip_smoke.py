#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Drives the paper's Listing-1 database path through the connector a user
calls — ``dbsetup`` → bind the ``Tedge``/``TedgeT`` pair → ``put`` →
row, column and range reads → ``delete`` — on a Graph500 graph, then the
D4M 2.0 schema with its degree table and the Fig. 4 reads, the legacy
single-run engine, Graphulo's SpMV, and the LM serving path
(``launch/serve.py`` → ``Engine`` → prefill / decode); builds the hand-written CUDA
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
  6. LM serving: smollm-135m at full width (30 layers, d_model 576, 9
     heads over 3 KV heads, hd 64, vocabulary 49,152, tied embeddings) in
     bf16 from the port's seeded init, on the card: run a is
     ``repro_torch.launch.serve``'s defaults (8 requests of 4-23 tokens,
     16 new tokens each, 4 slots, max_len 128), run b a long context (4
     requests of 1,920 tokens, 128 new tokens each, max_len 2,048). Every
     request yields its tokens, self-attention runs only on the
     flash-attention kernel (960 and 3,840 launches), the card's first
     prefill equals the same weights' prefill on the CPU within 2e-2, and
     prefill-then-decode equals the full prefill within 5e-2 (bf16);
  5. each kernel against its plain version on the card at every input
     each path gave it (recorded in phases 3, 4b, 4c, 4d and 6: per
     geometry for the LSM kernels and flash attention, per call for the
     1-D rank, segment sum and SpMV), ranks and degree sums exactly equal,
     SpMV within rtol=1e-5, attention within about one bf16 ulp (rtol
     8e-3, atol 1e-3; float32 2e-5) and an error norm within 1e-2 of the
     output's, a limit that two planted faults at run b's inputs must
     fail, with kernel / plain / library-call times per launch (CUDA
     graphs and CUDA events; SDPA in the faster of its masked and
     mask-free forms), averaged over all the paths' launches.

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
PEAK_BF16_PER_S = 989e12  # dense bf16 tensor-core rate

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
    from repro_torch.models import layers
    return {"rank_batched": (search_ops, "rank_batched"),
            "row_rank": (merge_ops, "row_rank"),
            "pair_rank": (merge_ops, "pair_rank"),
            "rank": (search_ops, "rank"),
            "segment_sum": (kvstore, "segment_sum"),
            "spmv_ell": (graphulo, "spmv_ell"),
            "flash_attention": (layers, "flash_attention")}


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


# ------------------------------------------------------------------ phase 6
SERVE_ARCH = "smollm-135m"


def serving(seed, stash, profile_dir=None):
    """The LM serving path at full width, in bf16, on the card: run a
    through ``repro_torch.launch.serve.main`` with its defaults, run b (a
    long context at SmolLM-135M's published 2,048-token window) through
    ``Engine``; then the card's first prefill of run a against the same
    weights' prefill on the CPU, and prefill-then-decode against the full
    prefill. With ``profile_dir`` set, both runs are then repeated under
    torch.profiler. Returns (stats, launches) of the two runs."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import build, init_params, transformer
    from repro_torch.serve import Engine, Request

    cfg = get_config(SERVE_ARCH)
    model = build(cfg)
    log(f"phase 6: {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads}, hd {cfg.hd}, vocab "
        f"{cfg.vocab} (padded {cfg.vocab_padded}), {cfg.param_dtype}")
    stats, launches = {}, {}
    torch.cuda.reset_peak_memory_stats()
    with kernel_run(stash["serve_a"]) as launches["serve_a"]:
        stats["serve_a"] = launch_serve.main(["--arch", SERVE_ARCH,
                                              "--seed", str(seed)])
    # the CLI's weights and prompts: its seeded CPU generator and numpy rng
    params = init_params(model.param_specs, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    prompts_a = [rng.integers(1, cfg.vocab, rng.integers(4, 24)).astype(
        np.int32) for _ in range(8)]
    rng = np.random.default_rng(seed)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, 1920).astype(np.int32),
                    max_new=128) for _ in range(4)]
    engine = Engine(model, params, batch_slots=4, max_len=2048)
    with kernel_run(stash["serve_b"]) as launches["serve_b"]:
        stats["serve_b"] = engine.run(reqs)
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # every request yields its tokens; self-attention is the kernel only:
    # batches x (1 prefill + max_new - 1 decode steps) x layers
    for run, n_tok, want in (("serve_a", 8 * 16, 2 * 16 * cfg.n_layers),
                             ("serve_b", 4 * 128, 1 * 128 * cfg.n_layers)):
        got = launches[run]
        if stats[run]["tokens_out"] != n_tok:
            raise AssertionError(f"phase 6 {run}: {stats[run]['tokens_out']} "
                                 f"tokens, want {n_tok}")
        if got["flash_attention"] != want or sum(got.values()) != want:
            raise AssertionError(f"phase 6 {run}: launches {got}, want "
                                 f"{want} of flash_attention only")
    for r in reqs:
        if len(r.out) != 128 or r.out.min() < 0 or \
                r.out.max() >= cfg.vocab_padded:
            raise AssertionError(f"phase 6 serve_b: tokens {r.out}")

    # the card's first prefill of run a against the CPU's (plain attention)
    plen = max(len(p) for p in prompts_a[:4])
    toks = np.zeros((4, plen), np.int32)
    for j, p in enumerate(prompts_a[:4]):
        toks[j, plen - len(p):] = p
    toks = torch.from_numpy(toks)
    card, _ = transformer.prefill(cfg, engine.params, toks.cuda(), 128)
    cpu, _ = transformer.prefill(cfg, params, toks, 128)
    card = card.cpu()
    if card.shape != (4, 1, cfg.vocab_padded) or \
            not torch.isfinite(card).all():
        raise AssertionError(f"phase 6: prefill logits {card.shape}")
    err_cpu = float((card - cpu).abs().max())
    torch.testing.assert_close(card, cpu, rtol=2e-2, atol=2e-2,
                               msg=lambda m: f"phase 6 card vs CPU: {m}")
    # prefill then one decode step equals the full prefill (bf16: the
    # tolerance of tests/test_arch_smoke.py)
    full, _ = transformer.prefill(cfg, engine.params, toks.cuda(), 128)
    _, cache = transformer.prefill(cfg, engine.params, toks[:, :-1].cuda(),
                                   128)
    dec, _ = transformer.decode_step(cfg, engine.params, toks[:, -1:].cuda(),
                                     cache, plen - 1)
    err_dec = float((dec - full).abs().max())
    torch.testing.assert_close(dec, full, rtol=5e-2, atol=5e-2,
                               msg=lambda m: f"phase 6 decode vs prefill: {m}")
    log(f"phase 6 checks: card vs CPU prefill max |diff| {err_cpu:.6f}, "
        f"prefill-then-decode vs prefill max |diff| {err_dec:.6f}")
    if profile_dir is not None:  # one more run of each, traced
        profiled("serve_a", lambda: launch_serve.main(
            ["--arch", SERVE_ARCH, "--seed", str(seed)]), profile_dir)
        rng = np.random.default_rng(seed)
        again = [Request(prompt=rng.integers(1, cfg.vocab, 1920).astype(
            np.int32), max_new=128) for _ in range(4)]
        profiled("serve_b", lambda: engine.run(again), profile_dir)
        for r, a in zip(reqs, again):
            if not np.array_equal(r.out, a.out):
                raise AssertionError("phase 6: traced run b's tokens differ")
    return stats, launches


# ------------------------------------------------------------------ phase 5
def input_groups(inputs):
    """Group recorded inputs as 'path shapes kw=...': the decode steps'
    positions (``q_offset``) fold into one group, shown as a range.
    Returns {text: [indices into inputs]}."""
    groups, offs = {}, {}
    for n, (path, key, _, _) in enumerate(inputs):
        kw = dict(key[1])
        off = kw.pop("q_offset", None)
        text = f"{path} " + " ".join(
            str(list(x)) if isinstance(x, tuple) else str(x)
            for x in key[0]) + "".join(f" {k}={v}" for k, v in kw.items())
        groups.setdefault(text, []).append(n)
        if off is not None:
            offs.setdefault(text, []).append(off)
    out = {}
    for text, idx in groups.items():
        o = offs.get(text, [])
        span = (f" q_offset={min(o)}" if len(o) == 1 else
                f" q_offset={min(o)}..{max(o)}" if o else "")
        out[text + span] = idx
    return out


def kernel_checks(stash, launches):
    """Each kernel against its plain version at every input each path gave
    it (``stash[path][kernel]``, recorded in phases 3, 4b, 4c, 4d and 6:
    one per geometry for #1-#3 and #7, every call for #4-#6; a decode
    step's position is part of #7's geometry). ``launches[path]`` are
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
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)

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

    attn_rel = [0.0]  # the largest relative error norm #7's checks saw

    def attn_err(got, want):
        """(max |got - want|, ||got - want|| / ||want||, within the
        limits). Both sides compute in float32 and round once to the
        output dtype, adding in another order, so bf16 allows about one
        ulp (rtol 8e-3) above atol 1e-3 (the outputs at run b's inputs
        are ~1e-2), float32 2e-5; and for both an error norm within 1e-2
        of the output's."""
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"attention: {got.shape} {got.dtype} vs "
                                 f"{want.shape} {want.dtype}")
        g, w = got.float(), want.float()
        tol = (8e-3, 1e-3) if got.dtype == torch.bfloat16 else (2e-5, 2e-5)
        d = (g - w).abs()
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        ok = bool((d <= tol[1] + tol[0] * w.abs()).all()) and rel <= 1e-2
        return float(d.max()), rel, ok

    def check_attn(name, got, want):
        err, rel, ok = attn_err(got, want)
        if not ok:
            raise AssertionError(f"{name}: max |diff| {err:.3g}, relative "
                                 f"error norm {rel:.3g} past the limits")
        attn_rel[0] = max(attn_rel[0], rel)
        return err

    def masked_attention(q, k, v, keep):
        """Plain float32 attention where key j is seen by row i iff
        ``keep[i, j]``: makes the planted faults below."""
        g = q.shape[2] // k.shape[2]
        kk, vv = (x.float().repeat_interleave(g, dim=2) for x in (k, v))
        sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) \
            * q.shape[-1] ** -0.5
        sc = sc.masked_fill(~keep, -1e30)
        return torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1),
                            vv).to(q.dtype)

    def attn_faults():
        """The power of #7's check at run b's inputs (its prefill and its
        first decode step, where the cache holds 127 empty slots): two
        planted faults, made with the plain math and a key mask, must
        fail it: one of the decode's 8 key splits dropped (every 8th
        32-key tile: the keys split s serves), and the causal limit moved
        100 keys past each row's position. Returns the readings."""
        calls = stash["serve_b"]["flash_attention"].calls
        pre = [c[1] for key, c in calls.items() if key[0][0][1] > 1]
        dec = [c[1] for key, c in calls.items() if key[0][0][1] == 1]
        readings = {}
        for label, (args, kw) in (("prefill", pre[0]), ("decode", min(
                dec, key=lambda c: c[1]["q_offset"]))):
            q, k, v = args
            want = flash_attention_ref(*args, **kw)
            rows = kw["q_offset"] + torch.arange(q.shape[1], device=dev)
            keys = torch.arange(k.shape[1], device=dev)[None, :]
            causal = rows[:, None] >= keys
            for fault, keep in (
                    ("split dropped", causal & ((keys // 32) % 8 != 7)),
                    ("100 keys past", rows[:, None] + 100 >= keys)):
                err, rel, ok = attn_err(masked_attention(q, k, v, keep),
                                        want)
                if ok:
                    raise AssertionError(f"flash_attention: the check "
                                         f"passes a planted fault ({fault}, "
                                         f"run b {label})")
                readings[f"{label}, {fault}"] = {"max_abs_err": err,
                                                 "rel_err": rel}
            del want
        return readings

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

    # attention: q read and o written once, and of K and V only the keys
    # some row may see (the causal limit of the last row); four flops per
    # (row, key, dim) pair kept by the mask (q.k and p.v, multiply + add)
    def attn_cost(args, kw):
        q, k, _ = args
        b, sq, h, hd = q.shape
        sk, kvh = k.shape[1], k.shape[2]
        off = kw.get("q_offset", 0)
        if kw.get("causal", True):
            pairs = int(np.minimum(sk, off + np.arange(sq) + 1).sum())
            keys = min(sk, off + sq)
        else:
            pairs, keys = sq * sk, sk
        es = q.element_size()
        return (es * (2 * b * sq * h * hd + 2 * b * keys * kvh * hd),
                4 * b * h * hd * pairs)

    # one PyTorch call computing the same function
    def attn_lib(args, kw):
        """SDPA on [B, H, S, hd] copies (made off the clock) in two forms:
        with the boolean causal mask, and without one where the function
        allows it (``is_causal`` at q_offset 0, whose mask SDPA aligns
        top-left; a decode row over the K/V slice it sees), which lets
        SDPA take its fused flash backend. Each form's output is first
        held against the plain version (the CPU tests' 2e-2)."""
        sdpa = torch.nn.functional.scaled_dot_product_attention
        q, k, v = (x.transpose(1, 2).contiguous() for x in args)
        sq, sk = q.shape[2], k.shape[2]
        off, causal = kw.get("q_offset", 0), kw.get("causal", True)
        mask = (off + torch.arange(sq, device=dev)[:, None]
                >= torch.arange(sk, device=dev)[None, :]) if causal else None
        forms = {"lib_masked": lambda: sdpa(q, k, v, attn_mask=mask,
                                            enable_gqa=True)}
        if causal and off == 0:
            forms["lib_free"] = lambda: sdpa(q, k, v, is_causal=True,
                                             enable_gqa=True)
        elif causal and sq == 1:
            ks, vs = k[:, :, :off + 1], v[:, :, :off + 1]
            forms["lib_free"] = lambda: sdpa(q, ks, vs, enable_gqa=True)
        else:  # no mask, or no mask-free form: the same call
            forms["lib_free"] = forms["lib_masked"]
        want = flash_attention_ref(*args, **kw)
        for form, fn in forms.items():
            torch.testing.assert_close(
                fn().transpose(1, 2), want, rtol=2e-2, atol=2e-2,
                msg=lambda m: f"flash_attention library {form}: {m}")
        return forms

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
        ("flash_attention", flash_attention, flash_attention_ref, attn_cost,
         attn_lib, (5, 1), check_attn, PEAK_BF16_PER_S, False,
         "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/kernel.py:64"),
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
        err, per = 0.0, []  # per input: ms, eager, plain, lib, bound
        ops_by = [0.0, 0.0]
        for _, _, cnt, (args, kw) in inputs:
            want, t_plain = timed_once(lambda: ref(*args, **kw))
            err = max(err, chk(name, fn(*args, **kw), want))
            del want
            t = {"ms": graph_ms(lambda: fn(*args, **kw), 50),
                 "eager": cuda_ms(lambda: fn(*args, **kw), 50),
                 "plain": (cuda_ms(lambda: ref(*args, **kw), p_reps,
                                   warm=p_warm) if p_reps else t_plain),
                 "lib": 0.0}
            if lib is not None:  # the faster form where there are two
                timer = cuda_ms if lib_eager else graph_ms
                forms = lib(args, kw)
                if callable(forms):
                    forms = {"lib": forms}
                for form, f in forms.items():
                    t[form] = timer(f, 50)
                t["lib"] = min(t[form] for form in forms)
            t["bound"], by = bound_ms(*cost(args, kw), peak_ops=peak)
            ops_by[by == "operations"] += cnt * t["bound"]
            per.append(t)

        def mean(idx, k):  # launch-weighted mean over some inputs
            n = sum(inputs[i][2] for i in idx)
            return sum(inputs[i][2] * per[i][k] for i in idx) / n

        groups = {f"{sum(inputs[i][2] for i in idx)}x {text}": idx
                  for text, idx in input_groups(inputs).items()}
        lib_forms = [k for k in per[0] if k.startswith("lib_")]
        for text, idx in groups.items():
            log(f"{name} {text}: ms {mean(idx, 'ms'):.6g}, plain "
                f"{mean(idx, 'plain'):.6g}, library {mean(idx, 'lib'):.6g}"
                + "".join(f" ({k[4:]} {mean(idx, k):.6g})" for k in lib_forms)
                + f", bound {mean(idx, 'bound'):.6g}")
        tot = {k: mean(range(len(inputs)), k) for k in per[0]}
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
                    "inputs": "; ".join(groups)})
        if lib_forms:
            out[-1]["library_forms_ms"] = {k[4:]: tot[k] for k in lib_forms}
        if name == "flash_attention":
            out[-1]["rel_err"] = attn_rel[0]
            out[-1]["planted_faults"] = attn_faults()
            log(f"flash_attention: largest relative error norm {attn_rel[0]:.3g}"
                f"; planted faults, each failing the check: "
                + json.dumps(out[-1]["planted_faults"]))

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
    stash = {p: {} for p in ("listing1", "fig4", "graphulo", "single",
                             "serve_a", "serve_b")}
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

    # 6. LM serving at full width
    serve_stats, serve_launches = serving(args.seed, stash, args.profile)
    launches.update(serve_launches)
    for run in ("serve_a", "serve_b"):
        st = serve_stats[run]
        log(f"phase 6 ({run}): " + json.dumps(
            {"tok_per_s": st["tok_per_s"], "wall_s": st["wall_s"],
             "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
             "decode_steps": st["decode_steps"],
             "tokens_out": st["tokens_out"], "batches": st["batches"],
             "launches": serve_launches[run]["flash_attention"]}))
    log(f"phase 6: peak device memory {serve_stats['peak_mem_gb']:.3f} GB")

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
