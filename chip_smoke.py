#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Drives the paper's Listing-1 database path through the connector a user
calls — ``dbsetup`` → bind the ``Tedge``/``TedgeT`` pair → ``put`` →
row, column and range reads → ``delete`` — on a Graph500 graph, builds the
hand-written CUDA kernels from ``src/repro_torch/csrc``, shows that the
path launched each of them, and holds each kernel against its plain
PyTorch version at the path's shapes.

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
  5. each kernel against its plain version on the card at every input
     geometry the main path gave it (recorded in phase 3), ranks exactly
     equal, with kernel / plain / library-call times per launch (CUDA
     graphs and CUDA events), averaged over the path's launches.

The second-to-last line is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device
or without the repository's sources.
"""
import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks: the HBM rate (NVIDIA data sheet), and the 32-bit integer
# rate for the rank kernels' compares and adds: 64 int32 add/compare
# results per clock per SM (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0) x 132 SMs x 1.98 GHz
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 64 * 132 * 1.98e9

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


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
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
    """Stands in for a kernel wrapper where an ops module calls it, while
    phase 3 runs: every call goes on to the wrapper (which launches and
    counts as before), and for each distinct input geometry the recorder
    keeps one copy of the inputs and the number of calls it got."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = {}  # geometry -> [calls, (args, kwargs) copy]

    def __call__(self, *args, **kw):
        geo = (tuple(tuple(a.shape) if hasattr(a, "shape") else a
                     for a in args), tuple(sorted(kw.items())))
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
    inputs of every kernel launch are recorded for phase 5. With ``profile_dir`` set, the put and
    each read run under torch.profiler (their times then include its
    cost)."""
    import contextlib

    import numpy as np
    from repro_torch.db import dbsetup, delete, put
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.merge_rank import ops as merge_ops
    from repro_torch.kernels.sorted_search import ops as search_ops

    A, verts, sels = graph["A"], graph["verts"], graph["sels"]
    DB = dbsetup("smoke", num_shards=4, id_capacity=1 << 16,
                 batch_cap=1 << 15, memtable_cap=1 << 16,
                 capacity_per_shard=cap, use_pallas=use_pallas)
    # the vertex names are interned in sorted order first (a sorted bulk
    # load), so string ranges map to contiguous ids and run as scans
    DB.encode_keys(np.asarray(verts, dtype=object))
    Tedge = DB["Tedge", "TedgeT"]
    # flush + compaction once on the empty store (no state changes): the
    # kernel build, CUDA context and allocator warm-up stay off the clock
    Tedge.table.store.warmup()

    def timed(label, fn):
        if profile_dir is not None:
            path = "kernels" if use_pallas else "ops"
            return profiled(f"{path}_{label}", fn, profile_dir)
        t0 = clock()
        result = fn()
        return result, clock() - t0

    with contextlib.ExitStack() as rec:
        if stash is not None:
            stash["rank_batched"] = rec.enter_context(
                Recorder(search_ops, "rank_batched"))
            stash["row_rank"] = rec.enter_context(
                Recorder(merge_ops, "row_rank"))
            stash["pair_rank"] = rec.enter_context(
                Recorder(merge_ops, "pair_rank"))
        reset_launches()
        _, t_put = timed("put", lambda: put(Tedge, A))
        reads, times = {}, {"put_s": t_put,
                            "ingest_entries_per_s": A.nnz() / t_put}
        for name, sel in sels.items():
            reads[name], times[name + "_s"] = timed(name, lambda: Tedge[sel])
        launches = dict(LAUNCHES)
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
    return {"A": A, "verts": verts, "sels": sels}, cap


# ------------------------------------------------------------------ phase 5
def kernel_checks(stash, launches):
    """Each kernel against its plain version at every input geometry the
    main path gave it (recorded in phase 3). Every time is the mean per
    launch over the path's launches, so ms x launches is the kernel's
    device time on the path."""
    import numpy as np
    import torch
    from repro_torch.kernels.common import I32_MAX
    from repro_torch.kernels.merge_rank import (pair_rank, pair_rank_ref,
                                                row_rank, row_rank_ref)
    from repro_torch.kernels.sorted_search import (rank_batched,
                                                   rank_batched_ref)

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    out = []

    def check(name, got, want):
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{name}: {bad} ranks differ from plain")
        return float((got.long() - want.long()).abs().max())

    def steps(n):  # probe steps of a binary search over n entries
        return max(1, math.ceil(math.log2(n + 1)))

    # bytes: each input read once, each output written once; operations:
    # a compare and an add per probe step (rank search) or per pair (row
    # rank), three compares and a select per probe step (pair rank)
    def search_cost(args, kw):
        tabs, qq = args
        k, n = tabs.shape
        return (4 * (k * n + qq.numel() + k * qq.numel()),
                2 * k * qq.numel() * steps(n))

    def row_cost(args, kw):
        (keys,) = args
        return 4 * 2 * keys.numel(), 2 * keys.shape[0] * keys.shape[1] ** 2

    def pair_cost(args, kw):
        tr, _, qr, _ = args
        return (4 * (2 * tr.numel() + 3 * qr.numel()),
                4 * qr.numel() * steps(tr.shape[1]))

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

    specs = (  # name, kernel, plain, cost, library, plain timing reps
        ("rank_batched", rank_batched, rank_batched_ref, search_cost,
         search_lib, (20, 3), "src/repro_torch/csrc/rank_batched.cu",
         "src/repro/kernels/sorted_search/kernel.py:66"),
        ("row_rank", row_rank, row_rank_ref, row_cost, None, (20, 3),
         "src/repro_torch/csrc/row_rank.cu",
         "src/repro/kernels/merge_rank/kernel.py:67"),
        # the plain pair rank is a chunked quadratic count (up to ~1e11
        # compares at a level run): one timed call, no warm-up
        ("pair_rank", pair_rank, pair_rank_ref, pair_cost, pair_lib, (1, 0),
         "src/repro_torch/csrc/pair_rank.cu",
         "src/repro/kernels/merge_rank/kernel.py:36"),
    )
    for name, fn, ref, cost, lib, (p_reps, p_warm), src, tpu in specs:
        calls = stash[name].calls
        n_calls = sum(c for c, _ in calls.values())
        if n_calls != launches[name]:
            raise AssertionError(f"{name}: recorded {n_calls} calls, "
                                 f"{launches[name]} launches")
        err, tot = 0.0, dict.fromkeys(("ms", "eager", "plain", "lib", "bound"),
                                      0.0)
        ops_by = [0.0, 0.0]
        for cnt, (args, kw) in calls.values():
            err = max(err, check(name, fn(*args, **kw), ref(*args, **kw)))
            w = cnt / n_calls
            tot["ms"] += w * graph_ms(lambda: fn(*args, **kw), 50)
            tot["eager"] += w * cuda_ms(lambda: fn(*args, **kw), 50)
            tot["plain"] += w * cuda_ms(lambda: ref(*args, **kw), p_reps,
                                        warm=p_warm)
            if lib is not None:
                tot["lib"] += w * graph_ms(lib(args, kw), 50)
            b, by = bound_ms(*cost(args, kw))
            tot["bound"] += w * b
            ops_by[by == "operations"] += w * b
        geos = sorted(calls, key=lambda g: -calls[g][0])
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": tpu, "launches": launches[name],
                    "max_abs_err": err, "ms": tot["ms"],
                    "plain_ms": tot["plain"], "bound_ms": tot["bound"],
                    "bound_by": ("operations" if ops_by[1] > ops_by[0]
                                 else "bytes"),
                    "library_ms": tot["lib"] if lib else None,
                    "eager_ms": tot["eager"],
                    "shapes": "; ".join(
                        f"{calls[g][0]}x " + " ".join(
                            str(list(x)) if isinstance(x, tuple) else str(x)
                            for x in g[0]) + "".join(
                            f" {k}={v}" for k, v in g[1])
                        for g in geos)})

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
    stash = {}
    reads, stats, times, launches = listing1(graph, True, cap, stash)
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
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"phase 3: kernel {k} never launched")
    log("phase 3 (use_pallas=True): " + json.dumps(
        {"times": times, "engine": tot, "launches": launches,
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
