#!/usr/bin/env python3
"""The 1-D rank (``csrc/rank.cu``) and the single engine's point read on
one NVIDIA GPU, at the shapes of ``chip_smoke.py`` phase 4c: the tablet of
the shard that owns the most row vertices of the Graph500 scale-16 graph
(edge factor 16, ``--seed``; its distinct entries sorted by (row, col),
then I32_MAX pads up to 1.3 x the largest shard, as ``chip_smoke.py``
sizes it) and 1,024 of that shard's row vertices as queries.

Times by CUDA-graph replay, each result first held equal to
``torch.searchsorted``:

  warp32      the kernel as built: 32 lanes a (query, side), both sides in
              one launch (and each side alone);
  warp16      an exact text edit of the source built into
              ``build/ablation/``: 16 lanes a (query, side), so one warp
              takes both sides of a query (16-ary levels, one more);
  binary      the one-thread binary search it replaced, one launch per
              side, and both sides in one launch;
  searchsorted  ``torch.searchsorted``, one call per side;

then the gather (``tablet_gather``) at the read's ranks, and the read as a
whole: ``tablet_read``, and the route it replaced (``chip_smoke.py``'s
``padded_read`` on the binary search), in turns (new, old, old, new) with
CUDA events around the eager calls (their host syncs keep them out of a
graph), and the device time of each under torch.profiler (the kernels and
copies it ran, device-side events only); and an empty kernel (the launch
floor).

    python3 experiments/rank_read_ablation.py [--seed N]

Prints the card's name and power limit, then one JSON object.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "rank.cu"
OUT = ROOT / "build" / "ablation"
EDITS = {"warp16": [("constexpr int kGroup = 32;",
                     "constexpr int kGroup = 16;")]}


def build_variants():
    """Write and compile every variant in parallel; returns {name: fn}."""
    text = SRC.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    procs = {}
    for name, edits in EDITS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: edit {old!r} matches "
                                 f"{src.count(old)} times")
            src = src.replace(old, new)
        cu, so = OUT / f"rank_{name}.cu", OUT / f"rank_{name}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    fns = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(so)).rank
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def shard_read(seed):
    """(rows, cols, vals, q) of phase 4c's row-id read, as numpy."""
    import numpy as np
    from repro_torch.data.graph500 import graph500_triples
    from repro_torch.db.kvstore import shard_of
    r, c, _ = graph500_triples(16, 16, seed=seed)
    verts = np.union1d(r, c)
    key = np.unique(np.searchsorted(verts, r).astype(np.int64) << 16
                    | np.searchsorted(verts, c))
    rid, cid = (key >> 16).astype(np.int32), (key & 0xFFFF).astype(np.int32)
    counts = np.maximum(np.bincount(shard_of(rid, 4, 1 << 16), minlength=4),
                        np.bincount(shard_of(cid, 4, 1 << 16), minlength=4))
    cap = max(1 << 12, int(counts.max() * 1.3))
    row_v = np.unique(rid)
    owner = shard_of(row_v, 4, 1 << 16)
    s = int(np.argmax(np.bincount(owner, minlength=4)))
    rng = np.random.default_rng(seed)
    q = rng.choice(row_v[owner == s], 1024, replace=False).astype(np.int32)
    mine = shard_of(rid, 4, 1 << 16) == s
    n = int(mine.sum())
    rows = np.full(cap, 2 ** 31 - 1, np.int32)
    cols = np.full(cap, 2 ** 31 - 1, np.int32)
    rows[:n], cols[:n] = rid[mine], cid[mine]  # key order is (row, col)
    vals = np.zeros(cap, np.float32)
    vals[:n] = rng.integers(1, 9, n)
    return rows, cols, vals, q


def device_ms(fn, reps):
    """Mean device time of ``fn()`` per call under torch.profiler: the
    kernels and copies it ran (device-side events), host gaps left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(ka[0], "self_device_time_total") else
           "self_cuda_time_total")
    return sum(getattr(e, key) for e in ka
               if e.device_type != DeviceType.CPU) / 1e3 / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import PEAK_BYTES_PER_S, cuda_ms, graph_ms, padded_read
    from repro_torch.kernels import common
    from repro_torch.kernels.sorted_search import (rank, rank_binary,
                                                   tablet_gather, tablet_read)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    common.lib()
    variants = build_variants()
    t0 = time.perf_counter()
    rows, cols, vals, q = (torch.as_tensor(x, device="cuda")
                           for x in shard_read(args.seed))
    print(f"tablet: {rows.shape[0]} slots, "
          f"{int((rows != 2 ** 31 - 1).sum())} entries; Q = {q.shape[0]}; "
          f"host {time.perf_counter() - t0:.3f} s", flush=True)
    want = torch.stack([torch.searchsorted(rows, q, right=r, out_int32=True)
                        for r in (False, True)])

    def variant(fn, sides):
        out = torch.empty((2, q.shape[0]) if sides == 2 else q.shape[0],
                          dtype=torch.int32, device="cuda")
        err = fn(rows.data_ptr(), rows.shape[0], q.data_ptr(), q.shape[0],
                 sides, 0, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"rank variant: CUDA error {err}")
        return out

    ranks = {
        "warp32_both": lambda: rank(rows, q, "both"),
        "warp32_left": lambda: rank(rows, q, "left"),
        "warp16_both": lambda: variant(variants["warp16"], 2),
        "warp16_left": lambda: variant(variants["warp16"], 0),
        "binary_both": lambda: rank_binary(rows, q, "both"),
        "binary_two_launches": lambda: torch.stack(
            [rank_binary(rows, q, s) for s in ("left", "right")]),
        "searchsorted_two_calls": lambda: torch.stack(
            [torch.searchsorted(rows, q, right=r, out_int32=True)
             for r in (False, True)])}
    res = {"card": card, "n": rows.shape[0], "q": q.shape[0]}
    for name, fn in ranks.items():
        got = fn()
        if not torch.equal(got, want if got.dim() == 2 else want[0]):
            raise AssertionError(f"{name} differs from searchsorted")
        res[name + "_ms"] = graph_ms(fn, 100)
    # the timed forms without the stack the check needs
    res["binary_two_launches_ms"] = graph_ms(
        lambda: [rank_binary(rows, q, s) for s in ("left", "right")], 100)
    res["searchsorted_two_calls_ms"] = graph_ms(
        lambda: [torch.searchsorted(rows, q, right=r, out_int32=True)
                 for r in (False, True)], 100)
    ends = torch.cumsum(want[1] - want[0], 0, dtype=torch.int32)
    total = int(ends[-1])
    res["entries"] = total
    res["gather_ms"] = graph_ms(
        lambda: tablet_gather(cols, vals, want[0], ends, q, total), 100)
    res["gather_bound_ms"] = (20 * total + 12 * q.shape[0]) \
        / PEAK_BYTES_PER_S * 1e3

    def old_block(w):
        start, end = (rank_binary(rows, q, s) for s in ("left", "right"))
        idx = start[:, None] + torch.arange(w, dtype=torch.int32,
                                            device="cuda")[None, :]
        idxc = idx.clamp(0, rows.shape[0] - 1).long()
        return cols[idxc], vals[idxc], idx < end[:, None], end - start
    new, old = tablet_read(rows, cols, vals, q), padded_read(old_block, q)
    if not all(torch.equal(a, b) for a, b in zip(new, old)):
        raise AssertionError("tablet_read differs from the padded read")
    routes = {"route_ms": lambda: tablet_read(rows, cols, vals, q),
              "old_route_ms": lambda: padded_read(old_block, q)}
    for key in ("route_ms", "old_route_ms", "old_route_ms", "route_ms"):
        res.setdefault(key, []).append(cuda_ms(routes[key], 50))
    for key, fn in routes.items():
        res[key.replace("_ms", "_device_ms")] = device_ms(fn, 20)

    def floor():
        err = common.lib().launch_floor(
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch_floor: CUDA error {err}")
    res["launch_floor_ms"] = graph_ms(floor, 200)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
