#!/usr/bin/env python3
"""Why the segment sum (``csrc/segment_sum.cu``) sits far above its bound,
on one NVIDIA GPU: times the one-atomic-per-entry kernel (the design before
the shared-memory slabs, ``segment_sum_direct``) and the slab kernel
(``segment_sum``) by CUDA-graph replay at the D4M 2.0 schema's degree
update: 1,048,576 float32 ones into 65,536 segments, with ids

  out_ids   the row ids of the Graph500 scale-16 graph (edge factor 16,
            ``--seed``), mapped to key ids as ``chip_smoke.py`` phase 4b
            maps them (the sorted vertex names' positions): power-law,
            hubs spread through the stream;
  in_ids    the column ids of the same graph;
  uniform   as many ids drawn uniformly over the same vertex range;
  sorted    out_ids sorted (each hub one run of equal ids).

If uniform ids run the direct kernel near the bound, hub contention on
single addresses is its cause. Beside each: ``index_add_`` on the same
ids, the output's memset alone, an empty kernel (the launch floor), the
bound (8 bytes read per entry and 4 written per segment at 3.35 TB/s), and
the slab kernel with parts cut out or resized, each an exact text edit of
the source built into ``build/ablation/`` (the script stops if an edit no
longer matches; only the variants marked exact compute the function):

  no_flush           the per-block flush of the bins skipped;
  no_shared_atomics  the entries read and tested, not added;
  float_sums         every block sums float32 (shared-memory float atomics,
                     compare-and-swap loops), never int32 (exact);
  half_chunks        half the chunks (exact);
  slab_16k           slabs of 16,384 bins (exact).

    python3 experiments/segment_sum_ablation.py [--seed N]

Prints the card's name and power limit, then one JSON object per input.
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
SRC = ROOT / "src" / "repro_torch" / "csrc" / "segment_sum.cu"
OUT = ROOT / "build" / "ablation"
N_SEGMENTS = 1 << 16  # chip_smoke.py's id_capacity
FLUSH = "if (x != 0.f) atomicAdd(out + s0 + b, x);"
ADD = "if (local < static_cast<unsigned>(width)) {"
CHOICE = "as_int = __syncthreads_and(ok);"
EDITS = {  # name: (edits, computes the function)
    "no_flush": ([(FLUSH, "if (x == -1.f) atomicAdd(out + s0 + b, x);")],
                 False),
    "no_shared_atomics": ([(ADD, "if (local < static_cast<unsigned>(width) "
                                 "&& v == -1.f) {")], False),
    "float_sums": ([(CHOICE, "as_int = __syncthreads_and(ok) && false;")],
                   True),
    "half_chunks": ([("long long chunks = resident / slabs;",
                      "long long chunks = resident / slabs / 2;")], True),
    "slab_16k": ([("constexpr int kSlabMax = 32768;",
                   "constexpr int kSlabMax = 16384;")], True),
}


def build_variants():
    """Write and compile every variant in parallel; returns {name: .so}."""
    text = SRC.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    procs = {}
    for name, (edits, _) in EDITS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: edit {old!r} matches "
                                 f"{src.count(old)} times")
            src = src.replace(old, new)
        cu, so = OUT / f"segsum_{name}.cu", OUT / f"segsum_{name}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(so)).segment_sum
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import PEAK_BYTES_PER_S, graph_ms
    from repro_torch.data.graph500 import graph500_triples
    from repro_torch.kernels import common
    from repro_torch.kernels.segment_reduce import (segment_sum,
                                                    segment_sum_direct,
                                                    segment_sum_ref)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    common.lib()
    variants = build_variants()
    t0 = time.perf_counter()
    r, c, _ = graph500_triples(16, 16, seed=args.seed)
    verts = np.union1d(r, c)
    out_ids, in_ids = np.searchsorted(verts, r), np.searchsorted(verts, c)
    rng = np.random.default_rng(args.seed)
    inputs = {"out_ids": out_ids, "in_ids": in_ids,
              "uniform": rng.integers(0, len(verts), len(r)),
              "sorted": np.sort(out_ids)}
    print(f"graph: {len(r)} ids over {len(verts)} vertices, host "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    def floor():
        stream = torch.cuda.current_stream().cuda_stream
        err = common.lib().launch_floor(stream)
        if err:
            raise RuntimeError(f"launch_floor: CUDA error {err}")
    floor_ms = graph_ms(floor, 200)
    memset_ms = graph_ms(lambda: torch.zeros(N_SEGMENTS, device="cuda"), 50)

    def variant(fn, ids, vals):
        out = torch.zeros(N_SEGMENTS, device="cuda")
        err = fn(ids.data_ptr(), vals.data_ptr(), ids.shape[0], N_SEGMENTS,
                 0, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"segment_sum variant: CUDA error {err}")
        return out
    for name, ids in inputs.items():
        counts = np.bincount(ids, minlength=N_SEGMENTS)
        ids = torch.as_tensor(ids.astype(np.int32), device="cuda")
        vals = torch.ones(ids.shape[0], device="cuda")
        want = segment_sum_ref(ids, vals, N_SEGMENTS)
        for fn in (segment_sum, segment_sum_direct):
            if not torch.equal(fn(ids, vals, N_SEGMENTS), want):
                raise AssertionError(f"{name}: {fn.__name__} differs")
        long_ids = ids.long()
        cut = {}
        for v, fn in variants.items():
            if EDITS[v][1] and not torch.equal(variant(fn, ids, vals), want):
                raise AssertionError(f"{name}: variant {v} differs")
            cut[v + "_ms"] = graph_ms(lambda: variant(fn, ids, vals), 50)
        print(json.dumps({
            "input": name, "card": card, "n": ids.shape[0],
            "n_segments": N_SEGMENTS, "distinct": int((counts > 0).sum()),
            "hottest": int(counts.max()),
            "direct_ms": graph_ms(
                lambda: segment_sum_direct(ids, vals, N_SEGMENTS), 50),
            "slab_ms": graph_ms(lambda: segment_sum(ids, vals, N_SEGMENTS),
                                50),
            "index_add_ms": graph_ms(lambda: torch.zeros(
                N_SEGMENTS, device="cuda").index_add_(0, long_ids, vals), 50),
            **cut, "memset_ms": memset_ms, "launch_floor_ms": floor_ms,
            "bound_ms": (8 * ids.shape[0] + 4 * N_SEGMENTS)
            / PEAK_BYTES_PER_S * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
