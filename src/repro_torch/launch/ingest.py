"""SPMD-ingest launcher + dry run (the JAX package's ``launch/ingest.py``).

``--dryrun`` runs rank 0's step of the ``make_spmd_ingest_step`` ingest
(bucket -> all_to_all -> minor compaction) on the ingest axis of the
production meshes, in a fake world of 256 (or 512) ranks: one ingestor
per (pod, data) shard, as in the JAX package, on the CPU. The tensors are
real: the compaction depends on the values, and the fake group's
all-to-all leaves the receive buffer as it is. It prints the per-rank
argument and temporary bytes and the collectives the step ran.

  PYTHONPATH=src python -m repro_torch.launch.ingest --dryrun --mesh both
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..db.spmd import make_spmd_ingest_step, stacked_empty
from ..models.spec import axis_sizes
from .mesh import make_production_mesh
from .op_cost import OpCost


def dryrun(multi_pod: bool, capacity: int = 1 << 20, batch_cap: int = 1 << 15,
           id_capacity: int = 1 << 22, seed: int = 0):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed._tools.mem_tracker import MemTracker
    mesh = make_production_mesh(multi_pod, fake=True)
    sizes = axis_sizes(mesh)
    s = sizes["data"] * sizes.get("pod", 1)
    # ingest axis = flattened (pod, data): one ingestor per data shard
    flat = DeviceMesh("cpu", list(range(s)), mesh_dim_names=("data",))
    step = make_spmd_ingest_step(flat, "data", s, id_capacity=id_capacity)
    step = getattr(step, "__wrapped__", step)  # no host-side metrics
    tablet = stacked_empty(capacity, device="cpu")
    rng = np.random.default_rng(seed)
    br = torch.from_numpy(rng.integers(0, id_capacity, batch_cap,
                                       dtype=np.int32))
    bc = torch.from_numpy(rng.integers(0, id_capacity, batch_cap,
                                       dtype=np.int32))
    bv = torch.ones(batch_cap, dtype=torch.float32)
    args = (tablet.rows, tablet.cols, tablet.vals, tablet.n, br, bc, bv)
    arg_bytes = sum(t.numel() * t.element_size() for t in args)
    mem = MemTracker()
    with OpCost() as counter, mem:
        step(tablet, br, bc, bv)
    peak = mem.get_tracker_snapshot("peak")
    temp_bytes = max((v["Total"] for v in peak.values()), default=0)
    colls = dict(counter.cost.coll_counts)
    tag = f"2x16x16(flat {s})" if multi_pod else f"16x16(flat {s})"
    print(f"[ingest dry-run × {tag}] ingestors={s} "
          f"args={arg_bytes/1e9:.2f}GB "
          f"temps={temp_bytes/1e9:.2f}GB colls={colls}")
    return {"mesh": tag, "ingestors": s, "colls": colls,
            "arg_bytes": arg_bytes, "temp_bytes": temp_bytes}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    args = ap.parse_args(argv)
    if args.dryrun:
        recs = []
        if args.mesh in ("single", "both"):
            recs.append(dryrun(False))
        if args.mesh in ("multi", "both"):
            recs.append(dryrun(True))
        return recs
    raise SystemExit("only --dryrun is supported in this container")


if __name__ == "__main__":
    main()
