"""Graph analytics on the PyTorch port's D4M store: Graph500 ingest with
the D4M 2.0 schema (edge + transpose + degree tables), degree-table
queries, BFS via associative-array products, and one BFS step on the ELL
SpMV kernel held against its plain version.

  PYTHONPATH=src python examples/torch_graph_analytics.py [--device cpu]
      [--scale 10]

On the card (the default) the store runs the hand kernels and the SpMV
step launches the ELL kernel; with ``--device cpu`` both run their plain
PyTorch versions.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import Assoc
from repro_torch.data.graph500 import graph500_triples
from repro_torch.db import EdgeSchema, dbsetup
from repro_torch.kernels.spmv import ell_from_coo, spmv_ell, spmv_ell_ref

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda")
ap.add_argument("--scale", type=int, default=10)
args = ap.parse_args()
dev = torch.device(args.device)

# --- ingest with the D4M 2.0 schema (edge + transpose + degree tables) -----
server = dbsetup("analytics", num_shards=4, capacity_per_shard=1 << 17,
                 batch_cap=1 << 15, id_capacity=1 << 20,
                 use_pallas=dev.type == "cuda", device=dev)
g = EdgeSchema(server, "g500")
rows, cols, vals = graph500_triples(args.scale, 16, seed=7)
t0 = time.perf_counter()
g.put_triple(rows, cols, vals)
dt = time.perf_counter() - t0
print(f"ingested {len(rows):,} edges in {dt:.2f}s "
      f"({len(rows) / dt:,.0f} edges/s) on {dev}, nnz={g.nnz():,}")

# --- degree-table analytics (the Fig. 4 query-planning path) ---------------
deg = g.deg.degrees(":")
top = (deg[:, "OutDeg,"]).triples()
hub = top[0][np.argmax(top[2])]
print(f"max out-degree vertex: {hub} (deg {int(top[2].max())})")
hubs = g.deg.vertices_with_degree(float(top[2].max()), "out", tol=2.0)
print(f"vertices within 2x of max degree: {len(hubs)}")

# --- BFS from the hub via assoc products (paper Fig. 1) --------------------
frontier = Assoc(np.asarray(["seed"], object), np.asarray([hub], object), 1.0)
visited = set()
for hop in range(3):
    adj = g[("".join(str(v) + "," for v in frontier.col)), :]
    frontier = frontier * adj
    new = set(frontier.col) - visited
    visited |= new
    print(f"hop {hop + 1}: frontier {len(frontier.col):>6,} vertices "
          f"({len(new):,} new)")

# --- the first BFS step on the ELL SpMV kernel ------------------------------
rid = server.keydict.lookup(rows)
cid = server.keydict.lookup(cols)
n = int(max(rid.max(), cid.max())) + 1
ell_cols, ell_vals = ell_from_coo(np.sort(cid), rid[np.argsort(cid)],
                                  np.ones(len(rid), np.float32), n)
x = np.zeros(n, np.float32)
x[server.keydict.get(hub)] = 1.0
ell = [torch.as_tensor(a, device=dev) for a in (ell_cols, ell_vals, x)]
y_kernel = spmv_ell(*ell).cpu().numpy()
y_ref = spmv_ell_ref(*ell).cpu().numpy()
np.testing.assert_allclose(y_kernel, y_ref, rtol=1e-5)
reach = int((y_kernel > 0).sum())
first = Assoc(np.asarray(["seed"], object), np.asarray([hub], object), 1.0)
assert reach == len((first * g[hub + ",", :]).col), reach
print(f"SpMV kernel BFS step: {reach:,} reachable vertices (equal to the "
      f"plain version and to the first assoc hop)")
g.delete()
print("OK")
