"""Observability tour of the PyTorch port: metrics registry, latency
histograms, span traces, and the dynamic-tablet view.

Ingests a Zipf-skewed graph through the D4M connector into a transpose
pair whose row table runs dynamic tablets (rebalanced between batches),
then walks the surfaces ``repro_torch.obs`` exposes:

  1. ``DBserver.metrics()``    — per-table/per-shard counters + p50/p99
                                 + derived health gauges + the ``tablets``
                                 section (count, balance, splits, moves,
                                 owners, boundaries)
  2. the raw ``Registry``      — labeled series, aggregation
  3. the ``Tracer``            — nested spans, slow-op log, flight
                                 recorder, Chrome export
  4. the exporters             — Prometheus text, health report,
                                 ``DBserver.debug_bundle``

  PYTHONPATH=src python examples/torch_observability.py [--device cpu]
      [--scale 15] [--out DIR]

``--scale`` is the log2 of the vertex-id space; files go to ``--out``.
"""
import argparse
import json
import os
import tempfile

import numpy as np

from repro_torch.db import dbinit, dbsetup
from repro_torch.obs import (default_registry, default_tracer, health_report,
                             prometheus_text, set_enabled)

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda")
ap.add_argument("--scale", type=int, default=15)
ap.add_argument("--out", default=None)
args = ap.parse_args()
out = args.out or tempfile.mkdtemp(prefix="obsdemo_")
n_ids = 1 << args.scale

dbinit()
DB = dbsetup("obsdemo", num_shards=4, capacity_per_shard=1 << 14,
             batch_cap=4096, id_capacity=1 << 16,
             memtable_cap=2048,  # small memtable: flushes show up in health
             dynamic_tablets=True, device=args.device)
T = DB["edges", "edgesT"]
store = T.table.store

# --- generate some traffic -------------------------------------------------
# the vertex names are interned in id order first, so the Zipf head of the
# row keys lands in the low ids of one tablet: the map splits and moves it
DB.encode_keys(np.asarray([f"v{i:05d}" for i in range(n_ids)], object))
rng = np.random.default_rng(0)
n = min(2000, 4 * n_ids)
for batch in range(8):
    src = np.asarray([f"v{int(i):05d}" for i in
                      rng.zipf(1.6, n) % n_ids], object)
    dst = np.asarray([f"v{int(i):05d}" for i in
                      rng.integers(0, n_ids, n)], object)
    T.put_triple(src, dst, np.ones(n))
    if batch % 2:
        store.maybe_rebalance()
for _ in range(50):
    v = f"v{int(rng.integers(0, n_ids)):05d},"
    T[v, :]                       # point reads (fused single-dispatch)
T[f"v00000,:,v{min(200, n_ids - 1):05d},", :]  # a range read across splits

# --- 1. the server-level snapshot ------------------------------------------
m = DB.metrics()
tab = m["tables"]["edges"]
lat = tab["latency_s"]
print(f"engine={tab['engine']}  "
      f"flushes={tab['counters']['flushes']}  "
      f"fused_dispatches={tab['counters']['fused_dispatches']}")
for op in ("ingest", "query", "scan"):
    s = lat[op]
    if s["count"]:
        print(f"  {op:6s} n={s['count']:<5d} p50={s['p50'] * 1e6:8.0f}us "
              f"p99={s['p99'] * 1e6:8.0f}us")
for shard, rec in sorted(tab["shards"].items()):
    print(f"  shard {shard}: ingested={rec['ingest_entries']:>6,} "
          f"point_queries={rec['point_queries']:>4}")
tb = tab["tablets"]
print(f"tablets: {tb['count']} (splits {tb['splits']}, moves {tb['moves']}),"
      f" balance {tb['balance']:.3f}, owners {tb['owners']}, "
      f"boundaries {tb['boundaries']}")
assert tb["count"] == store.tablet_map.n and tb["splits"] > 0
assert "tablets" not in m["tables"].get("edgesT", {})
DB.dump_metrics(os.path.join(out, "metrics.json"))
print(f"full snapshot -> {out}/metrics.json")

# --- 2. the registry directly ----------------------------------------------
reg = default_registry()
probes = reg.aggregate("lsm_runs_probed", table="edges")
skips = reg.aggregate("lsm_runs_skipped", table="edges")
print(f"bloom/fence filtering: probed={probes} skipped={skips}")
h = reg.aggregate("db_op_latency_s", table="edges", op="query")
if h and h["count"]:
    print(f"query latency (merged across calls): mean={h['mean'] * 1e6:.0f}us "
          f"p999={h['p999'] * 1e6:.0f}us")

# --- 3. span traces --------------------------------------------------------
tr = default_tracer()
spans = tr.spans()
print(f"\n{len(spans)} spans in the ring; last query breakdown:")
for rec in [r for r in spans if r["name"] in
            ("query.fused", "dispatch", "host_sync")][-3:]:
    print(f"  {'  ' * rec['depth']}{rec['name']:<12s} "
          f"{rec['dur'] * 1e6:8.1f}us  (parent={rec['parent']})")
slow = tr.slow_ops()
if slow:
    worst = max(slow, key=lambda r: r["dur"])
    print(f"slow ops (>= {tr.slow_threshold_s * 1e3:.0f}ms): {len(slow)}, "
          f"worst = {worst['name']} at {worst['dur'] * 1e3:.1f}ms")
tr.export_chrome(os.path.join(out, "trace.json"))
print(f"chrome trace -> {out}/trace.json")
flights = tr.flight_recordings()
if flights:
    print(f"flight recorder: {len(flights)} slow-op trees")

# --- 4. exporters + debug bundle -------------------------------------------
health = tab["health"]
print(f"\nhealth: read_amp={health['read_amplification']:.2f} "
      f"write_amp={health['write_amplification']:.2f}")
prom = prometheus_text()
print(f"prometheus exposition: {len(prom.splitlines())} lines, "
      f"{sum('lsm_tablet' in l for l in prom.splitlines())} tablet lines")
print(health_report(fmt="term").splitlines()[0], "... (health_report)")
DB.debug_bundle(os.path.join(out, "bundle.zip"))
print(f"debug bundle -> {out}/bundle.zip")

# --- kill switch -----------------------------------------------------------
set_enabled(False)               # every instrument becomes a no-op
before = json.dumps(reg.snapshot("db_point_queries"))
T[f"v{int(rng.integers(0, n_ids)):05d},", :]
assert json.dumps(reg.snapshot("db_point_queries")) == before
set_enabled(True)
print("set_enabled(False) verified: reads leave no metric trace")
print("OK")
