"""The harness against the port on the CPU, at Graph500 scale 7: each
configuration under each traffic mix (the cells of BENCHMARK.json among
them), run small, is correct as the port stands; the control and each
planted fault that the pair can have make it not correct."""
import contextlib
import json
import time

import numpy as np
import pytest
import torch

from portbench import control, harness

CONFIG = {"scale": 7, "server": {"id_capacity": 128, "memtable_cap": 512,
                                 "batch_cap": 256, "use_pallas": False}}
MIXES = {
    "ingest": {"graphs": 16, "ops": [{"op": "put", "triples": 256}]},
    "bulk-read": {"pool": 8, "ops": [
        {"op": "read", "axis": "row", "select": "ids", "count": 16,
         "shard": "largest"},
        {"op": "read", "axis": "col", "select": "ids", "count": 8},
        {"op": "read", "axis": "row", "select": "range", "span": 20,
         "at": 0.015625},
        {"op": "read", "axis": "col", "select": "range", "span": 20,
         "at": 0.125}]},
    "fig4-query": {"pool": 16, "ops": [
        {"op": "read", "axis": "row", "select": "ids", "count": 1,
         "degree": [1, 10], "near": 8},
        {"op": "read", "axis": "col", "select": "ids", "count": 5,
         "degree": [1, 10], "near": 8}]},
}
# a mix of puts and reads, which no file has yet: data alone makes it
MIXED = {"loop": "closed", "clients": 1, "graphs": 16, "preload": 1,
         "pool": 4, "order": "cycle", "weights": {"put": 2, "read": 1},
         "ops": [{"op": "put", "triples": 256},
                 {"op": "read", "axis": "row", "select": "ids", "count": 8},
                 {"op": "read", "axis": "col", "select": "range",
                  "span": 10, "at": 0.25}]}
BENCH = harness.load_bench()
# the d4m2 ingest cell, out of BENCHMARK.json while its rate spreads more
# than a bound can hold (PERF.md), as its entries would list it: its readers
# stay, and are read here
INGEST = "d4m2-g500-s20.ingest"
INGEST_ENTRIES = {
    "workloads": [{"name": INGEST, "config": "d4m2-g500-s20",
                   "traffic": "ingest", "chips": 1, "why": "d4m2 ingest"}],
    "end_to_end": [{"name": "ingest_entries_per_s", "unit": "entries/s",
                    "better": "higher", "bound": 0.25,
                    "source": "host_clock", "workloads": [INGEST]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": "lower", "source": source,
         "layer": layer, "moves": "ingest_entries_per_s",
         "workloads": [INGEST]}
        for name, unit, source, layer in (
            ("connector.encode_pct", "%", "host_clock", "Connector"),
            ("schema.degree_pct", "%", "host_clock", "Schema"),
            ("lsm.compaction_pct", "%", "program_span", "Engine"),
            ("put_p95_ms", "ms", "host_clock", "Store"),
            ("lsm.merge_roofline", "%", "device_trace", "Kernels"),
            ("device.idle_pct.ingest", "%", "device_trace", "Device"))]}
CONFIGS = sorted(p.stem for p in (harness.HERE / "configs").glob("*.json"))
PAIRS = [f"{c}.{t}" for c in CONFIGS for t in MIXES]
CELLS = [c["name"] for c in BENCH["workloads"]]
assert set(CELLS) <= set(PAIRS)


def small_run(pair, seed=3_000_000_007, trace=False, config=None, mix=None,
              seconds=0.2):
    name, traffic = pair.rsplit(".", 1)
    return harness.run(
        name, traffic, seed, seconds, trace, time.perf_counter(),
        device="cpu", overrides={"config": dict(CONFIG, **(config or {})),
                                 "mix": mix or MIXES[traffic]},
        log=lambda *a, **k: None)[0]


@pytest.mark.parametrize("workload", PAIRS)
def test_cell_is_correct_on_the_port(workload):
    result = small_run(workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {
        m["name"] for m in harness.cell_metrics(BENCH, workload, False)}


@pytest.mark.parametrize("workload", PAIRS)
def test_control_is_not_correct(workload):
    with control.min_combiner():
        result = small_run(workload)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("config", CONFIGS)
def test_a_mix_of_puts_and_reads_needs_only_data(config):
    result = small_run(f"{config}.ingest", mix=MIXED, seconds=0.5)
    assert result["correct"], result["checks"]
    assert {"answers_wrong", "tedge_wrong"} <= set(result["checks"])
    with answer_altered():
        assert not small_run(f"{config}.ingest", mix=MIXED)["correct"]


@pytest.mark.parametrize("fused", [True, False])
def test_server_settings_go_to_the_port_as_they_stand(monkeypatch, fused):
    from repro_torch.db import connector
    seen = []
    real = connector.dbsetup

    def spy(*a, **kw):
        seen.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(connector, "dbsetup", spy)
    import repro_torch.db
    monkeypatch.setattr(repro_torch.db, "dbsetup", spy)
    result = small_run(CELLS[-1], config={"server": dict(
        CONFIG["server"], fused_reads=fused)})
    assert result["correct"], result["checks"]
    assert seen[0]["fused_reads"] is fused
    assert seen[0]["engine"] == "lsm"


def test_a_stream_that_is_spent_fails_the_run():
    mix = dict(MIXES["ingest"], graphs=1)
    result = small_run(INGEST, mix=mix, seconds=60)
    assert result["failed"] == 1 and not result["correct"]
    with open(harness.HERE / "traffic" / "ingest.json") as f:
        graphs = json.load(f)["graphs"]
    assert graphs >= 4


@contextlib.contextmanager
def patched(obj, attr, make):
    fn = getattr(obj, attr)
    setattr(obj, attr, make(fn))
    try:
        yield
    finally:
        setattr(obj, attr, fn)


def _store():
    from repro_torch.db import kvstore
    return kvstore.ShardedTable


def _table():
    from repro_torch.db import connector
    return connector.Table


def put_unchanged():
    """A put that leaves the store as it was."""
    return patched(_store(), "insert", lambda fn: lambda self, *a, **k: None)


def put_half():
    """Half of every batch left out."""
    def make(fn):
        def put(self, rows, cols, vals):
            n = len(rows) // 2
            return fn(self, rows[:n], cols[:n], vals[:n])
        return put
    return patched(_table(), "put_triple", make)


def value_altered():
    """One value of every batch altered where the store takes it."""
    def make(fn):
        def insert(self, rows, cols, vals, *a, **k):
            vals = np.array(vals, np.float32)
            vals[0] += 1.0
            return fn(self, rows, cols, vals, *a, **k)
        return insert
    return patched(_store(), "_insert_batch", make)


def answer_half():
    """Half of every read's answer left out."""
    def make(fn):
        def assemble(self, rid, cid, val):
            n = (len(rid) + 1) // 2
            return fn(self, rid[:n], cid[:n], val[:n])
        return assemble
    return patched(_table(), "_assemble", make)


def answer_altered():
    """One value of every read's answer altered where it is produced."""
    def make(fn):
        def assemble(self, rid, cid, val):
            val = np.array(val, np.float32)
            if len(val):
                val[-1] += 1.0
            return fn(self, rid, cid, val)
        return assemble
    return patched(_table(), "_assemble", make)


FAULTS = {"ingest": (put_unchanged, put_half, value_altered),
          "bulk-read": (put_unchanged, answer_half, answer_altered),
          "fig4-query": (put_unchanged, answer_half, answer_altered)}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in PAIRS for f in FAULTS[w.rsplit(".", 1)[1]]],
    ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_planted_fault_is_not_correct(workload, fault):
    with fault():
        result = small_run(workload)
    assert not result["correct"], result["checks"]


@pytest.fixture
def with_ingest_cell(monkeypatch):
    """BENCHMARK.json with the d4m2 ingest cell's entries back in it."""
    bench = json.loads(json.dumps(BENCH))
    for key, entries in INGEST_ENTRIES.items():
        bench[key] += entries
    monkeypatch.setattr(harness, "load_bench", lambda: bench)


def test_traced_run_reads_its_metrics_on_the_cpu(with_ingest_cell):
    result = small_run(INGEST, trace=True)
    assert result["correct"]
    assert {"connector.encode_pct", "schema.degree_pct", "put_p95_ms",
            "lsm.compaction_pct"} <= set(result["metrics"])
    # no device ran: no device metric may read anything
    assert not {"device.idle_pct.ingest", "lsm.merge_roofline"} & set(
        result["metrics"])


@pytest.mark.gpu
def test_cells_are_correct_on_the_card_at_a_small_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for workload in CELLS:
        name, traffic = workload.rsplit(".", 1)
        result, _ = harness.run(
            name, traffic, 11, 0.5, True, time.perf_counter(),
            device="cuda", overrides={
                "config": dict(CONFIG, server=dict(CONFIG["server"],
                                                   use_pallas=True)),
                "mix": MIXES[traffic]},
            log=lambda *a, **k: None)
        assert result["correct"], (workload, result["checks"])
        assert result["device"]["busy_s"] > 0


def test_a_reader_can_ask_for_spans(monkeypatch, with_ingest_cell):
    """A metric's ``SPANS`` are timed in a traced run, each call once."""
    real = harness.load_metric

    def load(name):
        mod = real(name)
        if name == "put_p95_ms":
            mod.SPANS = [("test.lookup", "server.keydict", "lookup"),
                         ("test.encode", "server", "encode_keys")]
            mod.read = lambda ctx: (ctx.spans.get("test.lookup", 0.0)
                                    + 1e6 * ("test.encode" in ctx.spans))
        return mod
    monkeypatch.setattr(harness, "load_metric", load)
    result = small_run(INGEST, trace=True)
    assert result["correct"]
    # the schema's second lookups were timed; encode_keys only once, by
    # the system's own span
    assert 0 < result["metrics"]["put_p95_ms"]["value"] < 1e6
