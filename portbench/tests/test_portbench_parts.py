"""The harness's parts without a run: the vertex keys, the generator, the
import check, the trace reduction, the readers, and a run with no card or
no program."""
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import graphs, harness, measure
from portbench.generators import kronecker
from portbench.ops import read
from portbench.systems.d4m_reference import EdgeReference


def test_vertex_names_equal_the_ports_keys():
    from repro_torch.data.graph500 import vertex_strings
    n = 5000
    got = graphs.vertex_names(n)
    assert got.dtype == object and list(got) == list(
        vertex_strings(np.arange(n)))
    assert graphs.name_index(got)["v00004999"] == 4999


def test_kronecker_bits_follow_graph500():
    gen = torch.Generator().manual_seed(3)
    rows, cols = kronecker.kronecker(10, 64, (0.57, 0.19, 0.19), gen, "cpu")
    assert len(rows) == 64 << 10
    assert 0 <= int(rows.min()) and int(rows.max()) < 1 << 10
    bits_r = ((rows[:, None] >> torch.arange(10)) & 1).float().mean()
    bits_c = ((cols[:, None] >> torch.arange(10)) & 1).float().mean()
    assert abs(float(bits_r) - 0.24) < 0.01   # 1 - (A + B)
    assert abs(float(bits_c) - 0.24) < 0.01   # B + D


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("repro", True), ("repro.db.connector", True),
    ("repro_torch", False), ("repro_torch.db", False),
    ("jaxtyping", False), ("reprox", False), ("portbench", False)])
def test_import_check_compares_whole_top_level_names(name, bad):
    assert harness.foreign_modules({name: None}) == ([name] if bad else [])


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "listing1-g500-s20-wal.bulk-read", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=harness.ROOT,
        timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_a_run_without_the_program_prints_no_result(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "listing1-g500-s20-wal.bulk-read", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=120)
    assert out.returncode != 0 and out.stdout == ""


class FakeCell:
    """What a read handler reads of the system in set-up."""
    num_shards, id_capacity = 4, 512

    def __init__(self, seed):
        gen = torch.Generator().manual_seed(seed)
        u, v = kronecker.kronecker(9, 16, (0.57, 0.19, 0.19), gen, "cpu")
        self.graphs = [(u.numpy(), v.numpy(), np.ones(len(u), np.float32))]
        self.names = graphs.vertex_names(512)


def _draws(mix, seed):
    return read.Op(mix["ops"], mix, FakeCell(seed),
                   np.random.default_rng(seed))


def test_reads_draw_the_same_sizes_of_work_from_every_seed():
    mix = {"loop": "closed", "clients": 1, "graphs": 1, "preload": 1,
           "order": "cycle", "pool": 8, "ops": [
               {"op": "read", "axis": "row", "select": "ids", "count": 64,
                "shard": "largest"}]}
    sums = []
    for seed in (1, 2):
        t = _draws(mix, seed)
        pool = t.pool
        assert all(len(s.ids) == 64 for s in pool)
        owner = np.concatenate([s.ids for s in pool]) * 4 // 512
        assert len(np.unique(owner)) == 1
        sums.append(np.mean([t.out_deg[s.ids].sum() for s in pool]))
    assert abs(sums[0] - sums[1]) < 0.1 * sums[0]


def test_degree_reads_take_the_nearest_degrees():
    mix = {"loop": "closed", "clients": 1, "graphs": 1, "preload": 1,
           "order": "shuffle", "pool": 6, "ops": [
               {"op": "read", "axis": "col", "select": "ids", "count": 2,
                "degree": [1, 30], "near": 4}]}
    t = _draws(mix, 5)
    pool = t.pool
    assert {s.tag for s in pool} == {"col_ids2_deg1", "col_ids2_deg30"}
    for s in pool:
        want = int(s.tag.rsplit("deg", 1)[1])
        deg = t.in_deg[s.ids]
        assert s.key[0] == ":" and len(s.ids) == 2
        others = np.sort(np.abs(np.log(t.in_deg[t.in_deg > 0]) -
                                np.log(want)))
        assert np.all(np.abs(np.log(deg) - np.log(want)) <= others[3])


def test_reference_holds_last_wins_transpose_and_degrees():
    rows = torch.tensor([1, 2, 1, 3, 1])
    cols = torch.tensor([2, 2, 2, 1, 3])
    vals = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0])
    ref = EdgeReference(rows, cols, vals, n_vertices=4)
    assert ref.table_wrong([1, 2, 3, 1], [2, 2, 1, 3], [3, 2, 4, 5]) == 0
    assert ref.table_wrong([1, 2, 3, 1], [2, 2, 1, 3], [1, 2, 4, 5]) == 2
    assert ref.table_wrong([1, 2, 3], [2, 2, 1], [3, 2, 4]) == 1
    assert ref.table_wrong([2, 2, 1, 3], [1, 2, 3, 1], [3, 2, 4, 5],
                           transpose=True) == 0
    assert ref.degree_wrong(np.array([0, 3, 1, 1]),
                            np.array([0, 1, 3, 1])) == 0
    keys, vals = ref.answer("col", ids=np.array([2]))
    assert list(keys >> 32) == [1, 2] and list(vals) == [3.0, 2.0]
    assert ref.same_answer((keys, vals), [2, 1], [2, 2], [2.0, 3.0])
    assert not ref.same_answer((keys, vals), [2], [2], [2.0])


class FakeEvent:
    def __init__(self, name, dev, t0, t1, corr=0, linked=0):
        self._v = (name, dev, t0, t1, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def test_trace_reduction():
    from torch.autograd import DeviceType
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        FakeEvent("portbench.window", cpu, 0, 1000),
        FakeEvent("put", cpu, 0, 600),
        FakeEvent("lsm.flush", cpu, 100, 300),
        FakeEvent("aten::sort", cpu, 110, 120, corr=7),
        FakeEvent("cudaLaunchKernel", cpu, 112, 118, corr=70, linked=7),
        FakeEvent("lsm.flush", gpu, 150, 400, linked=0),  # gpu annotation
        FakeEvent("sort_kernel", gpu, 150, 250, linked=7),
        FakeEvent("aten::copy_", cpu, 500, 520, corr=8),
        FakeEvent("Memcpy DtoH (Device -> Pageable)", gpu, 530, 580,
                  linked=8),
        FakeEvent("late_kernel", gpu, 560, 590, linked=8),
    ]
    out = measure.reduce_trace(events, {"put", "lsm.flush"},
                               "portbench.window")
    assert out["busy_s"] == pytest.approx(160e-9)
    assert out["device_s"] == pytest.approx(180e-9)
    assert out["d2h_s"] == pytest.approx(50e-9)
    assert out["in_label_s"]["lsm.flush"] == pytest.approx(100e-9)
    assert out["in_label_s"]["put"] == pytest.approx(180e-9)
    idle = dict(out["idle_gaps"])
    assert idle["put"] == pytest.approx(430e-9)      # 0-150, 250-530
    assert idle["harness"] == pytest.approx(410e-9)  # 590-1000
    assert out["device_ops"][0] == ("sort_kernel", pytest.approx(100e-9))


def test_readers_take_their_numbers_from_the_context():
    ops = [("put", "g0", 100, 0.1), ("put", "g0", 100, 0.3)]
    ctx = harness.Context(
        ops, window_s=0.5, setup_s=7.0,
        spans={"connector.encode": 0.1, "pair.put": 0.3},
        span_bytes={"lsm.flush": 3.35e9, "lsm.compaction": 0.0},
        trace={"busy_s": 0.05, "in_label_s": {"lsm.flush": 0.01},
               "device_s": 0.04, "d2h_s": 0.03},
        program=[("wal_latency_s", {"log": "t", "op": "append"}, 0.04),
                 ("db_op_latency_s", {"table": "t", "op": "flush"}, 0.1)])
    read = harness.load_reader
    assert read("ingest_entries_per_s")(ctx) == pytest.approx(400.0)
    assert read("setup_s")(ctx) == 7.0
    assert read("connector.encode_pct")(ctx) == pytest.approx(25.0)
    assert read("schema.degree_pct")(ctx) == pytest.approx(25.0)
    assert read("wal.append_pct")(ctx) == pytest.approx(10.0)
    assert read("lsm.compaction_pct")(ctx) == pytest.approx(25.0)
    assert read("lsm.merge_roofline")(ctx) == pytest.approx(10.0)
    assert read("device.idle_pct.ingest")(ctx) == pytest.approx(90.0)
    assert read("read.d2h_pct")(ctx) == pytest.approx(75.0)
    assert read("put_p95_ms")(ctx) == pytest.approx(290.0)
    assert read("query_p95_ms")(ctx) is None
    empty = harness.Context([], window_s=1.0, setup_s=1.0)
    for name in ("lsm.merge_roofline", "device.idle_pct.bulk",
                 "read.d2h_pct", "wal.append_pct"):
        assert read(name)(empty) is None

