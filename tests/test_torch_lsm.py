"""The port's LSM engine and sharded store against the JAX package's on
identical random ingest/flush/compact/query/scan sequences, for all four
combiners, and against a numpy oracle. Keys must be exactly equal; values
exactly for last/min/max and to rtol 1e-6 for sum (summation order).

Sizes are tiny (memtables of 16-32 entries) so that the JAX side, which
compiles each new run geometry, stays cheap."""
import numpy as np
import pytest

from repro.db.kvstore import ShardedTable as JaxTable
from repro_torch.db.kvstore import ShardedTable as TorchTable
from repro_torch.db.lsm import engine as teng
from repro_torch.kernels.common import I32_MAX

RTOL = {"sum": 1e-6, "last": 0, "min": 0, "max": 0}


class Oracle:
    """Combined (row, col) -> value under one combiner, in write order."""

    def __init__(self, combiner):
        self.combiner = combiner
        self.d = {}

    def insert(self, r, c, v):
        f = {"last": lambda a, b: b, "sum": lambda a, b: a + b,
             "min": min, "max": max}[self.combiner]
        for key, x in zip(zip(r.tolist(), c.tolist()), v.tolist()):
            self.d[key] = f(self.d[key], x) if key in self.d else x

    def select(self, pred):
        keys = sorted(k for k in self.d if pred(*k))
        return (np.asarray([k[0] for k in keys], np.int64),
                np.asarray([k[1] for k in keys], np.int64),
                np.asarray([self.d[k] for k in keys], np.float64))


def _sorted(t):
    r, c, v = (np.asarray(x) for x in t)
    o = np.lexsort((c, r))
    return r[o], c[o], v[o]


def _same(a, b, rtol, what):
    ar, ac, av = _sorted(a)
    br, bc, bv = _sorted(b)
    np.testing.assert_array_equal(ar, br, err_msg=what + " rows")
    np.testing.assert_array_equal(ac, bc, err_msg=what + " cols")
    np.testing.assert_allclose(av, bv, rtol=rtol, atol=0, err_msg=what)


def _pair(name, combiner, **kw):
    return (JaxTable("jax_" + name, combiner=combiner, **kw),
            TorchTable("torch_" + name, combiner=combiner, device="cpu", **kw))


def _drive(jt, tt, oracle, rng, steps, idc, jax_every=3, max_batch=16,
           q_max=24):
    """Random ingest/flush/compact steps; the port's reads are held against
    the oracle at every step and against the JAX store every
    ``jax_every`` steps (each new run geometry compiles on the JAX side)."""
    rtol = RTOL[oracle.combiner]
    for step in range(steps):
        n = int(rng.integers(1, max_batch))
        r = rng.integers(0, idc, n).astype(np.int32)
        c = rng.integers(0, idc, n).astype(np.int32)
        v = rng.integers(-8, 9, n).astype(np.float32)
        jt.insert(r, c, v)
        tt.insert(r, c, v)
        oracle.insert(r, c, v)
        op = int(rng.integers(0, 5))
        if op == 0:
            jt.flush()
            tt.flush()
        elif op == 1:
            jt.major_compact()
            tt.major_compact()
        with_jax = (step + 1) % jax_every == 0
        q = np.unique(rng.integers(0, idc, q_max)).astype(np.int32)
        got = tt.query_rows(q)
        qs = set(q.tolist())
        _same(got, oracle.select(lambda a, b: a in qs), rtol,
              f"step {step} query vs oracle")
        if with_jax:
            _same(got, jt.query_rows(q), rtol, f"step {step} query vs jax")
        lo = int(rng.integers(0, idc))
        hi = lo + int(rng.integers(1, max(2, idc // 3)))
        got = tt.scan_range(lo, hi)
        _same(got, oracle.select(lambda a, b: lo <= a < hi), rtol,
              f"step {step} scan vs oracle")
        if with_jax:
            _same(got, jt.scan_range(lo, hi), rtol,
                  f"step {step} scan vs jax")


def _same_state(jt, tt, rtol):
    sa, sb = jt._runs.state_arrays(), tt._runs.state_arrays()
    assert sa.keys() == sb.keys()
    for k in sa:
        if k.endswith("_vals"):
            np.testing.assert_allclose(sb[k], sa[k], rtol=rtol, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(sb[k], np.asarray(sa[k]),
                                          err_msg=k)


@pytest.mark.parametrize("combiner,use_pallas", [
    ("last", True), ("sum", True), ("min", False), ("max", False),
])
def test_random_sequences_match_jax(combiner, use_pallas):
    rng = np.random.default_rng(
        ["last", "sum", "min", "max"].index(combiner) + 10 * use_pallas)
    idc = 128
    jt, tt = _pair(f"seq_{combiner}_{use_pallas}", combiner, num_shards=2,
                   capacity_per_shard=256, batch_cap=32, id_capacity=idc,
                   memtable_cap=16, use_pallas=use_pallas)
    _drive(jt, tt, Oracle(combiner), rng, steps=9, idc=idc)
    jt.flush()
    tt.flush()
    _same_state(jt, tt, RTOL[combiner])
    st = tt.engine_stats()
    for key in ("flushes", "major_compactions", "l0_used", "level_entries"):
        assert st[key] == jt.engine_stats()[key], key
    assert tt.engine_stats()["major_compactions"] > 0


def test_widen_retry_and_wide_candidate_sort():
    """A row with more than 4 entries per run forces the widen retry; with
    enough runs the widened candidate row passes 256 and the combine falls
    back from the row-rank merge to the sort."""
    rng = np.random.default_rng(5)
    idc = 1024
    jt, tt = _pair("wide", "sum", num_shards=1, capacity_per_shard=4096,
                   batch_cap=128, id_capacity=idc, memtable_cap=128,
                   l0_slots=4)
    oracle = Oracle("sum")
    widths = []
    real = teng.merge_combine_rows

    def spy(keys, vals, use_pallas=False):
        widths.append(keys.shape[1])
        return real(keys, vals, use_pallas=use_pallas)

    teng.merge_combine_rows = spy
    try:
        for run in range(3):  # three L0 runs, each holding row 7 x 100 cols
            c = rng.permutation(idc)[:100].astype(np.int32)
            r = np.full(100, 7, np.int32)
            v = rng.integers(1, 5, 100).astype(np.float32)
            for t_ in (jt, tt):
                t_.insert(r, c, v)
                t_.flush()
            oracle.insert(r, c, v)
        q = np.asarray([3, 7, 9], np.int32)
        got = tt.query_rows(q)
        _same(got, jt.query_rows(q), 1e-6, "wide query vs jax")
        _same(got, oracle.select(lambda a, b: a in (3, 7, 9)), 1e-6,
              "wide query vs oracle")
    finally:
        teng.merge_combine_rows = real
    st = tt.engine_stats()
    assert st["fused_widen_retries"] >= 1
    # first pass merged by row rank (narrow), the widened pass (3 runs x
    # 128 > 256) sorted instead
    assert widths and max(widths) <= 256
    assert st["fused_dispatches"] > len(widths)
    assert st == jt.engine_stats()


@pytest.mark.parametrize("id_capacity,num_shards", [
    (256, 2),       # (row, col, age) packs into one int32 key
    (1 << 16, 2),   # (col, age) packs into int32: two stable sorts
    (1 << 30, 1),   # int64 (col, age) key; point reads do not pack
])
def test_scan_key_geometries_match_jax(id_capacity, num_shards):
    rng = np.random.default_rng(id_capacity % 97)
    jt, tt = _pair(f"geo_{id_capacity}", "max", num_shards=num_shards,
                   capacity_per_shard=512, batch_cap=64,
                   id_capacity=id_capacity, memtable_cap=32)
    oracle = Oracle("max")
    # ids clustered at both ends of the id space
    pool = np.concatenate([np.arange(40), id_capacity - 1 - np.arange(40)])
    for step in range(4):
        n = int(rng.integers(5, 30))
        r = rng.choice(pool, n).astype(np.int32)
        c = rng.choice(pool, n).astype(np.int32)
        v = rng.normal(size=n).astype(np.float32)
        for t_ in (jt, tt):
            t_.insert(r, c, v)
        oracle.insert(r, c, v)
        if step % 2:
            jt.flush()
            tt.flush()
        for lo, hi in [(0, 20), (5, id_capacity), (id_capacity - 30,
                                                   id_capacity)]:
            got = tt.scan_range(lo, hi, width=16)
            _same(got, oracle.select(lambda a, b: lo <= a < hi), 0,
                  f"scan {lo} oracle")
            if step % 2:
                _same(got, jt.scan_range(lo, hi, width=16), 0, f"scan {lo}")
        q = np.unique(rng.choice(pool, 10)).astype(np.int32)
        qs = set(q.tolist())
        got = tt.query_rows(q)
        _same(got, oracle.select(lambda a, b: a in qs), 0, "query oracle")
        if step % 2:
            _same(got, jt.query_rows(q), 0, "query")


def test_col_filter_and_duplicate_query_ids():
    rng = np.random.default_rng(11)
    jt, tt = _pair("filt", "last", num_shards=2, capacity_per_shard=256,
                   batch_cap=32, id_capacity=64, memtable_cap=16)
    for _ in range(5):
        r = rng.integers(0, 64, 16).astype(np.int32)
        c = rng.integers(0, 64, 16).astype(np.int32)
        v = rng.normal(size=16).astype(np.float32)
        jt.insert(r, c, v)
        tt.insert(r, c, v)
    filt = np.asarray([1, 5, 9, 33, 60], np.int32)
    q = np.asarray([3, 3, 17, 40, 40, 40], np.int32)
    _same(tt.query_rows(q, col_filter=filt), jt.query_rows(q, col_filter=filt),
          0, "filtered query")
    _same(tt.scan_range(0, 64, col_filter=filt),
          jt.scan_range(0, 64, col_filter=filt), 0, "filtered scan")
    z = tt.query_rows(q, col_filter=np.zeros(0, np.int32))
    assert all(len(x) == 0 for x in z)
    _same(tt.scan(), jt.scan(), 0, "full scan")
    assert tt.nnz() == jt.nnz()
    tt.warmup()      # runs flush + compaction on the state, changes nothing
    tt.warm_reads()
    _same(tt.scan(), jt.scan(), 0, "scan after warmup")
    for t_ in (jt, tt):
        t_.flush()
        t_._runs.clear_shard(1)
    assert len(tt.scan_shard(1)[0]) == 0
    _same(tt.scan(), jt.scan(), 0, "scan after clear_shard")


def test_deferred_options_raise():
    for kw, what in [({"wal_dir": "/nonexistent"}, "Queue 1 item 5"),
                     ({"dynamic_tablets": True}, "Queue 1 item 7"),
                     ({"fused_reads": False}, "Queue 1 item 3")]:
        with pytest.raises(NotImplementedError, match=what):
            TorchTable("deferred", device="cpu", **kw)


def test_engine_schema_and_health_gauges():
    """Counter names, labels and health gauges match the JAX engine's
    schema (retrace series exist and read zero)."""
    from repro_torch.obs import default_registry
    jt, tt = _pair("schema", "last", num_shards=2, capacity_per_shard=256,
                   batch_cap=32, id_capacity=64, memtable_cap=16)
    r = np.arange(16, dtype=np.int32) * 4
    for t_ in (jt, tt):
        t_.insert(r, r, np.ones(16, np.float32))
        t_.flush()
        t_.query_rows(np.arange(10, dtype=np.int32))
        t_.refresh_health_gauges(bloom_probes=32)
    reg = default_registry()
    names = {inst.name for inst in reg.series(table="torch_schema")}
    for want in ("lsm_retraces", "lsm_flush_entries", "lsm_resident_runs",
                 "lsm_read_amplification", "lsm_write_amplification",
                 "lsm_bloom_fp_observed", "db_op_latency_s",
                 "db_ingest_entries", "lsm_fused_dispatches"):
        assert want in names, want
    assert all(c.value == 0 for c in reg.series("lsm_retraces",
                                                 table="torch_schema"))
    assert tt._runs.fence_median(0, 0, 32) == jt._runs.fence_median(0, 0, 32)
    np.testing.assert_array_equal(tt._runs.fence_keys(1, 0, 64),
                                  jt._runs.fence_keys(1, 0, 64))
    assert (np.asarray(tt._runs.l0_rows[0, 0, :4]) != I32_MAX).all()
