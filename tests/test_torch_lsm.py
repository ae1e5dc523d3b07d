"""The port's LSM engine and sharded store against the JAX package's on
identical random ingest/flush/compact/query/scan sequences, for all four
combiners, on the fused reads and on the per-run baseline, and against a
numpy oracle. Keys must be exactly equal; values exactly for last/min/max
and to rtol 1e-6 for sum (summation order); the read counters exactly.

Sizes are tiny (memtables of 16-32 entries) so that the JAX side, which
compiles each new run geometry, stays cheap."""
import shutil

import numpy as np
import pytest

from repro.db.kvstore import ShardedTable as JaxTable
from repro_torch.db.kvstore import ShardedTable as TorchTable
from repro_torch.db.lsm import engine as teng
from repro_torch.kernels.common import I32_MAX

RTOL = {"sum": 1e-6, "last": 0, "min": 0, "max": 0}
# the read counters: both packages count the same dispatches and runs
READ_KEYS = ("runs_probed", "runs_skipped", "fused_dispatches",
             "fused_widen_retries", "fused_tiles", "perrun_dispatches",
             "scan_dispatches", "scan_widen_retries")


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


def _reads(t, fn):
    """``fn()`` and the change of ``t``'s read counters over it."""
    before = t.engine_stats()
    out = fn()
    after = t.engine_stats()
    return out, {k: after[k] - before[k] for k in READ_KEYS}


def _drive(jt, tt, oracle, rng, steps, idc, jax_every=3, max_batch=16,
           q_max=24):
    """Random ingest/flush/compact steps; the port's reads are held against
    the oracle at every step and against the JAX store every
    ``jax_every`` steps (each new run geometry compiles on the JAX side),
    read counters included. On the per-run path (``fused_reads`` off) the
    port's fused read of the same store is held equal there too."""
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
        got, d_t = _reads(tt, lambda: tt.query_rows(q))
        qs = set(q.tolist())
        _same(got, oracle.select(lambda a, b: a in qs), rtol,
              f"step {step} query vs oracle")
        if with_jax:
            want, d_j = _reads(jt, lambda: jt.query_rows(q))
            _same(got, want, rtol, f"step {step} query vs jax")
            assert d_t == d_j, (step, d_t, d_j)
            if not tt.fused_reads:
                tt.fused_reads = True
                _same(tt.query_rows(q), got, rtol, f"step {step} fused")
                tt.fused_reads = False
        lo = int(rng.integers(0, idc))
        hi = lo + int(rng.integers(1, max(2, idc // 3)))
        got, d_t = _reads(tt, lambda: tt.scan_range(lo, hi))
        _same(got, oracle.select(lambda a, b: lo <= a < hi), rtol,
              f"step {step} scan vs oracle")
        if with_jax:
            want, d_j = _reads(jt, lambda: jt.scan_range(lo, hi))
            _same(got, want, rtol, f"step {step} scan vs jax")
            assert d_t == d_j, (step, d_t, d_j)


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


# the per-run cases take the other use_pallas value of each combiner, so
# that every combiner runs with both across the two read paths
@pytest.mark.parametrize("combiner,use_pallas,fused_reads", [
    ("last", True, True), ("sum", True, True), ("min", False, True),
    ("max", False, True), ("last", False, False), ("sum", False, False),
    ("min", True, False), ("max", True, False),
], ids=["last-True", "sum-True", "min-False", "max-False",
        "last-False-perrun", "sum-False-perrun", "min-True-perrun",
        "max-True-perrun"])
def test_random_sequences_match_jax(combiner, use_pallas, fused_reads):
    rng = np.random.default_rng(
        ["last", "sum", "min", "max"].index(combiner) + 10 * use_pallas)
    idc = 128
    jt, tt = _pair(f"seq_{combiner}_{use_pallas}_{fused_reads}", combiner,
                   num_shards=2, capacity_per_shard=256, batch_cap=32,
                   id_capacity=idc, memtable_cap=16, use_pallas=use_pallas,
                   fused_reads=fused_reads)
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


def test_perrun_widen_retry_matches_jax():
    """The per-run path with ``max_return`` below the longest row: every run
    holding row 7 is searched again at the row's width."""
    rng = np.random.default_rng(6)
    idc = 1024
    jt, tt = _pair("perrun_wide", "sum", num_shards=1,
                   capacity_per_shard=4096, batch_cap=128, id_capacity=idc,
                   memtable_cap=128, fused_reads=False)
    oracle = Oracle("sum")
    for _ in range(3):  # three L0 runs, each holding row 7 x 60 cols
        c = rng.permutation(idc)[:60].astype(np.int32)
        r = np.full(60, 7, np.int32)
        v = rng.integers(1, 5, 60).astype(np.float32)
        for t_ in (jt, tt):
            t_.insert(r, c, v)
            t_.flush()
        oracle.insert(r, c, v)
    q = np.asarray([3, 7, 9], np.int32)
    got, d_t = _reads(tt, lambda: tt.query_rows(q, max_return=16))
    want, d_j = _reads(jt, lambda: jt.query_rows(q, max_return=16))
    _same(got, want, 1e-6, "per-run widen vs jax")
    _same(got, oracle.select(lambda a, b: a in (3, 7, 9)), 1e-6,
          "per-run widen vs oracle")
    assert d_t == d_j
    assert d_t["perrun_dispatches"] == 6 and d_t["fused_dispatches"] == 0


def test_perrun_scan_col_filter_and_duplicates_match_jax():
    """``scan_range`` and ``col_filter`` on the per-run path (both filter on
    the host), and duplicate query ids, against the JAX store and the
    fused read of the same port store."""
    rng = np.random.default_rng(12)
    jt, tt = _pair("perrun_filt", "max", num_shards=2,
                   capacity_per_shard=256, batch_cap=32, id_capacity=64,
                   memtable_cap=16, fused_reads=False)
    for _ in range(5):
        r = rng.integers(0, 64, 16).astype(np.int32)
        c = rng.integers(0, 64, 16).astype(np.int32)
        v = rng.normal(size=16).astype(np.float32)
        jt.insert(r, c, v)
        tt.insert(r, c, v)
    filt = np.asarray([1, 5, 9, 33, 60], np.int32)
    q = np.asarray([3, 3, 17, 40, 40, 40], np.int32)
    reads = {
        "filtered query": lambda t: t.query_rows(q, col_filter=filt),
        "filtered scan": lambda t: t.scan_range(0, 64, col_filter=filt),
        "scan": lambda t: t.scan_range(10, 50),
        "empty filter": lambda t: t.query_rows(
            q, col_filter=np.zeros(0, np.int32)),
    }
    for what, read in reads.items():
        got, d_t = _reads(tt, lambda: read(tt))
        want, d_j = _reads(jt, lambda: read(jt))
        _same(got, want, 0, what)
        assert d_t == d_j, what
        assert d_t["fused_dispatches"] == d_t["scan_dispatches"] == 0
        tt.fused_reads = True
        _same(read(tt), got, 0, what + " fused")
        tt.fused_reads = False
    assert len(reads["empty filter"](tt)[0]) == 0
    # the point bucket only: no query tile to warm on the per-run path
    assert _reads(tt, tt.warm_reads)[1] == _reads(jt, jt.warm_reads)[1]


def test_run_queries_match_jax():
    """``run_query_rows`` and ``run_query_gated`` on one run equal the JAX
    functions' outputs, mask and clipped gathers included, where the bloom
    may hold a queried row; where it holds none, the port's search still
    ran (the gate does not skip it) and ``any_hit`` is false in both."""
    import jax.numpy as jnp
    import torch
    from repro.db.lsm import engine as jeng
    from repro.db.lsm.bloom import bloom_build as jax_bloom
    from repro_torch.db.lsm.bloom import bloom_build
    rng = np.random.default_rng(3)
    cap, block, words = 64, 4, 8
    rows = np.full(cap, I32_MAX, np.int32)
    rows[:40] = np.sort(rng.integers(0, 30, 40))
    cols = np.arange(cap, dtype=np.int32)
    vals = rng.normal(size=cap).astype(np.float32)
    fence = rows[::block].copy()
    q = np.asarray([0, 5, 11, 29, 31], np.int32)
    t = {k: torch.as_tensor(x) for k, x in
         dict(rows=rows, cols=cols, vals=vals, fence=fence, q=q).items()}
    bloom = bloom_build(t["rows"], words, 3)
    np.testing.assert_array_equal(  # the port keeps the words as int32
        bloom.numpy().view(np.uint32),
        np.asarray(jax_bloom(jnp.asarray(rows), words, 3)))
    for max_return in (2, 8):
        got = teng.run_query_rows(t["rows"], t["cols"], t["vals"],
                                  t["fence"], t["q"], max_return, block)
        want = jeng.run_query_rows(jnp.asarray(rows), jnp.asarray(cols),
                                   jnp.asarray(vals), jnp.asarray(fence),
                                   jnp.asarray(q), max_return, block)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        hit, *gated = teng.run_query_gated(
            t["rows"], t["cols"], t["vals"], t["fence"], bloom, t["q"],
            max_return, block, 3)
        assert bool(hit)
        for g, w in zip(gated, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    absent = torch.as_tensor(np.asarray([1 << 20, (1 << 20) + 7], np.int32))
    miss = bloom_build(torch.full((cap,), I32_MAX, dtype=torch.int32),
                       words, 3).numpy()  # an empty run's filter
    hit, c_o, _, ok, cnt = teng.run_query_gated(
        t["rows"], t["cols"], t["vals"], t["fence"], torch.as_tensor(miss),
        absent, 4, block, 3)
    j_hit = jeng.run_query_gated(jnp.asarray(rows), jnp.asarray(cols),
                                 jnp.asarray(vals), jnp.asarray(fence),
                                 jnp.asarray(miss.view(np.uint32)),
                                 jnp.asarray(absent.numpy()),
                                 4, block, 3)[0]
    assert not bool(hit) and not bool(j_hit)
    assert c_o.shape == (2, 4) and int(cnt.sum()) == 0 and not ok.any()


def test_dynamic_tablets_and_format3_are_served(tmp_path):
    """The options the port once refused work: ``dynamic_tablets=True``
    builds a tablet map, the JAX package's format-3 directory recovers
    (with and without ``tablet_filter``), and ``dbsetup(wal_root=)`` with
    fused reads on, or a store with them off, behave as configured."""
    from repro.db.kvstore import ShardedTable as JaxStore
    from repro_torch.db import dbsetup
    from repro_torch.db.lsm import recover
    st = TorchTable("served", device="cpu", dynamic_tablets=True)
    assert st.tablet_map is not None and st.tablet_map.n == st.S
    d = str(tmp_path / "fmt3")
    js = JaxStore("fmt3", num_shards=2, capacity_per_shard=256, batch_cap=32,
                  id_capacity=64, memtable_cap=16, wal_dir=d,
                  dynamic_tablets=True)
    js.insert(np.arange(8, dtype=np.int32), np.zeros(8, np.int32),
              np.ones(8, np.float32))
    js.checkpoint()
    js.insert(np.arange(40, 48, dtype=np.int32), np.zeros(8, np.int32),
              np.ones(8, np.float32))
    want = js.tablet_map.to_manifest()
    js.close()
    for filt, n in ((None, 16), ([1], 16), ([0], 8)):
        dd = str(tmp_path / f"fmt3_{filt}")
        shutil.copytree(d, dd)
        rec = recover(dd, tablet_filter=filt, device="cpu")
        assert rec.tablet_map.to_manifest() == want
        assert rec.nnz() == n, filt
        rec.close()
    db = dbsetup("served_db", dict(num_shards=2, capacity_per_shard=256,
                                   batch_cap=32, id_capacity=64),
                 wal_root=str(tmp_path / "root"), device="cpu")
    t = db["served_t"]
    t.put_triple(np.asarray(["a"], object), np.asarray(["b"], object),
                 np.asarray([1.0]))
    assert db.wal_root == str(tmp_path / "root")
    assert t.store._wal is not None and t.store.fused_reads
    assert TorchTable("served_pr", device="cpu",
                      fused_reads=False).fused_reads is False


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
