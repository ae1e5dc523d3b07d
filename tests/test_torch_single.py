"""The legacy single-run engine (``engine="single"``) of the port against
the JAX package's on identical numpy inputs: tablets, ranks and counts
equal exactly (integer-valued values keep every combiner exact), and the
port's single engine answers like its own LSM engine."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.db import kvstore as jkv
from repro_torch.db import kvstore as tkv
from repro_torch.db import dbsetup
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.common import I32_MAX

COMBINERS = ("last", "sum", "min", "max")
GEOM = dict(num_shards=2, capacity_per_shard=256, batch_cap=64,
            id_capacity=64, memtable_cap=32)


def _batch(rng, n, pad, key_hi=40):
    r = np.full(n + pad, I32_MAX, np.int32)
    c = np.full(n + pad, I32_MAX, np.int32)
    v = np.zeros(n + pad, np.float32)
    r[:n] = rng.integers(0, key_hi, n)
    c[:n] = rng.integers(0, 8, n)
    v[:n] = rng.integers(-4, 9, n)
    perm = rng.permutation(n + pad)  # pads anywhere, as in a memtable
    return r[perm], c[perm], v[perm]


def _tablet_np(t):
    return {k: np.asarray(getattr(t, k)) for k in ("rows", "cols", "vals", "n")}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("combiner", COMBINERS)
def test_tablet_insert_and_query_match_jax(combiner, use_pallas):
    """Minor compactions into one tablet (JAX kernels in interpret mode),
    then point reads with the widen retry: equal tablets and reads."""
    rng = np.random.default_rng(COMBINERS.index(combiner))
    jt, tt = jkv.tablet_empty(64), tkv.tablet_empty(64, device="cpu")
    for _ in range(3):
        br, bc, bv = _batch(rng, 12, 4)
        jt = jkv.tablet_insert(jt, jnp.asarray(br), jnp.asarray(bc),
                               jnp.asarray(bv), combiner=combiner,
                               use_pallas=use_pallas)
        tt = tkv.tablet_insert(tt, torch.from_numpy(br), torch.from_numpy(bc),
                               torch.from_numpy(bv), combiner=combiner,
                               use_pallas=use_pallas)
        for k, v in _tablet_np(jt).items():
            np.testing.assert_array_equal(tt.__dict__[k].numpy(), v,
                                          err_msg=k)
    q = np.asarray([0, 3, 3, 17, 39, 45], np.int32)
    for width in (1, 2, 64):  # 1 and 2 force the caller's widen retry
        got = tkv.tablet_query_rows(tt, torch.from_numpy(q), width,
                                    use_pallas=use_pallas)
        want = jkv.tablet_query_rows(jt, jnp.asarray(q), width,
                                     use_pallas=use_pallas)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(tt.n) == int(jt.n) > 0


def test_stacked_tablet_insert_equals_jax_vmap():
    """The port inserts [S, cap] tablets in one merge per direction where
    the JAX engine vmaps over shards."""
    rng = np.random.default_rng(5)
    S = 3
    jt = jax.tree.map(lambda *xs: jnp.stack(xs), *[jkv.tablet_empty(32)] * S)
    tt = tkv.tablet_empty(32, shards=S, device="cpu")
    ins = jax.vmap(lambda t, r, c, v: jkv.tablet_insert(t, r, c, v, "sum",
                                                        use_pallas=False))
    for _ in range(2):
        parts = [_batch(rng, 8, 2) for _ in range(S)]
        br, bc, bv = (np.stack([p[i] for p in parts]) for i in range(3))
        jt = ins(jt, jnp.asarray(br), jnp.asarray(bc), jnp.asarray(bv))
        tt = tkv.tablet_insert(tt, *(torch.from_numpy(x) for x in (br, bc, bv)),
                               combiner="sum", use_pallas=True)
    for k, v in _tablet_np(jt).items():
        np.testing.assert_array_equal(tt.__dict__[k].numpy(), v, err_msg=k)


def _stores(name, combiner, use_pallas, **geom):
    kw = dict(GEOM, **geom)
    jt = jkv.ShardedTable("jax_" + name, combiner=combiner, engine="single",
                          **kw)
    tt = tkv.ShardedTable("torch_" + name, combiner=combiner, engine="single",
                          use_pallas=use_pallas, device="cpu", **kw)
    lsm = tkv.ShardedTable("torch_lsm_" + name, combiner=combiner,
                           use_pallas=use_pallas, device="cpu",
                           **dict(kw, l0_slots=2))
    return jt, tt, lsm


def _same(got, want, what, ordered=True):
    got = [np.asarray(x) for x in got]
    want = [np.asarray(x) for x in want]
    if not ordered:
        og, ow = np.lexsort(got[:2][::-1]), np.lexsort(want[:2][::-1])
        got, want = [x[og] for x in got], [x[ow] for x in want]
    for g, w, part in zip(got, want, ("rows", "cols", "vals")):
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {part}")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("combiner", COMBINERS)
def test_single_engine_matches_jax_and_lsm(combiner, use_pallas):
    """Random insert / point-read / range-scan / full-scan sequences: the
    port's single engine equals the JAX single engine in order, and its
    own LSM engine as sets (duplicate query ids give duplicate results)."""
    rng = np.random.default_rng(10 + COMBINERS.index(combiner))
    jt, tt, lsm = _stores(f"seq_{combiner}_{use_pallas}", combiner,
                          use_pallas)
    for step in range(8):
        n = int(rng.integers(1, 24))
        r = rng.integers(0, 64, n).astype(np.int32)
        c = rng.integers(0, 64, n).astype(np.int32)
        v = rng.integers(-3, 7, n).astype(np.float32)
        for t in (jt, tt, lsm):
            t.insert(r, c, v)
        q = rng.integers(0, 64, int(rng.integers(1, 12))).astype(np.int32)
        q = np.concatenate([q, q[:2]])  # duplicate ids
        width = int(rng.choice([1, 2, 256]))
        got = tt.query_rows(q, max_return=width)
        _same(got, jt.query_rows(q, max_return=width), f"query {step}")
        _same(got, lsm.query_rows(q, max_return=width), f"lsm {step}",
              ordered=False)
        lo = int(rng.integers(0, 60))
        hi = lo + int(rng.integers(0, 40))
        got = tt.scan_range(lo, hi)
        _same(got, jt.scan_range(lo, hi), f"scan_range {step}")
        _same(got, lsm.scan_range(lo, hi), f"lsm scan_range {step}",
              ordered=False)
        filt = np.asarray([1, 5, 9, 33], np.int32)
        _same(tt.query_rows(q, col_filter=filt),
              jt.query_rows(q, col_filter=filt), f"filtered query {step}")
        _same(tt.scan_range(0, 64, col_filter=filt),
              jt.scan_range(0, 64, col_filter=filt), f"filtered scan {step}")
    _same(tt.scan(), jt.scan(), "scan")
    _same(tt.scan(), lsm.scan(), "lsm scan", ordered=False)
    assert tt.nnz() == jt.nnz() == lsm.nnz()
    for k, v in tt.tablet_arrays().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jt.tablets, k)),
                                      err_msg=k)
    assert tt.engine_stats() == jt.engine_stats()
    tt.warmup()       # runs a merge on the state, changes nothing
    tt.warm_reads()
    tt.major_compact()  # a no-op on this engine
    _same(tt.scan(), jt.scan(), "scan after warmup")


def _route_run(device):
    tt = tkv.ShardedTable("torch_route_" + device, engine="single",
                          use_pallas=True, device=device, **GEOM)
    reset_launches()
    tt.insert(np.arange(20, dtype=np.int32), np.arange(20, dtype=np.int32),
              np.ones(20, np.float32))
    got = tt.query_rows(np.arange(5, dtype=np.int32))
    assert list(got[0]) == [0, 1, 2, 3, 4]
    return dict(LAUNCHES)


def test_single_engine_cpu_tensors_never_launch():
    """On the CPU the reads' rank search and the flush's merge take their
    plain versions: nothing launches."""
    assert all(v == 0 for v in _route_run("cpu").values())


@pytest.mark.gpu
def test_single_engine_on_card_launches_rank_and_pair_rank():
    """Under use_pallas the flush merges through the merge-path rank kernel
    (one launch; the binary-search pair rank no longer runs there) and the
    point read of the one queried shard is one two-sided launch of the 1-D
    rank kernel and one of the compacting gather (no widen pass)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    launches = _route_run("cuda")
    assert launches["merge_path_rank"] == 1 and launches["pair_rank"] == 0
    assert launches["rank"] == 1 and launches["tablet_gather"] == 1


def test_single_flush_overflow_leaves_tablets_unchanged():
    jt, tt, _ = _stores("overflow", "last", True, capacity_per_shard=16,
                        memtable_cap=64)
    r = np.arange(10, dtype=np.int32)
    for t in (jt, tt):
        t.insert(r, r, np.ones(10, np.float32))
        t.flush()
    before = tt.tablet_arrays()
    mem_n = tt._mem_n.copy()
    big = np.zeros(30, np.int32)  # shard 0 only
    for t in (jt, tt):
        t.insert(big, np.arange(30, dtype=np.int32), np.ones(30, np.float32))
        with pytest.raises(OverflowError, match="tablet overflow"):
            t.flush()
    for k, v in tt.tablet_arrays().items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
        np.testing.assert_array_equal(v, np.asarray(getattr(jt.tablets, k)))
    np.testing.assert_array_equal(tt._mem_n, mem_n + [30, 0])
    np.testing.assert_array_equal(tt._mem_n, jt._mem_n)


def test_duplicate_query_ids_give_duplicate_results():
    jt, tt, _ = _stores("dups", "sum", False)
    r = np.asarray([3, 3, 5, 40], np.int32)
    c = np.asarray([1, 2, 1, 0], np.int32)
    for t in (jt, tt):
        t.insert(r, c, np.ones(4, np.float32))
    q = np.asarray([3, 5, 3, 40, 3], np.int32)
    got = tt.query_rows(q)
    _same(got, jt.query_rows(q), "duplicates")
    assert list(got[0]) == [3, 3, 5, 3, 3, 3, 3, 40]


def test_single_zero_counter_schema():
    """The single engine reports the LSM engine's counter schema, zero
    where an op doesn't apply, with the same series in the registry."""
    from repro.obs import default_registry as jax_registry
    from repro_torch.obs import default_registry
    jt, tt, lsm = _stores("schema", "last", False)
    r = np.arange(30, dtype=np.int32)
    for t in (jt, tt, lsm):
        t.insert(r, r, np.ones(30, np.float32))
        t.query_rows(r[:5])
        t.refresh_health_gauges()
    st = tt.engine_stats()
    assert st == jt.engine_stats()
    assert set(st) == set(lsm.engine_stats())
    assert st["flushes"] == 1 and st["l0_used"] == [0, 0]
    assert st["level_entries"] == []
    assert all(v == 0 for k, v in st.items()
               if k not in ("flushes", "l0_used", "level_entries"))
    names = {(i.name, tuple(sorted((k, v) for k, v in i.labels.items()
                                   if k != "table")))
             for i in default_registry().series(table="torch_schema")}
    jnames = {(i.name, tuple(sorted((k, v) for k, v in i.labels.items()
                                    if k != "table")))
              for i in jax_registry().series(table="jax_schema")}
    assert names == jnames


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_single_state_carried_across_packages(direction):
    jt, tt, _ = _stores(f"carry_{direction}", "sum", False)
    rng = np.random.default_rng(21)
    src = jt if direction == "jax_to_port" else tt
    for _ in range(3):
        r = rng.integers(0, 64, 20).astype(np.int32)
        src.insert(r, rng.integers(0, 64, 20).astype(np.int32),
                   rng.integers(1, 5, 20).astype(np.float32))
    src.flush()
    if direction == "jax_to_port":
        tkv.load_jax_tablets(tt, {k: np.asarray(getattr(jt.tablets, k))
                                  for k in ("rows", "cols", "vals", "n")})
    else:
        jt.tablets = jkv.Tablet(**{k: jnp.asarray(v)
                                   for k, v in tt.tablet_arrays().items()})
        jt._shard_views.clear()
    q = np.arange(64, dtype=np.int32)
    _same(tt.query_rows(q), jt.query_rows(q), "query after carry")
    _same(tt.scan_range(3, 50), jt.scan_range(3, 50), "scan after carry")
    assert tt.nnz() == jt.nnz() > 0
    with pytest.raises(ValueError, match="rows"):
        tkv.load_jax_tablets(tt, {"rows": np.zeros((3, 256), np.int32)})


def test_single_engine_refuses_pairs_and_tablets():
    for kw, what in [({"transpose": True}, "transpose pairs"),
                     ({"dynamic_tablets": True}, "dynamic_tablets")]:
        for cls, extra in ((jkv.ShardedTable, {}),
                           (tkv.ShardedTable, {"device": "cpu"})):
            with pytest.raises(ValueError, match=what):
                cls("refuse", engine="single", **kw, **extra)
    with pytest.raises(ValueError, match="lsm"):
        _stores("noshard", "last", False)[1].scan_shard(0)


def test_single_engine_through_the_connector():
    """Listing-1 reads on ``engine="single"`` (row ids, a row range, and a
    column read served by a host scan + filter) equal the JAX connector's
    and the host Assoc algebra's; metrics and the debug bundle carry the
    engine."""
    from repro.core import Assoc as JaxAssoc
    from repro.db import dbsetup as jax_dbsetup
    from repro_torch.core import Assoc
    cfg = dict(num_shards=2, capacity_per_shard=512, batch_cap=64,
               id_capacity=256, memtable_cap=256, engine="single",
               use_pallas=True)
    rng = np.random.default_rng(3)
    rows = np.asarray([f"v{i:03d}" for i in rng.integers(0, 60, 150)], object)
    cols = np.asarray([f"v{i:03d}" for i in rng.integers(0, 60, 150)], object)
    vals = rng.integers(1, 5, 150).astype(np.float64)
    db_t = dbsetup("single_conn_t", cfg, device="cpu")
    db_j = jax_dbsetup("single_conn_j", cfg)
    t, j = db_t["torch_single_T"], db_j["jax_single_T"]
    t.put_triple(rows, cols, vals)
    j.put_triple(rows, cols, vals)
    a = Assoc(rows, cols, vals, func="last")
    ja = JaxAssoc(rows, cols, vals, func="last")
    for sel in [(f"{rows[0]},{rows[5]},", ":"), ("v010,:,v030,", ":"),
                (":", f"{cols[1]},{cols[2]},"), ("v0*,", f"{cols[3]},")]:
        got = t[sel]
        assert got.same_as(a[sel]), sel
        want = j[sel]
        for x, y in zip(got.triples(), want.triples()):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert ja[sel].nnz() == got.nnz()
    m = db_t.metrics()["tables"]["torch_single_T"]
    assert m["engine"] == "single" and m["counters"]["flushes"] >= 1
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        db_t.debug_bundle(d + "/b.zip")
    with pytest.raises(ValueError, match="transpose"):
        db_t["p", "pT"]
