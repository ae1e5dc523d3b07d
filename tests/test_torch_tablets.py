"""Dynamic tablets in the port against the JAX package and a never-split
oracle, at the sizes of ``tests/test_tablet_split.py`` (4 shards, 4,096
ids, memtable 256, batches of 200).

* The map (``db.tablets.TabletMap``, a copy): random split / move / merge /
  ``record_load`` / ``touch_range`` / ``decay`` sequences give the same
  manifest, float64 loads, routing, segments and ``device_routing`` as the
  JAX map.
* The store: one JAX store and one port store (and a port store that never
  splits) fed the same Zipf and sequential streams with ``maybe_rebalance``
  rounds and merges, for each combiner. After every round both maps are
  equal (manifest, loads, split keys, new ids, owners), and so are the
  counters, scans, point reads and ranges; each equals the never-split
  oracle (``sum`` within rtol 1e-5 / atol 1e-6, since a migration
  re-inserts combined values, the others exactly).
* Durability: the same calls write the same ``wal.log`` bytes (tablet-tagged
  data frames, meta frames) and equal format-3 manifests; either package
  recovers the other's directory; a log cut at every few bytes across a
  split / move window, and ``tablet_filter`` replays per tablet, equal a
  host replay of the snapshot plus the intact frames (as
  ``tests/test_lsm_fuzz.py`` holds the JAX package).
* The connector's ``metrics()["tables"][...]["tablets"]`` section, and a
  dynamic-tablet pair recovered through ``recover_connector``.

A JAX table and a port table built in one test take different names
unless the test compares manifests (which carry the name).
"""
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.db import dbsetup as jax_dbsetup
from repro.db import recover_connector as jax_recover_connector
from repro.db.kvstore import COMBINERS
from repro.db.kvstore import ShardedTable as JaxTable
from repro.db.lsm import recover as jax_recover
from repro.db.tablets import TabletMap as JaxMap
from repro_torch.db import dbsetup, recover_connector
from repro_torch.db.kvstore import ShardedTable as TorchTable
from repro_torch.db.kvstore import shard_of
from repro_torch.db.lsm import WriteAheadLog, recover
from repro_torch.db.tablets import TabletMap

S = 4
ID_CAP = 1 << 12
ZIPF_S = 1.2  # hottest key ~18% of the traffic: splittable below 2.0
CFG = dict(num_shards=S, capacity_per_shard=1 << 14, batch_cap=1024,
           id_capacity=ID_CAP, memtable_cap=256, engine="lsm")
# JAX vs port: the engines' state arrays are equal, sums within float
# rounding; vs the never-split oracle a migration re-adds combined sums
RTOL_JAX = {"sum": 1e-6}
ORACLE_TOL = {"sum": (1e-5, 1e-6)}


def _stores(name, combiner="last", **kw):
    """A JAX store and a port store with dynamic tablets, and a port store
    that never splits (the oracle)."""
    j = JaxTable(f"j_{name}", combiner=combiner, dynamic_tablets=True,
                 **CFG, **kw)
    t = TorchTable(f"t_{name}", combiner=combiner, dynamic_tablets=True,
                   device="cpu", **CFG, **kw)
    o = TorchTable(f"o_{name}", combiner=combiner, dynamic_tablets=False,
                   device="cpu", **CFG, **kw)
    return j, t, o


def _zipf_batch(rng, n, n_cols=64):
    r = (rng.zipf(ZIPF_S, n) % ID_CAP).astype(np.int32)
    c = rng.integers(0, n_cols, n).astype(np.int32)
    v = rng.normal(size=n).astype(np.float32)
    return r, c, v


def _sorted(t):
    r, c, v = (np.asarray(x) for x in t)
    o = np.lexsort((c, r))
    return r[o], c[o], v[o]


def _same(got, want, what, rtol=0.0, atol=0.0, ordered=False):
    """(rows, cols, vals) equal — as sets of triples, or in order."""
    if not ordered:
        got, want = _sorted(got), _sorted(want)
    for x, y, part in zip(got, want, ("rows", "cols")):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{what} {part}")
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(want[2]),
                               rtol=rtol, atol=atol, err_msg=what)


def _same_as_jax(got, want, combiner, what, ordered=False):
    _same(got, want, what, rtol=RTOL_JAX.get(combiner, 0.0), ordered=ordered)


def _same_as_oracle(got, want, combiner, what):
    rtol, atol = ORACLE_TOL.get(combiner, (0.0, 0.0))
    _same(got, want, what, rtol=rtol, atol=atol)


def _tablet_counters(st):
    return (st._c_tablet_splits.value, st._c_tablet_moves.value,
            st._c_tablet_merges.value)


def _same_maps(j, t, what):
    """The JAX store's map and the port's: manifest (split keys, ids,
    owners, next id), float64 loads bit for bit, and the counters."""
    assert t.tablet_map.to_manifest() == j.tablet_map.to_manifest(), what
    np.testing.assert_array_equal(t.tablet_map.loads, j.tablet_map.loads,
                                  err_msg=what)
    assert _tablet_counters(t) == _tablet_counters(j), what
    assert ([c.value for c in t._c_shard_ingest]
            == [c.value for c in j._c_shard_ingest]), what
    assert ([c.value for c in t._c_shard_query]
            == [c.value for c in j._c_shard_query]), what


# ------------------------------------------------------------------ the map
def _map_ops(seed, n_ops=60):
    """A random op sequence valid on either map: (name, args) tuples,
    drawn against the port's map as it evolves."""
    rng = np.random.default_rng(seed)
    cap = int(rng.choice([997, 1 << 12, 1 << 16]))
    n_shards = int(rng.integers(1, 7))
    tm = TabletMap.uniform(n_shards, cap)
    ops = [("uniform", (n_shards, cap))]
    for _ in range(n_ops):
        kind = rng.choice(["split", "move", "merge", "load", "touch",
                           "decay"], p=[0.3, 0.2, 0.1, 0.2, 0.1, 0.1])
        lo, hi = tm.ranges()
        if kind == "split":
            i = int(rng.integers(tm.n))
            if hi[i] - lo[i] < 2:
                continue
            op = ("split", (int(tm.tablet_ids[i]),
                            int(rng.integers(lo[i] + 1, hi[i]))))
        elif kind == "move":
            op = ("move", (int(rng.choice(tm.tablet_ids)),
                           int(rng.integers(n_shards))))
        elif kind == "merge":
            same = np.flatnonzero(tm.owners[:-1] == tm.owners[1:])
            if not len(same):
                continue
            op = ("merge", (int(tm.tablet_ids[rng.choice(same)]),))
        elif kind == "load":
            ids = (rng.zipf(1.3, 64) % cap).astype(np.int64)
            op = ("load", (tm.tablet_of(ids), float(rng.uniform(0.5, 2))))
        elif kind == "touch":
            a = int(rng.integers(0, cap))
            op = ("touch", (a, a + int(rng.integers(0, cap // 3 + 1))))
        else:
            op = ("decay", (float(rng.uniform(0.2, 0.9)),))
        _apply(tm, op)
        ops.append(op)
    return ops


def _apply(tm, op):
    name, args = op
    if name == "split":
        return tm.split(*args)
    if name == "move":
        return tm.move(*args)
    if name == "merge":
        return tm.merge(*args)
    if name == "load":
        return tm.record_load(*args)
    if name == "touch":
        return tm.touch_range(*args)
    return tm.decay(*args)


@pytest.mark.parametrize("seed", range(6))
def test_map_sequences_match_jax(seed):
    ops = _map_ops(seed)
    t = TabletMap.uniform(*ops[0][1])
    j = JaxMap.uniform(*ops[0][1])
    cap = ops[0][1][1]
    probe = np.random.default_rng(seed + 100).integers(0, cap, 512)
    for op in ops[1:]:
        assert _apply(t, op) == _apply(j, op), op
        assert t.to_manifest() == j.to_manifest(), op
        np.testing.assert_array_equal(t.loads, j.loads)
    np.testing.assert_array_equal(t.tablet_of(probe), j.tablet_of(probe))
    np.testing.assert_array_equal(t.owner_of(probe), j.owner_of(probe))
    for a, b in zip(t.ranges(), j.ranges()):
        np.testing.assert_array_equal(a, b)
    for lo, hi in [(0, cap), (cap // 7, cap // 2), (5, 5), (-3, cap + 9)]:
        assert t.segments(lo, hi) == j.segments(lo, hi)
    np.testing.assert_array_equal(t.shard_loads(), j.shard_loads())
    assert t.shard_balance() == j.shard_balance()
    for s in range(t.num_shards):
        np.testing.assert_array_equal(t.sample_shard_ids(s),
                                      j.sample_shard_ids(s))
    back = TabletMap.from_manifest(json.loads(json.dumps(t.to_manifest())))
    assert back.to_manifest() == t.to_manifest()
    assert JaxMap.from_manifest(t.to_manifest()).to_manifest() == \
        t.to_manifest()


def test_map_errors_match_jax():
    for cls in (TabletMap, JaxMap):
        tm = cls.uniform(4, 1 << 12)
        right = tm.split(0, 100)
        assert right == 4 and tm.range_of(right) == (100, 1024)
        with pytest.raises(ValueError, match="interior"):
            tm.split(0, 0)
        tm.move(right, 3)
        with pytest.raises(ValueError, match="one shard"):
            tm.merge(0)
        with pytest.raises(ValueError, match="right neighbor"):
            tm.merge(int(tm.tablet_ids[-1]))
        with pytest.raises(KeyError):
            tm.index_of(99)
        with pytest.raises(ValueError, match="budget"):
            tm.device_routing(3)
        with pytest.raises(ValueError, match="increasing"):
            cls(np.asarray([5, 5]), np.arange(3), np.zeros(3), 10, 1, 3)


@pytest.mark.parametrize("n_shards", [1, 3, 4, 7])
def test_uniform_map_routes_as_shard_of(n_shards):
    rng = np.random.default_rng(n_shards)
    for cap in (512, 1 << 16, 1000003):
        tm = TabletMap.uniform(n_shards, cap)
        ids = rng.integers(0, cap, 4096)
        np.testing.assert_array_equal(tm.owner_of(ids),
                                      shard_of(ids, n_shards, cap))


@pytest.mark.parametrize("kind", ["padded", "uniform"])
def test_device_routing_matches_jax(kind):
    maps = [TabletMap.uniform(S, ID_CAP), JaxMap.uniform(S, ID_CAP)]
    if kind == "padded":
        for tm in maps:
            tm.split(1, int(ID_CAP * 0.3))
            tm.move(4, 3)
            tm.split(0, 7)
    (ts, to), (js, jo) = (tm.device_routing(8 * S) for tm in maps)
    for a, b in ((ts, js), (to, jo)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert ts.shape == (8 * S - 1,) and to.shape == (8 * S,)
    # the padded split slots carry id_capacity: no valid id selects them
    assert (ts[maps[0].n - 1:] == ID_CAP).all()
    ids = np.random.default_rng(3).integers(0, ID_CAP, 1024)
    tidx = np.searchsorted(ts.astype(np.int64), ids, side="right")
    np.testing.assert_array_equal(to[tidx], maps[0].owner_of(ids))


# ---------------------------------------------------------------- the store
@pytest.mark.parametrize("combiner", COMBINERS)
def test_zipf_stream_matches_jax_and_oracle(combiner):
    """A Zipf stream with a rebalance round after every three batches: the
    two maps agree after every round, and the store reads back like the
    JAX store and like the never-split oracle."""
    j, t, o = _stores(f"z_{combiner}", combiner)
    rng = np.random.default_rng(11)
    for rd in range(4):
        for _ in range(3):
            batch = _zipf_batch(rng, 200)
            for st in (j, t, o):
                st.insert(*batch)
        got = t.maybe_rebalance()
        assert got == j.maybe_rebalance(), rd
        _same_maps(j, t, f"round {rd}")
        scan = t.scan()
        _same_as_jax(scan, j.scan(), combiner, f"round {rd} scan vs JAX")
        _same_as_oracle(scan, o.scan(), combiner, f"round {rd} vs oracle")
    assert t.tablet_map.n > S
    assert _tablet_counters(t)[0] > 0 and _tablet_counters(t)[1] > 0
    q = (rng.zipf(ZIPF_S, 512) % ID_CAP).astype(np.int32)
    got = t.query_rows(q)
    _same_as_jax(got, j.query_rows(q), combiner, "point read vs JAX")
    _same_as_oracle(got, o.query_rows(q), combiner, "point read vs oracle")
    # a range across every split keeps global (row, col) order
    got = t.scan_range(3, ID_CAP - 5)
    _same_as_jax(got, j.scan_range(3, ID_CAP - 5), combiner,
                 "range vs JAX", ordered=True)
    assert np.all(np.diff(got[0].astype(np.int64) * ID_CAP + got[1]) > 0)
    _same_as_oracle(got, o.scan_range(3, ID_CAP - 5), combiner,
                    "range vs oracle")
    _same_maps(j, t, "after the reads")  # reads record load
    assert t.engine_stats() == j.engine_stats()


def test_sequential_stream_with_merges_matches_jax():
    """Sequential keys sweep the id space (time-series ingest): the hot
    tablet keeps moving and cold pairs merge back, moving first when
    their owners differ."""
    j, t, o = _stores("seq")
    rng = np.random.default_rng(5)
    keys = np.arange(2048, dtype=np.int64) % ID_CAP
    for i in range(0, len(keys), 256):
        r = keys[i:i + 256].astype(np.int32)
        c = rng.integers(0, 16, len(r)).astype(np.int32)
        v = rng.normal(size=len(r)).astype(np.float32)
        for st in (j, t, o):
            st.insert(r, c, v)
        assert t.maybe_rebalance() == j.maybe_rebalance()
        tm = t.tablet_map
        if tm.n > 2 * S:
            i_cold = int(np.argmin(tm.loads[:-1] + tm.loads[1:]))
            tid = int(tm.tablet_ids[i_cold])
            assert t.merge_tablet(tid) and j.merge_tablet(tid)
        _same_maps(j, t, f"batch {i}")
    assert _tablet_counters(t)[2] > 0
    _same(t.scan(), j.scan(), "scan vs JAX")
    _same(t.scan(), o.scan(), "scan vs oracle")
    assert t.engine_stats() == j.engine_stats()


def test_explicit_ops_and_warm_reads_match_jax():
    """Explicit split (given key, fence median), move and merge, the
    refusals, ``warm_reads`` under a skewed map (its probe reads record
    load) and the health gauges."""
    from repro.obs import default_registry as jax_registry
    from repro_torch.obs import default_registry
    j, t, o = _stores("ops", "max")
    rng = np.random.default_rng(2)
    for _ in range(3):
        batch = _zipf_batch(rng, 200)
        for st in (j, t, o):
            st.insert(*batch)
    for st in (j, t):
        assert st.split_tablet(0, key=5) == 4
        assert st.split_tablet(0, key=5) is None      # not interior
        assert st.split_tablet() == 5                  # hottest, fence median
        assert st.move_tablet(4, 2) and not st.move_tablet(4, 2)
        with pytest.raises(ValueError, match="out of range"):
            st.move_tablet(4, S)
        assert st.merge_tablet(0)                      # moves 4 back first
        assert not st.merge_tablet(int(st.tablet_map.tablet_ids[-1]))
        st.warm_reads()
        st.refresh_health_gauges()
    _same_maps(j, t, "after the ops")
    _same(t.scan(), j.scan(), "scan vs JAX")
    _same(t.scan(), o.scan(), "scan vs oracle")
    for name in ("lsm_tablets", "lsm_tablet_balance"):
        assert (default_registry().series(name, table="t_ops")[0].value
                == jax_registry().series(name, table="j_ops")[0].value)
    with pytest.raises(ValueError, match="dynamic_tablets=True"):
        o.split_tablet()
    # the static store ignores replayed meta frames
    o._apply_replayed_meta({"op": "split", "tablet": 0, "key": 5, "new": 9})
    assert o.tablet_map is None


# ------------------------------------------------------------- durability
def _files(d):
    return {p.name: p.read_bytes() for p in sorted(Path(d).iterdir())
            if p.is_file()}


def _same_dirs(jd, td, what):
    """Logs byte for byte, manifests as dicts, snapshots array by array."""
    jf, tf = _files(jd), _files(td)
    assert sorted(jf) == sorted(tf), what
    for name in jf:
        if name == "MANIFEST.json":
            jm, tm = json.loads(jf[name]), json.loads(tf[name])
            assert tm == jm, what
            assert tm["format"] == 3 and "tablets" in tm, what
        elif name == "snapshot.npz":
            with np.load(os.path.join(jd, name)) as zj, \
                    np.load(os.path.join(td, name)) as zt:
                assert sorted(zj.files) == sorted(zt.files), what
                for k in zj.files:
                    np.testing.assert_array_equal(zt[k], zj[k],
                                                  err_msg=f"{what} {k}")
        else:
            assert jf[name] == tf[name], (what, name)


def _write_churn(st, rng, oracle=None):
    """Four batches, a checkpoint, then three batches with a rebalance
    round after each (moves after the checkpoint migrate in the replay),
    a merge of one adjacent same-owner pair if any, and a last batch."""
    def put():
        batch = _zipf_batch(rng, 200)
        st.insert(*batch)
        if oracle is not None:
            oracle.insert(*batch)
    for _ in range(4):
        put()
    st.checkpoint()
    for _ in range(3):
        put()
        st.maybe_rebalance()
    tm = st.tablet_map
    for i in range(tm.n - 1):
        if tm.owners[i] == tm.owners[i + 1]:
            st.merge_tablet(int(tm.tablet_ids[i]))
            break
    put()


@pytest.mark.parametrize("pair", [False, True], ids=["single", "pair"])
def test_wal_bytes_and_manifest_match_jax(tmp_path, pair):
    name = f"tab_bytes_{pair}"
    jd, td = str(tmp_path / "jax" / name), str(tmp_path / "torch" / name)
    j = JaxTable(name, dynamic_tablets=True, wal_dir=jd, transpose=pair,
                 **CFG)
    t = TorchTable(name, dynamic_tablets=True, wal_dir=td, transpose=pair,
                   device="cpu", **CFG)
    for st in (j, t):
        _write_churn(st, np.random.default_rng(31))
    _same_maps(j, t, "writer maps")
    assert _tablet_counters(t)[:2] > (0, 0)
    j.checkpoint()
    t.checkpoint()
    _same_dirs(jd, td, "final")
    frames = list(WriteAheadLog.replay_full(os.path.join(td, "wal.log")))
    metas = [f[1] for f in frames if f[0] == "meta"]
    assert {m["op"] for m in metas} >= {"split", "move"}
    keys = {"split": {"op", "tablet", "key", "new"},
            "move": {"op", "tablet", "to"}, "merge": {"op", "tablet"}}
    assert all(set(m) == keys[m["op"]] for m in metas)
    assert all(f[1] is not None and f[5] == pair
               for f in frames if f[0] == "data")
    if pair:  # the sibling stays static and holds the exact transpose
        assert t.t_store.tablet_map is None
        r, c, v = t.scan()
        _same(t.t_store.scan(), (c, r, v), "sibling")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_format3_directories_cross_recover(tmp_path, direction):
    """A crashed dynamic-tablet pair (the checkpoint's map, then split,
    move and merge frames in the suffix) recovers in the other package to
    the writer's map and data, and to what its own package recovers."""
    name = f"tab_cross_{direction}"
    d = str(tmp_path / name)
    writer_cls = JaxTable if direction == "jax_to_port" else TorchTable
    extra = {} if writer_cls is JaxTable else {"device": "cpu"}
    w = writer_cls(name, dynamic_tablets=True, wal_dir=d, transpose=True,
                   combiner="sum", **CFG, **extra)
    _write_churn(w, np.random.default_rng(8))
    want_map = w.tablet_map.to_manifest()
    want, want_t = w.scan(), w.t_store.scan()
    w._wal.close()  # crash
    with open(os.path.join(d, "MANIFEST.json")) as f:
        assert json.load(f)["format"] == 3
    # each package recovers a copy (recovery re-anchors and appends)
    dj, dt = d + "_j", d + "_t"
    shutil.copytree(d, dj)
    shutil.copytree(d, dt)
    rj = jax_recover(dj)
    rt = recover(dt, device="cpu")
    for rec in (rj, rt):
        assert rec.tablet_map.to_manifest() == want_map
        _same(rec.scan(), want, "recovered scan", rtol=1e-5, atol=1e-6)
        _same(rec.t_store.scan(), want_t, "recovered sibling", rtol=1e-5,
              atol=1e-6)
    np.testing.assert_array_equal(rt.tablet_map.loads, rj.tablet_map.loads)
    _same(rt.scan(), rj.scan(), "port vs JAX recovery", rtol=1e-6)
    q = np.arange(0, 64, dtype=np.int32)
    _same(rt.query_rows(q), rj.query_rows(q), "point read", rtol=1e-6)
    rj._wal.close()
    rt._wal.close()


# ----------------------------------------- truncation and per-tablet replay
N_PRE, BATCH_N = 3, 4  # tests/test_lsm_fuzz.py's tablet-window geometry


def _build_tablet_wal_dir(root, cls):
    """A dynamic-tablet pair whose post-checkpoint log interleaves tagged
    pair frames with a split and a move (``tests/test_lsm_fuzz.py``'s
    ``_build_tablet_wal_dir``, on either package). Returns (dir, the
    checkpointed triples as a last-wins dict, checkpoint offset, [win_lo,
    win_hi) around the split / move frames)."""
    d = os.path.join(root, "tdb")
    extra = {} if cls is JaxTable else {"device": "cpu"}
    st = cls("fzt_tab", num_shards=2, capacity_per_shard=1024, batch_cap=64,
             id_capacity=1 << 9, combiner="last", memtable_cap=64,
             engine="lsm", wal_dir=d, transpose=True, dynamic_tablets=True,
             **extra)
    rng = np.random.default_rng(42)
    base = {}

    def put():
        r = rng.choice(1 << 9, BATCH_N, replace=False).astype(np.int32)
        c = rng.integers(0, 4, BATCH_N).astype(np.int32)
        v = rng.normal(size=BATCH_N).astype(np.float32)
        st.insert(r, c, v)
        return r, c, v

    for _ in range(N_PRE):
        for a, b, x in zip(*put()):
            base[(int(a), int(b))] = float(x)
    st.checkpoint()
    ckpt_off = st._wal.tell()
    put()
    win_lo = st._wal.tell()
    new_id = st.split_tablet()
    assert new_id is not None
    put()
    cur = int(st.tablet_map.owners[st.tablet_map.index_of(new_id)])
    assert st.move_tablet(new_id, 1 - cur)
    put()
    win_hi = st._wal.tell()
    put()
    st._wal.close()  # crash
    return d, base, ckpt_off, win_lo, win_hi


def _tablet_frame_oracle(wal_path, ckpt_off, base_rows, tablet_filter=None):
    """Host replay of the intact post-checkpoint frames of a (cut) log
    onto a dict and a map: no engine, no migration, no memtable."""
    tm = TabletMap.uniform(2, 1 << 9)
    rows = dict(base_rows)
    for item in WriteAheadLog.replay_full(wal_path, start=ckpt_off):
        if item[0] == "meta":
            op = item[1]
            if op["op"] == "split":
                tm.split(op["tablet"], op["key"], new_id=op["new"])
            elif op["op"] == "move":
                tm.move(op["tablet"], op["to"])
            else:
                tm.merge(op["tablet"])
            continue
        _, tid, r, c, v, pair = item
        assert pair and tid is not None
        if tablet_filter is not None and tid not in tablet_filter:
            continue
        for a, b, x in zip(r, c, v):
            rows[(int(a), int(b))] = float(x)
    return tm, rows


def _scan_dict(st):
    r, c, v = st.scan()
    return {(int(a), int(b)): float(x) for a, b, x in zip(r, c, v)}


def test_tablet_window_truncation_matches_oracle(tmp_path):
    """Cut the port's log every few bytes across the split / move window
    (and at sampled earlier offsets and the tail): the port's recovery
    restores exactly the meta-frame prefix below the cut and the
    intact-frame data, the sibling as its transpose; at the frame
    boundaries the JAX package recovers the same cut to the same state.
    The JAX package writes the same log."""
    src, base, ckpt_off, win_lo, win_hi = _build_tablet_wal_dir(
        str(tmp_path / "torch"), TorchTable)
    jsrc = _build_tablet_wal_dir(str(tmp_path / "jax"), JaxTable)[0]
    wal = os.path.join(src, "wal.log")
    assert Path(wal).read_bytes() == Path(jsrc, "wal.log").read_bytes()
    size = os.path.getsize(wal)
    rng = np.random.default_rng(13)
    sampled = {int(x) for x in rng.integers(ckpt_off, win_lo, 3)}
    cuts = sorted(sampled | set(range(win_lo - 4, win_hi + 1, 7))
                  | {win_lo, win_hi, win_hi + 1, size - 1, size})
    seen_maps = set()
    for cut in cuts:
        d = str(tmp_path / f"tcut{cut}")
        shutil.copytree(src, d)
        os.truncate(os.path.join(d, "wal.log"), cut)
        want_tm, want = _tablet_frame_oracle(os.path.join(d, "wal.log"),
                                             ckpt_off, base)
        st = recover(d, device="cpu")
        assert st.tablet_map.to_manifest() == want_tm.to_manifest(), cut
        got = _scan_dict(st)
        assert got == pytest.approx(want), cut
        assert _scan_dict(st.t_store) == pytest.approx(
            {(b, a): v for (a, b), v in want.items()}), cut
        st._wal.close()
        seen_maps.add(json.dumps(want_tm.to_manifest()))
        if cut in (win_lo, win_hi, size):
            shutil.copytree(src, d + "_j")
            os.truncate(os.path.join(d + "_j", "wal.log"), cut)
            js = jax_recover(d + "_j")
            assert js.tablet_map.to_manifest() == want_tm.to_manifest()
            assert _scan_dict(js) == got, cut
            js._wal.close()
    assert len(seen_maps) == 3  # before the split, after it, after the move


def test_tablet_filter_replays_one_tablet(tmp_path):
    """``recover(d, tablet_filter=[t])`` restores the whole map (meta
    frames always apply) and replays only tablet ``t``'s frames, for every
    tablet of the final map; a write after it stays readable; the JAX
    package's filtered recovery of the same log agrees."""
    src, base, ckpt_off, _, _ = _build_tablet_wal_dir(str(tmp_path),
                                                      TorchTable)
    wal = os.path.join(src, "wal.log")
    full_tm, _ = _tablet_frame_oracle(wal, ckpt_off, base)
    for tid in full_tm.tablet_ids.tolist():
        d = str(tmp_path / f"tf{tid}")
        shutil.copytree(src, d)
        shutil.copytree(src, d + "_j")
        st = recover(d, tablet_filter=[tid], device="cpu")
        assert st.tablet_map.to_manifest() == full_tm.to_manifest(), tid
        _, want = _tablet_frame_oracle(wal, ckpt_off, base,
                                       tablet_filter={tid})
        assert _scan_dict(st) == pytest.approx(want), tid
        assert _scan_dict(st.t_store) == pytest.approx(
            {(b, a): v for (a, b), v in want.items()}), tid
        js = jax_recover(d + "_j", tablet_filter=[tid])
        assert _scan_dict(js) == _scan_dict(st), tid
        np.testing.assert_array_equal(st.tablet_map.loads,
                                      js.tablet_map.loads)
        js._wal.close()
        st.insert(np.asarray([500], np.int32), np.asarray([3], np.int32),
                  np.asarray([6.5], np.float32))
        r, _c, v = st.query_rows(np.asarray([500], np.int32))
        assert r.tolist() == [500] and v[0] == pytest.approx(6.5)
        st._wal.close()


# -------------------------------------------------------------- connector
def _string_stream(rng, n_batches=6, n=150):
    for _ in range(n_batches):
        r = np.asarray([f"r{int(x):05d}" for x in
                        rng.zipf(ZIPF_S, n) % 3000], object)
        c = np.asarray([f"c{int(x):03d}" for x in rng.integers(0, 40, n)],
                       object)
        yield r, c, rng.integers(1, 9, n).astype(np.float64)


def test_connector_tablets_metrics_match_jax():
    """``dbsetup(..., dynamic_tablets=True)`` binds a pair whose row table
    splits and whose sibling stays static; ``metrics()`` carries the same
    ``tablets`` section as the JAX connector's."""
    conf = dict(num_shards=S, capacity_per_shard=1 << 14, batch_cap=1024,
                id_capacity=1 << 13, memtable_cap=256, dynamic_tablets=True)
    jdb = jax_dbsetup("tab_jx", conf)
    tdb = dbsetup("tab_pt", conf, device="cpu")
    jp, tp = jdb["Jtab", "JtabT"], tdb["Ptab", "PtabT"]
    rng = np.random.default_rng(4)
    for r, c, v in _string_stream(rng):
        jp.put_triple(r, c, v)
        tp.put_triple(r, c, v)
        assert (tp.table.store.maybe_rebalance()
                == jp.table.store.maybe_rebalance())
    assert tp.table.store.t_store.tablet_map is None
    jm = jdb.metrics()["tables"]["Jtab"]["tablets"]
    tm = tdb.metrics()["tables"]["Ptab"]["tablets"]
    assert tm == jm
    assert tm["count"] > S and tm["splits"] > 0 and tm["moves"] > 0
    got, want = tp["r00001,", :], jp["r00001,", :]
    assert got.nnz() == want.nnz() > 0
    assert ({(str(a), str(b), float(x)) for a, b, x in zip(*got.triples())}
            == {(str(a), str(b), float(x))
                for a, b, x in zip(*want.triples())})


def test_recover_connector_restores_a_dynamic_pair(tmp_path):
    """A dynamic-tablet pair checkpointed, rebalanced and crashed through
    the connector recovers in both packages to the same map and the same
    string-keyed reads."""
    conf = dict(num_shards=S, capacity_per_shard=1 << 14, batch_cap=1024,
                id_capacity=1 << 13, memtable_cap=256, dynamic_tablets=True)
    root = str(tmp_path / "root")
    db = dbsetup("tab_rec", conf, wal_root=root, device="cpu")
    pair = db["Rtab", "RtabT"]
    rng = np.random.default_rng(6)
    for i, (r, c, v) in enumerate(_string_stream(rng)):
        pair.put_triple(r, c, v)
        if i == 2:
            pair.checkpoint()
        pair.table.store.maybe_rebalance()
    want_map = pair.table.store.tablet_map.to_manifest()
    want = {k: pair[k, :] for k in ("r00001,", "r00002,r00017,")}
    pair.table.store._wal.close()  # crash
    jroot = str(tmp_path / "jroot")
    shutil.copytree(root, jroot)
    _, rp = recover_connector(root, ("Rtab", "RtabT"), device="cpu")
    _, jrp = jax_recover_connector(jroot, ("Rtab", "RtabT"))
    for rec in (rp, jrp):
        assert rec.table.store.tablet_map.to_manifest() == want_map
        for k, a in want.items():
            b = rec[k, :]
            assert ({(str(x), str(y), float(z))
                     for x, y, z in zip(*a.triples())}
                    == {(str(x), str(y), float(z))
                        for x, y, z in zip(*b.triples())}), k
    assert rp.table.store.device.type == "cpu"
    r, c, _ = rp.table.store.scan()
    tr, tc, _ = rp.table.store.t_store.scan()
    _same((tc, tr, np.zeros(len(tr))), (r, c, np.zeros(len(r))),
          "recovered sibling")
    rp.table.store._wal.close()
    jrp.table.store._wal.close()


# -------------------------------------------------------------- the card
@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA "
                    "device: the hand kernels run only on the card")
def test_split_move_and_recovery_on_the_card(tmp_path):
    """On the card with the hand kernels: a Zipf stream splits and moves
    tablets (the migrations' flushes and compactions run the merge-path
    kernel), every read equals the same store on the CPU, and the crashed
    store recovers on the card to the writer's map and data."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    d = str(tmp_path / "card")
    kw = dict(CFG, combiner="sum", dynamic_tablets=True, transpose=True)
    card = TorchTable("tab_card", wal_dir=d, use_pallas=True, device="cuda",
                      **kw)
    cpu = TorchTable("tab_card_cpu", device="cpu", **kw)
    rng = np.random.default_rng(9)
    reset_launches()
    for i in range(12):
        batch = _zipf_batch(rng, 200)
        card.insert(*batch)
        cpu.insert(*batch)
        if i == 3:
            card.checkpoint()
        if i % 2:
            assert card.maybe_rebalance() == cpu.maybe_rebalance()
    assert card.tablet_map.to_manifest() == cpu.tablet_map.to_manifest()
    assert _tablet_counters(card)[:2] > (0, 0)
    _same(card.scan(), cpu.scan(), "card vs cpu", rtol=1e-6)
    q = (rng.zipf(ZIPF_S, 256) % ID_CAP).astype(np.int32)
    _same(card.query_rows(q), cpu.query_rows(q), "point read", rtol=1e-6)
    _same(card.scan_range(3, ID_CAP - 5), cpu.scan_range(3, ID_CAP - 5),
          "range", rtol=1e-6, ordered=True)
    assert LAUNCHES["merge_path_rank"] > 0 and LAUNCHES["rank_batched"] > 0
    want_map, want = card.tablet_map.to_manifest(), card.scan()
    card._wal.close()  # crash
    rec = recover(d, device="cuda")
    assert rec.device.type == "cuda" and rec.use_pallas
    assert rec.tablet_map.to_manifest() == want_map
    _same(rec.scan(), want, "recovered", rtol=1e-5, atol=1e-6)
    rec._wal.close()
