"""Durability in the port against the JAX package: the same inserts write
the same write-ahead log bytes (single table and transpose pair) and,
through the connector, the same dictionary journals; a snapshot + WAL
written by either package recovers in the other to the same ``scan()``;
the manifests are equal as dicts and the snapshot arrays array by array;
and the connector-level recovery paths (pair checkpoint, dictionary crash
window) restore the same string-keyed reads in both packages.

Each store gets its own name and directory (a recovered table takes its
name from the manifest, and the port's registry resets series by name).
"""
import json
import os
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.db import dbsetup as jax_dbsetup
from repro.db import recover_connector as jax_recover_connector
from repro.db.kvstore import ShardedTable as JaxTable
from repro.db.lsm import recover as jax_recover
from repro_torch.db import dbsetup, recover_connector
from repro_torch.db.kvstore import ShardedTable as TorchTable
from repro_torch.db.kvstore import StoreConfig
from repro_torch.db.lsm import WriteAheadLog, recover

CFG = dict(num_shards=2, capacity_per_shard=256, batch_cap=32,
           id_capacity=128, memtable_cap=16)
RTOL = {"sum": 1e-6, "last": 0}


def _batches(seed, n_batches=8, n=12, idc=128):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, idc, n).astype(np.int32),
             rng.integers(0, idc, n).astype(np.int32),
             rng.integers(-8, 9, n).astype(np.float32))
            for _ in range(n_batches)]


def _sorted(t):
    r, c, v = (np.asarray(x) for x in t)
    o = np.lexsort((c, r))
    return r[o], c[o], v[o]


def _same_scan(a, b, rtol, what):
    (ar, ac, av), (br, bc, bv) = _sorted(a), _sorted(b)
    np.testing.assert_array_equal(ar, br, err_msg=what + " rows")
    np.testing.assert_array_equal(ac, bc, err_msg=what + " cols")
    np.testing.assert_allclose(av, bv, rtol=rtol, atol=0, err_msg=what)


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(Path(d).iterdir())
            if p.is_file()}


def _as_str_set(assoc):
    r, c, v = assoc.triples()
    return {(str(a), str(b), float(x)) for a, b, x in zip(r, c, v)}


def _same_dirs(jd, td, what):
    """Both packages' durability directories hold the same files: logs and
    dictionary snapshots byte for byte, manifests as dicts, snapshots
    array by array (the npz bytes need not match)."""
    jf, tf = _files(jd), _files(td)
    assert sorted(jf) == sorted(tf), what
    for name in jf:
        if name == "MANIFEST.json":
            assert json.loads(jf[name]) == json.loads(tf[name]), what
        elif name == "snapshot.npz":
            with np.load(os.path.join(jd, name)) as zj, \
                    np.load(os.path.join(td, name)) as zt:
                assert sorted(zj.files) == sorted(zt.files), what
                for k in zj.files:
                    assert zj[k].dtype == zt[k].dtype, (what, k)
                    np.testing.assert_array_equal(zt[k], zj[k],
                                                  err_msg=f"{what} {k}")
        else:
            assert jf[name] == tf[name], (what, name)


@pytest.mark.parametrize("pair", [False, True], ids=["single", "pair"])
def test_wal_and_snapshot_match_jax(tmp_path, pair):
    """Byte-identical WALs (one pair-flagged frame per batch for a pair),
    equal manifests and equal snapshot arrays, at a checkpoint midway and
    at the end; the port's frames replay to the batches it was fed."""
    name = f"dur_bytes_{pair}"
    jd, td = str(tmp_path / "jax" / name), str(tmp_path / "torch" / name)
    js = JaxTable(name, combiner="last", wal_dir=jd, transpose=pair, **CFG)
    ts = TorchTable(name, combiner="last", wal_dir=td, transpose=pair,
                    device="cpu", **CFG)
    batches = _batches(1)
    for i, (r, c, v) in enumerate(batches):
        js.insert(r, c, v)
        ts.insert(r, c, v)
        if i == 4:
            assert js.checkpoint().endswith("MANIFEST.json")
            ts.checkpoint()
            _same_dirs(jd, td, "midway")
    js.checkpoint()
    ts.checkpoint()
    _same_dirs(jd, td, "end")
    frames = list(WriteAheadLog.replay(os.path.join(td, "wal.log"),
                                       tagged=True))
    assert len(frames) == len(batches)
    for (r, c, v, p), (br, bc, bv) in zip(frames, batches):
        assert p == pair
        np.testing.assert_array_equal(r, br)
        np.testing.assert_array_equal(c, bc)
        np.testing.assert_array_equal(v, bv)
    _same_scan(ts.scan(), js.scan(), 0, "scan")
    ts.refresh_health_gauges()
    from repro_torch.obs import default_registry
    g = default_registry().series("wal_backlog_bytes", log=name)
    assert g and g[0].value == 0  # everything is covered by the snapshot
    ts.close()
    assert ts._wal is None
    js.close()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_and_wal_recover_across_packages(tmp_path, direction):
    """A pair checkpointed midway plus a WAL suffix, written by one package
    and recovered by the other, scans to the writer's state (values to
    the sum combiner's tolerance), both sides of the pair."""
    name = f"dur_cross_{direction}"
    d = str(tmp_path / name)
    to_port = direction == "jax_to_port"
    if to_port:
        w = JaxTable(name, combiner="sum", wal_dir=d, transpose=True, **CFG)
    else:
        w = TorchTable(name, combiner="sum", wal_dir=d, transpose=True,
                       device="cpu", **CFG)
    for i, (r, c, v) in enumerate(_batches(2, n_batches=10)):
        w.insert(r, c, v)
        if i == 5:
            w.checkpoint()
    want, want_t = w.scan(), w.t_store.scan()
    w._wal.close()  # crash: the suffix lives only in the WAL
    rec = recover(d, device="cpu") if to_port else jax_recover(d)
    assert rec.t_store is not None and rec.combiner == "sum"
    _same_scan(rec.scan(), want, RTOL["sum"], direction)
    _same_scan(rec.t_store.scan(), want_t, RTOL["sum"], direction + " T")
    rec.close()


def test_connector_journals_match_jax(tmp_path):
    """Through the connector, with string keys and string values, batched
    by a small ``char_budget``: the key and value dictionary journals, the
    pair's WAL (same frame boundaries) and, after a checkpoint, the
    dictionary snapshots and manifests are the JAX package's."""
    roots = {k: str(tmp_path / k) for k in ("jax", "torch")}
    conf = dict(CFG, capacity_per_shard=1024, memtable_cap=64,
                char_budget=120)
    dbs = {"jax": jax_dbsetup("durj", dict(conf, wal_root=roots["jax"])),
           "torch": dbsetup("durt", dict(conf, wal_root=roots["torch"]),
                            device="cpu")}
    # one table name in both: each package has its own registry
    pairs = {k: db["edges", "edgesT"] for k, db in dbs.items()}
    rng = np.random.default_rng(4)

    def put(n):
        rows = np.asarray([f"e{i:03d}" for i in rng.integers(0, 40, n)],
                          object)
        cols = np.asarray([f"v{i:03d}" for i in rng.integers(0, 40, n)],
                          object)
        vals = np.asarray([f"w{i}" for i in rng.integers(0, 9, n)], object)
        for p in pairs.values():
            p.put_triple(rows, cols, vals)

    def same(what):
        _same_dirs(roots["jax"], roots["torch"], what + " root")
        _same_dirs(os.path.join(roots["jax"], "edges"),
                   os.path.join(roots["torch"], "edges"), what)

    put(30)
    frames = list(WriteAheadLog.replay(
        os.path.join(roots["torch"], "edges", "wal.log")))
    assert len(frames) > 2  # the batches' frame boundaries are compared
    same("before checkpoint")
    for p in pairs.values():
        p.checkpoint()
    same("checkpoint")
    put(20)
    same("after checkpoint")
    for k in ("jax", "torch"):
        assert pairs[k]["e001,:,e020,", :].nnz() > 0


def test_pair_checkpoint_and_recovery_match_jax(tmp_path):
    """tests/test_transpose_pairs.py::test_pair_checkpoint_and_recovery on
    the port: one checkpoint covers both sides, recovery by the
    (name, name_t) tuple rebuilds the pair with its post-checkpoint
    batches, column routing still works, the single name recovers too, and
    tuple recovery of a non-pair table refuses. Each recovery reads as the
    JAX package's recovery of the same operations."""
    def run(pkg):
        d = str(tmp_path / pkg)
        mk = jax_dbsetup if pkg == "jax" else (
            lambda *a: dbsetup(*a, device="cpu"))
        rec = jax_recover_connector if pkg == "jax" else (
            lambda *a: recover_connector(*a, device="cpu"))
        DB = mk(f"durpair_{pkg}", dict(num_shards=2, capacity_per_shard=2048,
                                       batch_cap=256, id_capacity=1 << 10,
                                       wal_root=d))
        E = DB["edges", "edgesT"]
        rng = np.random.default_rng(1)
        E.put_triple(
            np.asarray([f"e{i:03d}" for i in rng.integers(0, 30, 60)], object),
            np.asarray([f"v{i:03d}" for i in rng.integers(0, 30, 60)], object),
            rng.integers(1, 9, 60).astype(float))
        E.checkpoint()
        E.put_triple(np.asarray(["zz"], object), np.asarray(["yy"], object),
                     np.asarray([42.0]))
        want = _as_str_set(E[:, :])
        del E, DB  # crash
        DB2, E2 = rec(d, ("edges", "edgesT"))
        store = E2.table.store
        assert store.t_store is not None
        assert store.nnz() == store.t_store.nnz()
        assert _as_str_set(E2[:, :]) == want
        reads = {"all": want,
                 "col_range": _as_str_set(E2[:, "v005,:,v015,"]),
                 "row": _as_str_set(E2["e003,zz,", :]),
                 "view": _as_str_set(DB2.tables["edgesT"]["yy,", :])}
        del E2, DB2
        DB3, T3 = rec(d, "edges")
        assert _as_str_set(T3[:, :]) == want
        T4 = DB3["plain"]
        T4.put_triple(np.asarray(["a"], object), np.asarray(["b"], object),
                      np.asarray([1.0]))
        T4.checkpoint()
        del T4, DB3
        with pytest.raises(ValueError, match="pair"):
            rec(d, ("plain", "plainT"))
        return reads

    got = run("torch")
    assert got == run("jax")
    assert ("zz", "yy", 42.0) in got["all"] and got["col_range"]
    assert got["view"] == {("yy", "zz", 42.0)}


def test_dict_crash_window_keeps_ids_stable(tmp_path):
    """tests/test_lsm_fuzz.py::test_dict_checkpoint_crash_window_keeps_ids_
    stable on the port: the key journal still leads with entries the
    snapshot already covers; replay dedups them, in the port and in the
    JAX package's recovery of the same directory."""
    d = str(tmp_path / "wal_root")
    DB = dbsetup("durdb2", dict(num_shards=1, capacity_per_shard=1024,
                                batch_cap=128, id_capacity=1 << 10,
                                wal_root=d), device="cpu")
    T = DB["t"]
    T.put_triple(np.asarray(["a", "b"], object),
                 np.asarray(["x", "y"], object), np.asarray([1.0, 2.0]))
    log = os.path.join(d, "keydict.log")
    with open(log, encoding="utf-8") as f:
        pre_ckpt_log = f.read()
    T.checkpoint()
    T.put_triple(np.asarray(["c"], object), np.asarray(["z"], object),
                 np.asarray([3.0]))
    del T, DB  # crash, then the torn-checkpoint journal shape
    with open(log, encoding="utf-8") as f:
        post = f.read()
    with open(log, "w", encoding="utf-8") as f:
        f.write(pre_ckpt_log + post + '"torn')  # and a torn last line
    want = {("a", "x", 1.0), ("b", "y", 2.0), ("c", "z", 3.0)}
    _, Tj = jax_recover_connector(d, "t")
    assert _as_str_set(Tj["a,b,c,", :]) == want
    DB2, T2 = recover_connector(d, "t", device="cpu")
    assert _as_str_set(T2["a,b,c,", :]) == want
    assert len(DB2.keydict) == 6


def test_store_config_and_connector_surface(tmp_path):
    """``StoreConfig.from_manifest`` takes the legacy ``mem_cap`` key and
    ignores per-table fields; the WAL shows in ``metrics()``; the
    deprecated ``resolve_selector`` shim warns and returns ids."""
    cfg = StoreConfig.from_manifest({"num_shards": 3, "mem_cap": 64,
                                     "combiner": "sum", "bloom_hashes": [3]})
    assert (cfg.num_shards, cfg.memtable_cap) == (3, 64)
    DB = dbsetup("dursurf", dict(CFG), wal_root=str(tmp_path), device="cpu")
    T = DB["surf"]
    T.put_triple(np.asarray(["a", "b"], object),
                 np.asarray(["x", "y"], object), np.asarray([1.0, 2.0]))
    wal = DB.metrics()["tables"]["surf"]["wal"]
    assert wal["appends"] == 1 and wal["backlog_bytes"] > 0
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ids = DB.resolve_selector("a,b,")
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    np.testing.assert_array_equal(ids, DB.keydict.encode(
        np.asarray(["a", "b"], object)))
    with pytest.raises(ValueError, match="wal_dir"):
        TorchTable("dur_nowal", device="cpu", **CFG).checkpoint()


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA "
                    "device: the hand kernels run only on the card")
def test_recovery_on_the_card_equals_the_cpu(tmp_path):
    """A pair written with the hand kernels, checkpointed midway and
    crashed, recovers on the card (the WAL suffix replays through the
    merge-path kernel, the point read runs the fence search and the row
    merge) to the same ``scan()`` and point read as on the CPU."""
    d = str(tmp_path / "gpu_rec")
    w = TorchTable("dur_gpu_w", combiner="sum", wal_dir=d, transpose=True,
                   use_pallas=True, device="cuda",
                   **dict(CFG, num_shards=4, id_capacity=1 << 12,
                          capacity_per_shard=4096, memtable_cap=64,
                          batch_cap=64))
    rng = np.random.default_rng(7)
    for i in range(40):
        r = rng.integers(0, 1 << 12, 48).astype(np.int32)
        c = rng.integers(0, 1 << 12, 48).astype(np.int32)
        w.insert(r, c, rng.normal(size=48).astype(np.float32))
        if i == 20:
            w.checkpoint()
    w._wal.close()
    card = recover(d, device="cuda")
    assert card.device.type == "cuda" and card.use_pallas
    cpu = recover(d, device="cpu")
    _same_scan(card.scan(), cpu.scan(), 1e-6, "card vs cpu")
    _same_scan(card.t_store.scan(), cpu.t_store.scan(), 1e-6, "sibling")
    q = np.unique(rng.integers(0, 1 << 12, 64)).astype(np.int32)
    _same_scan(card.query_rows(q), cpu.query_rows(q), 1e-6, "point read")
    assert card.engine_stats()["fused_dispatches"] > 0
