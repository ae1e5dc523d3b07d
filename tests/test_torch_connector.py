"""The paper's Listing-1 workflow through both packages' connectors on
identical inputs: the port's Assocs must equal the JAX package's and the
host Assoc algebra's."""
import numpy as np
import pytest

from repro.core import Assoc as JaxAssoc
from repro.data.graph500 import graph500_triples as jax_graph500
from repro.db import dbsetup as jax_dbsetup
from repro_torch.core import Assoc
from repro_torch.data.graph500 import graph500_triples
from repro_torch.db import dbinit, dbsetup, delete, put


def _triples(a):
    r, c, v = a.triples()
    r, c = np.asarray(r, dtype=str), np.asarray(c, dtype=str)
    v = np.asarray(v, dtype=np.float64)
    o = np.lexsort((c, r))
    return r[o], c[o], v[o]


def _same_assoc(a, b):
    for x, y in zip(_triples(a), _triples(b)):
        np.testing.assert_array_equal(x, y)


def test_quickstart_listing1_matches_jax(tmp_path):
    """examples/quickstart.py, in both packages (JAX with its Pallas
    kernels in interpret mode)."""
    spec = ("alice,alice,bob,carl,", "bob,carl,alice,alice,",
            [1.0, 2.0, 3.0, 4.0])
    a_t, a_j = Assoc(*spec), JaxAssoc(*spec)
    cfg = dict(num_shards=4, capacity_per_shard=4096, batch_cap=2048,
               id_capacity=1 << 16, use_pallas=True)
    dbinit()
    db_t = dbsetup("mydb02_torch", cfg, device="cpu")
    db_j = jax_dbsetup("mydb02_jax", cfg)
    pair_t = db_t["torch_Tedge", "torch_TedgeT"]
    deg_t = db_t["torch_TedgeDeg"]
    pair_j = db_j["jax_Tedge", "jax_TedgeT"]
    deg_j = db_j["jax_TedgeDeg"]
    put(pair_t, a_t)
    pair_j.put(a_j)
    for sel in [("alice,", ":"), (":", "alice,"), ("alice,:,bob,", ":"),
                (":", "al*,"), ("bob,carl,", "alice,")]:
        got = pair_t[sel]
        _same_assoc(got, pair_j[sel])
        _same_assoc(got, a_t[sel])
    # the TedgeT name is the transposed view of the same store
    _same_assoc(db_t["torch_TedgeT"]["alice,", :],
                db_j["jax_TedgeT"]["alice,", :])
    assert pair_t.nnz() == pair_j.nnz() == 4
    m = db_t.metrics()
    assert m["tables"]["torch_Tedge"]["counters"]["fused_dispatches"] > 0
    assert "transpose" in m["tables"]["torch_Tedge"]
    assert set(m["tables"]["torch_Tedge"]) == set(
        db_j.metrics()["tables"]["jax_Tedge"])
    bundle = db_t.debug_bundle(str(tmp_path / "bundle.zip"))
    import zipfile
    assert zipfile.ZipFile(bundle).namelist()
    delete(pair_t)
    delete(deg_t)
    assert db_t.ls() == []
    with pytest.raises(RuntimeError):
        pair_t.table["alice,", :]


def test_graph500_pair_reads_match_jax_and_assoc():
    """Graph500 scale 8 through a Tedge/TedgeT pair small enough to flush
    and compact: row ids, column ids, a row range and a column range."""
    r, c, v = graph500_triples(8, 16, seed=3)
    jr, jc, jv = jax_graph500(8, 16, seed=3)
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(v, jv)
    a_t, a_j = Assoc(r, c, v), JaxAssoc(jr, jc, jv)
    cfg = dict(num_shards=4, capacity_per_shard=2048, batch_cap=512,
               id_capacity=1 << 10, memtable_cap=256, char_budget=5000)
    db_t = dbsetup("g500_torch", cfg, device="cpu", use_pallas=True)
    db_j = jax_dbsetup("g500_jax", cfg)
    pt = db_t["torch_G", "torch_GT"]
    pj = db_j["jax_G", "jax_GT"]
    # intern the vertex names in sorted order first (a sorted bulk load):
    # string ranges then map to contiguous ids and compile to scans
    verts = sorted(set(a_t.row) | set(a_t.col))
    db_t.encode_keys(np.asarray(verts, dtype=object))
    db_j.encode_keys(np.asarray(verts, dtype=object))
    put(pt, a_t)
    pj.put(a_j)
    rng = np.random.default_rng(0)
    ids = ",".join(rng.choice(verts, 40, replace=False)) + ","
    rows_sel = f"{verts[10]},:,{verts[60]},"
    cols_sel = f"{verts[5]},:,{verts[90]},"
    assert db_t.resolve_selector_plan(rows_sel).kind == "range"
    sels = [(ids, ":"), (":", ids), (rows_sel, ":"), (":", cols_sel)]
    for sel in sels:
        got = pt[sel]
        _same_assoc(got, pj[sel])
        _same_assoc(got, a_t[sel])
    st = pt.table.store.engine_stats()
    st_t = pt.table.store.t_store.engine_stats()
    assert st["major_compactions"] > 0 and st_t["major_compactions"] > 0
    assert st["fused_dispatches"] > 0 and st_t["fused_dispatches"] > 0
    assert st["scan_dispatches"] > 0 and st_t["scan_dispatches"] > 0
    delete(pt)
