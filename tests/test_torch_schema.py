"""The D4M 2.0 schema (``EdgeSchema``: Tedge / TedgeT / TedgeDeg) and the
paper's Fig. 4 query path of the port against the JAX package on the same
Graph500 triples: degrees equal bit for bit, degree-bucketed vertex
selection gives the same names, and the SV/MV row and column reads equal
the JAX ones, the host Assoc algebra's and a ``NaiveTable``'s."""
import numpy as np
import pytest
import torch

from repro.core import Assoc as JaxAssoc
from repro.db import dbsetup as jax_dbsetup
from repro.db import kvstore as jkv
from repro.db.schema import EdgeSchema as JaxEdgeSchema
from repro_torch.core import Assoc
from repro_torch.data.graph500 import graph500_triples
from repro_torch.db import EdgeSchema, NaiveTable, dbsetup
from repro_torch.db import kvstore as tkv

CFG = dict(num_shards=2, capacity_per_shard=1 << 12, batch_cap=1 << 11,
           id_capacity=1 << 11, memtable_cap=1 << 11)


def _triples(a):
    r, c, v = (np.asarray(x) for x in a.triples())
    o = np.lexsort((c.astype(str), r.astype(str)))
    return r[o].astype(str), c[o].astype(str), v[o].astype(np.float64)


def _same(a, b, what):
    for x, y, part in zip(_triples(a), _triples(b), ("rows", "cols", "vals")):
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {part}")


@pytest.fixture(scope="module", params=[True, False],
                ids=["use_pallas", "plain"])
def schemas(request):
    """The same triples (duplicates included) through both packages'
    ``EdgeSchema`` and a ``NaiveTable``."""
    use_pallas = request.param
    rows, cols, vals = graph500_triples(scale=7, edges_per_vertex=6, seed=2)
    tag = "p" if use_pallas else "o"
    db_t = dbsetup(f"schema_t_{tag}", dict(CFG, use_pallas=use_pallas),
                   device="cpu")
    db_j = jax_dbsetup(f"schema_j_{tag}", CFG)
    g_t = EdgeSchema(db_t, f"torch_g_{tag}")
    g_j = JaxEdgeSchema(db_j, f"jax_g_{tag}")
    naive = NaiveTable(f"naive_{tag}")
    half = len(rows) // 2  # two puts: the degrees accumulate
    for sl in (slice(0, half), slice(half, None)):
        for g in (g_t, g_j, naive):
            g.put_triple(rows[sl], cols[sl], vals[sl])
    return dict(t=g_t, j=g_j, naive=naive, db_t=db_t, rows=rows, cols=cols,
                vals=vals)


def test_degrees_equal_jax_bit_for_bit(schemas):
    g_t, g_j = schemas["t"], schemas["j"]
    for k in ("out_deg", "in_deg"):
        got = getattr(g_t.deg, k)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(getattr(g_j.deg, k))
                                      .view(np.uint32), err_msg=k)
    # every triple counts, duplicates included (the bincount oracle)
    kd = schemas["db_t"].keydict
    n = len(kd)
    for k, keys in (("out_deg", schemas["rows"]), ("in_deg", schemas["cols"])):
        want = np.bincount(kd.lookup(keys), minlength=n).astype(np.float32)
        np.testing.assert_array_equal(getattr(g_t.deg, k).numpy()[:n], want)
    _same(g_t.deg.degrees(":"), g_j.deg.degrees(":"), "degrees")
    sel = ",".join(schemas["rows"][:4]) + ","
    _same(g_t.deg.degrees(sel), g_j.deg.degrees(sel), "degrees of some")


@pytest.mark.parametrize("kind", ["out", "in"])
def test_vertices_with_degree_same_names(schemas, kind):
    g_t, g_j = schemas["t"], schemas["j"]
    for target in (1, 3, 10, 30, 100):
        for tol in (10 ** 0.5, 1.001):
            got = g_t.deg.vertices_with_degree(target, kind, tol=tol)
            want = g_j.deg.vertices_with_degree(target, kind, tol=tol)
            np.testing.assert_array_equal(got.astype(str), want.astype(str))


def test_fig4_reads_match_jax_assoc_and_naive(schemas):
    """``benchmarks/query_bench.py::fig4``'s selection: for degree targets
    {1, 10, 100} x {out (row read), in (column read)}, one vertex (SV) and
    five (MV), seeded. The edge table keeps the last write of a repeated
    edge, so it equals the last-wins Assoc; the NaiveTable keeps every
    raw triple, so it equals the summed Assoc and has the same pattern."""
    g_t, g_j, naive = schemas["t"], schemas["j"], schemas["naive"]
    rows, cols, vals = schemas["rows"], schemas["cols"], schemas["vals"]
    last = Assoc(rows, cols, vals, func="last")
    summed = Assoc(rows, cols, vals)
    rng = np.random.default_rng(0)
    n_reads = 0
    for target in (1, 10, 100):
        for kind, axis in (("out", "row"), ("in", "col")):
            vs = g_t.deg.vertices_with_degree(target, kind=kind)
            if len(vs) == 0:
                continue
            single = str(rng.choice(vs)) + ","
            multi = "".join(str(v) + "," for v in rng.choice(
                vs, size=min(5, len(vs)), replace=False))
            for q in (single, multi):
                key = (q, ":") if axis == "row" else (":", q)
                got = g_t[key]
                assert got.nnz() > 0, key
                _same(got, g_j[key], f"jax {key}")
                _same(got, last[key], f"last-wins Assoc {key}")
                nv = naive[key]
                _same(nv, summed[key], f"naive {key}")
                np.testing.assert_array_equal(_triples(nv)[0],
                                              _triples(got)[0])
                np.testing.assert_array_equal(_triples(nv)[1],
                                              _triples(got)[1])
                n_reads += 1
    assert n_reads >= 8


def test_degree_update_matches_jax():
    """``degree_update`` on both routes, ids < 0 and past the row dropped,
    against the JAX function on both routes (its kernel in interpret
    mode)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    deg0 = rng.integers(0, 50, 1024).astype(np.float32)
    ids = rng.integers(-2, 1100, 5000).astype(np.int32)
    w = np.ones(5000, np.float32)
    want = np.asarray(jkv.degree_update(jnp.asarray(deg0), jnp.asarray(ids),
                                        jnp.asarray(w), use_pallas=True))
    np.testing.assert_array_equal(want, np.asarray(jkv.degree_update(
        jnp.asarray(deg0), jnp.asarray(ids), jnp.asarray(w),
        use_pallas=False)))
    for use_pallas in (True, False):
        got = tkv.degree_update(torch.from_numpy(deg0), torch.from_numpy(ids),
                                torch.from_numpy(w), use_pallas=use_pallas)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_degree_state_carried_across_packages(schemas, direction):
    import jax.numpy as jnp
    from repro.db.schema import DegreeTable as JaxDegreeTable
    from repro_torch.db import DegreeTable
    db_t = dbsetup(f"deg_carry_t_{direction}", CFG, device="cpu")
    db_j = jax_dbsetup(f"deg_carry_j_{direction}", CFG)
    if direction == "jax_to_port":
        src, dst = schemas["j"].deg, DegreeTable(db_t, "torch_deg_dst")
        dst.load_state({k: np.asarray(getattr(src, k))
                        for k in ("out_deg", "in_deg")})
        got = dst.state_arrays()
    else:
        src, dst = schemas["t"].deg, JaxDegreeTable(db_j, "jax_deg_dst")
        for k, v in src.state_arrays().items():
            setattr(dst, k, jnp.asarray(v))
        got = {k: np.asarray(getattr(dst, k)) for k in ("out_deg", "in_deg")}
    for k in ("out_deg", "in_deg"):
        want = np.asarray(getattr(src, k) if direction == "jax_to_port"
                          else getattr(src, k).numpy())
        np.testing.assert_array_equal(got[k], want)
    with pytest.raises(ValueError, match="out_deg"):
        DegreeTable(db_t, "torch_deg_bad").load_state(
            {"out_deg": np.zeros(5, np.float32)})


def test_delete_drops_all_three_tables():
    db = dbsetup("schema_delete", CFG, device="cpu")
    g = EdgeSchema(db, "gone")
    g.put_triple(np.asarray(["a", "b"], object), np.asarray(["b", "c"], object),
                 np.ones(2))
    assert db.ls() == ["gone_Tedge", "gone_TedgeDeg", "gone_TedgeT"]
    assert g.nnz() == 2
    store = g.pair.table.store
    g.delete()
    assert db.ls() == []
    assert store._closed and store.t_store._closed
    with pytest.raises(RuntimeError, match="deleted"):
        g["a,", :]
