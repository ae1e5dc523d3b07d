"""Server-side GraphBLAS ops (``db.graphulo``) of the port against the JAX
package's on the same tables (the fixture of ``tests/test_graphulo.py``)
and against dense oracles: SpMV on both routes (the CSR kernel, or the
float64 COO product in PyTorch on the table's device), SpGEMM into a new
table, and the triangle count."""
import numpy as np
import pytest

from repro.db import dbsetup as jax_dbsetup
from repro.db import graphulo as jg
from repro_torch.core import Assoc
from repro_torch.db import dbsetup
from repro_torch.db import graphulo as tg


@pytest.fixture(scope="module")
def setup():
    cfg = dict(num_shards=2, capacity_per_shard=4096, batch_cap=2048,
               id_capacity=1 << 12)
    rng = np.random.default_rng(5)
    n, nnz = 12, 40
    rows = np.asarray([f"v{i:02d}" for i in rng.integers(0, n, nnz)], object)
    cols = np.asarray([f"v{i:02d}" for i in rng.integers(0, n, nnz)], object)
    vals = rng.integers(1, 5, nnz).astype(np.float64)
    st, sj = dbsetup("graphulo_t", cfg, device="cpu"), jax_dbsetup(
        "graphulo_j", cfg)
    t, j = st["torch_A", "torch_AT"], sj["jax_A", "jax_AT"]
    t.put_triple(rows, cols, vals)
    j.put_triple(rows, cols, vals)
    dim = len(st.keydict)
    dense = np.zeros((dim, dim))
    a = Assoc(rows, cols, vals, func="last")
    for r, c, v in zip(*a.triples()):
        dense[st.keydict.get(r), st.keydict.get(c)] = v
    return dict(st=st, sj=sj, t=t, j=j, dense=dense,
                raw=(rows, cols, vals))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_spmv_matches_jax_and_dense(setup, use_pallas):
    t, j, dense = setup["t"], setup["j"], setup["dense"]
    rng = np.random.default_rng(6)
    for x in (np.arange(dense.shape[0], dtype=np.float64),
              np.ones(dense.shape[0]),
              rng.random(dense.shape[0])):
        got = tg.table_spmv(t, x, use_pallas=use_pallas)
        want = jg.table_spmv(j, x, use_pallas=use_pallas)
        assert got.shape == want.shape and got.dtype == want.dtype
        exact = bool((x == np.round(x)).all())
        tol = dict(rtol=0, atol=0) if exact else dict(rtol=1e-5)
        np.testing.assert_allclose(got, want, **tol)
        np.testing.assert_allclose(got, (dense @ x)[:len(got)], rtol=1e-5)


@pytest.mark.parametrize("x_kind", ["one_hot_first", "one_hot_hub",
                                    "random"])
def test_spmv_kernel_route_is_csr_and_matches_jax(setup, x_kind, monkeypatch):
    """``table_spmv(use_pallas=True)`` goes through ``csr_from_coo`` +
    ``spmv_csr`` and builds no ELL; its result is the JAX
    ``table_spmv(use_pallas=True)``'s (float32, one entry per key id):
    exactly for a one-hot x, within rtol=1e-5 for a random x."""
    from repro_torch.kernels.spmv import ops as spmv_ops
    t, j, dense = setup["t"], setup["j"], setup["dense"]
    n = dense.shape[0]
    calls = []
    real = tg.spmv_csr

    def counting(*args):
        calls.append(args[0].shape[0] - 1)
        return real(*args)

    def no_ell(*args, **kw):
        raise AssertionError("the kernel route built an ELL")
    monkeypatch.setattr(tg, "spmv_csr", counting)
    monkeypatch.setattr(spmv_ops, "ell_from_coo", no_ell)
    x = np.zeros(n)
    if x_kind == "one_hot_first":
        x[0] = 1.0
    elif x_kind == "one_hot_hub":
        x[int(np.argmax((dense != 0).sum(0)))] = 1.0
    else:
        x = np.random.default_rng(8).random(n)
    got = tg.table_spmv(t, x, use_pallas=True)
    want = jg.table_spmv(j, x, use_pallas=True)
    assert calls == [n]
    assert got.dtype == np.float32 and got.shape == want.shape == (n,)
    if x_kind == "random":
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, (dense @ x).astype(np.float32))


def test_spgemm_matches_jax_and_lands_in_table(setup):
    st, sj, t, j, dense = (setup[k] for k in ("st", "sj", "t", "j", "dense"))
    for got, want in zip(tg.table_spgemm(t, t, st), jg.table_spgemm(j, j, sj)):
        np.testing.assert_array_equal(got, want)
    out = tg.table_spgemm(t, t, st, out_name="torch_A2")
    d2 = dense @ dense
    got = np.zeros_like(d2)
    for rr, cc, vv in zip(*out[:, :].triples()):
        got[st.keydict.get(rr), st.keydict.get(cc)] = vv
    np.testing.assert_allclose(got, d2)
    want = jg.table_spgemm(j, j, sj, out_name="jax_A2")[:, :]
    for x, y in zip(out[:, :].triples(), want.triples()):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_triangle_count_matches_jax_and_oracle(setup):
    a = ((setup["dense"] + setup["dense"].T) > 0).astype(np.float64)
    np.fill_diagonal(a, 0.0)
    want = int(round(np.trace(a @ a @ a) / 6.0))
    assert tg.table_tricount(setup["t"], setup["st"]) == want
    assert jg.table_tricount(setup["j"], setup["sj"]) == want


@pytest.mark.gpu
def test_spmv_routes_stay_on_card(setup):
    """On a table on the card both routes compute there: the kernel route
    launches the CSR kernel once, the PyTorch route launches no hand kernel,
    and both agree with the JAX host product."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dict(num_shards=2, capacity_per_shard=4096, batch_cap=2048,
               id_capacity=1 << 12)
    sc = dbsetup("graphulo_c", cfg, device="cuda")
    c = sc["cuda_A", "cuda_AT"]
    c.put_triple(*setup["raw"])
    x = np.random.default_rng(7).random(len(sc.keydict))
    want = jg.table_spmv(setup["j"], x)
    for use_pallas, launched in ((True, 1), (False, 0)):
        reset_launches()
        got = tg.table_spmv(c, x, use_pallas=use_pallas)
        assert LAUNCHES["spmv_csr"] == launched
        np.testing.assert_allclose(got[:len(want)], want, rtol=1e-5)
