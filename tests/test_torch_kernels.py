"""The port's kernel wrappers against the JAX package's ops (Pallas in
interpret mode) and refs, on identical numpy inputs. Keys, ranks and counts
must be exactly equal; merged values are compared on the valid prefix (pad
values are undefined in both packages)."""
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jmr = import_module("repro.kernels.merge_rank.ops")
jmr_ref = import_module("repro.kernels.merge_rank.ref")
jss = import_module("repro.kernels.sorted_search.ops")
jss_ref = import_module("repro.kernels.sorted_search.ref")
jsr = import_module("repro.kernels.segment_reduce.ops")
jsr_ref = import_module("repro.kernels.segment_reduce.ref")
jsp = import_module("repro.kernels.spmv.ops")
jsp_ref = import_module("repro.kernels.spmv.ref")
jsg = import_module("repro.core.sparsegemm")
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels import merge_rank as tmr
from repro_torch.kernels import segment_reduce as tsr
from repro_torch.kernels import sorted_search as tss
from repro_torch.kernels import spmv as tsp
from repro_torch.kernels.common import I32_MAX

T = torch.from_numpy


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------- rank search
def _tabs(rng, n_k, n, hi=500):
    tabs = np.full((n_k, n), I32_MAX, np.int32)
    for k in range(n_k):
        m = int(rng.integers(0, n + 1))
        tabs[k, :m] = np.sort(rng.integers(0, hi, m))
    return tabs


@pytest.mark.parametrize("n_tab", [1, 5, 300, 2048])
@pytest.mark.parametrize("n_q", [1, 7, 257])
def test_sorted_search_batched_matches_jax(n_tab, n_q):
    rng = np.random.default_rng(n_tab * 1000 + n_q)
    tabs = _tabs(rng, 3, n_tab)
    q = rng.integers(-5, 510, n_q).astype(np.int32)
    for side in ("left", "right"):
        got = tss.sorted_search_batched(T(tabs), T(q), side).numpy()
        want = _np(jss.sorted_search_batched(jnp.asarray(tabs), jnp.asarray(q),
                                             side, block_q=64, block_t=256))
        ref = _np(jss_ref.sorted_search_batched_ref(jnp.asarray(tabs),
                                                jnp.asarray(q), side))
        np.testing.assert_array_equal(got, want, err_msg=side)
        np.testing.assert_array_equal(got, ref, err_msg=side)
        assert got.dtype == np.int32


@pytest.mark.parametrize("seed", range(6))
def test_batched_rank_search_random_runs(seed):
    """Ragged stacked runs (the fused read's L0 stack), both sides, the
    port's plain version against the JAX ref."""
    rng = np.random.default_rng(seed)
    tabs = _tabs(rng, int(rng.integers(1, 5)), 128)
    q = rng.integers(0, 500, int(rng.integers(1, 41))).astype(np.int32)
    for side in ("left", "right"):
        got = tss.sorted_search_batched(T(tabs), T(q), side).numpy()
        ref = _np(jss_ref.sorted_search_batched_ref(tabs, q, side))
        np.testing.assert_array_equal(got, ref, err_msg=side)


def test_sorted_search_endpoints_matches_jax():
    rng = np.random.default_rng(3)
    tabs = _tabs(rng, 4, 64)
    for lo, hi in [(0, 1), (17, 300), (499, 500), (-1, I32_MAX)]:
        lohi = np.asarray([lo, hi], np.int32)
        got = tss.sorted_search_endpoints(T(tabs), T(lohi))
        want = jss.sorted_search_endpoints(jnp.asarray(tabs),
                                           jnp.asarray(lohi), block_q=64,
                                           block_t=64)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), _np(w))


def test_rank_all_pad_rows_and_pad_queries():
    tabs = np.full((2, 16), I32_MAX, np.int32)
    q = np.asarray([-1, 0, 5, I32_MAX - 1], np.int32)
    for side in ("left", "right"):
        got = tss.sorted_search_batched(T(tabs), T(q), side).numpy()
        np.testing.assert_array_equal(
            got, _np(jss_ref.sorted_search_batched_ref(tabs, q, side)))
        assert (got == 0).all()


def test_rank_ref_is_the_compare_count():
    """The plain version counts compares, so it equals searchsorted on
    sorted rows; on unsorted rows it still counts."""
    rng = np.random.default_rng(9)
    tabs = rng.integers(0, 50, (3, 40)).astype(np.int32)
    q = rng.integers(0, 50, 30).astype(np.int32)
    got = tss.rank_batched_ref(T(tabs), T(q), strict=True).numpy()
    np.testing.assert_array_equal(
        got, (tabs[:, None, :] < q[None, :, None]).sum(-1))


# ------------------------------------------------------------------ merges
def _rand_run(n, n_valid, seed):
    r = np.random.default_rng(seed)
    rows = np.sort(r.integers(0, 40, n_valid)).astype(np.int32)
    cols = r.integers(0, 40, n_valid).astype(np.int32)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = r.normal(size=n_valid).astype(np.float32)
    pr = np.full(n, I32_MAX, np.int32)
    pr[:n_valid] = rows
    pc = np.full(n, I32_MAX, np.int32)
    pc[:n_valid] = cols
    pv = np.zeros(n, np.float32)
    pv[:n_valid] = vals
    return pr, pc, pv


def _check_merged(got, want, n):
    """Keys exactly equal on the valid prefix, pad keys I32_MAX, values on
    the valid prefix."""
    gr, gc, gv = (np.asarray(x) for x in got)
    wr, wc, wv = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gr[..., :n], wr[..., :n])
    np.testing.assert_array_equal(gc[..., :n], wc[..., :n])
    np.testing.assert_array_equal(gv[..., :n], wv[..., :n])
    assert np.all(gr[..., n:] == I32_MAX) and np.all(gc[..., n:] == I32_MAX)


@pytest.mark.parametrize("na,va,nb,vb", [
    (8, 8, 8, 8), (64, 50, 32, 17), (300, 123, 300, 300), (512, 0, 64, 33),
])
def test_merge_sorted_matches_jax(na, va, nb, vb):
    a = _rand_run(na, va, 1)
    b = _rand_run(nb, vb, 2)
    got = tmr.merge_sorted(*(T(x) for x in a + b))
    want = jmr.merge_sorted(*(jnp.asarray(x) for x in a + b), block_q=64,
                            block_t=64)
    ref = jmr_ref.merge_sorted_ref(*(jnp.asarray(x) for x in a + b))
    _check_merged([x.numpy() for x in got], want, va + vb)
    _check_merged([x.numpy() for x in got], ref, va + vb)


def test_merge_sorted_sharded_equals_per_shard():
    """The [S, n] form (one launch per direction for all shards) equals
    merging each shard alone."""
    runs_a = [_rand_run(40, v, 10 + i) for i, v in enumerate((40, 3, 0))]
    runs_b = [_rand_run(24, v, 20 + i) for i, v in enumerate((24, 24, 5))]
    stack = [T(np.stack([r[j] for r in runs])) for runs in (runs_a, runs_b)
             for j in range(3)]
    got = tmr.merge_sorted(*stack)
    for s, (a, b) in enumerate(zip(runs_a, runs_b)):
        one = tmr.merge_sorted(*(T(x) for x in a + b))
        n = int((a[0] != I32_MAX).sum() + (b[0] != I32_MAX).sum())
        _check_merged([x[s].numpy() for x in got], [x.numpy() for x in one],
                      n)


def test_merge_tie_order_a_before_b():
    """Equal keys: A-side (old) entries precede B-side (new) → last wins."""
    a = (np.asarray([3], np.int32), np.asarray([4], np.int32),
         np.asarray([1.0], np.float32))
    b = (np.asarray([3], np.int32), np.asarray([4], np.int32),
         np.asarray([2.0], np.float32))
    _, _, v = tmr.merge_sorted(*(T(x) for x in a + b))
    np.testing.assert_array_equal(v.numpy()[:2], [1.0, 2.0])
    _, _, v = tmr.merge_sorted_ref(*(T(x) for x in a + b))
    np.testing.assert_array_equal(v.numpy()[:2], [1.0, 2.0])


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("n_runs", [1, 3, 6])
def test_kway_merge_matches_jax(n_runs, use_pallas):
    runs = [_rand_run(32, int(v), 40 + i) for i, v in
            enumerate(np.random.default_rng(n_runs).integers(0, 33, n_runs))]
    n = sum(int((r[0] != I32_MAX).sum()) for r in runs)
    got = tmr.kway_merge([tuple(T(x) for x in r) for r in runs],
                         use_pallas=use_pallas)
    want = jmr.kway_merge([tuple(jnp.asarray(x) for x in r) for r in runs],
                          use_pallas=use_pallas)
    _check_merged([x.numpy() for x in got], want, n)


def _segment_rows(rng, n_q, n_seg, seg_w):
    """Rows of concatenated sorted segments with keys unique per row (the
    fused read's packed (col, age) keys), pads I32_MAX."""
    keys = np.full((n_q, n_seg * seg_w), I32_MAX, np.int32)
    for i in range(n_q):
        pool = rng.permutation(10_000)[:n_seg * seg_w]
        for s in range(n_seg):
            m = int(rng.integers(0, seg_w + 1))
            keys[i, s * seg_w:s * seg_w + m] = np.sort(
                pool[s * seg_w:s * seg_w + m])
    vals = rng.normal(size=keys.shape).astype(np.float32)
    return keys, vals


@pytest.mark.parametrize("n_q,n_seg,seg_w", [(1, 1, 4), (9, 5, 4),
                                             (33, 3, 16), (4, 7, 32)])
def test_merge_combine_rows_matches_jax(n_q, n_seg, seg_w):
    rng = np.random.default_rng(n_q * 100 + n_seg)
    keys, vals = _segment_rows(rng, n_q, n_seg, seg_w)
    keys[0] = I32_MAX  # an all-pad row
    for use_pallas in (False, True):
        gk, gv = tmr.merge_combine_rows(T(keys), T(vals),
                                        use_pallas=use_pallas)
        wk, wv = jmr.merge_combine_rows(jnp.asarray(keys), jnp.asarray(vals),
                                        use_pallas=use_pallas)
        np.testing.assert_array_equal(gk.numpy(), _np(wk))
        np.testing.assert_array_equal(gv.numpy(), _np(wv))
    rk, rv = tmr.merge_combine_rows_ref(T(keys), T(vals))
    np.testing.assert_array_equal(rk.numpy(), gk.numpy())
    valid = gk.numpy() != I32_MAX
    np.testing.assert_array_equal(rv.numpy()[valid], gv.numpy()[valid])
    rank = tmr.row_rank(T(keys)).numpy()
    from repro.kernels.merge_rank.kernel import row_rank_pallas
    kp = np.pad(keys, ((0, -n_q % 8), (0, -keys.shape[1] % 128)),
                constant_values=I32_MAX)
    want = _np(row_rank_pallas(jnp.asarray(kp), interpret=True))
    np.testing.assert_array_equal(rank, want[:n_q, :keys.shape[1]])


# ------------------------------------------------- 1-D rank search (#4)
@pytest.mark.parametrize("n_tab", [1, 5, 300, 2048])
@pytest.mark.parametrize("n_q", [1, 7, 257])
def test_sorted_search_matches_jax(n_tab, n_q):
    """One tablet (valid prefix + I32_MAX pads) against the JAX wrapper
    (Pallas in interpret mode) and the JAX ref, both sides."""
    rng = np.random.default_rng(n_tab * 7 + n_q)
    tab = _tabs(rng, 1, n_tab)[0]
    n_valid = int((tab != I32_MAX).sum())
    q = rng.integers(-5, 510, n_q).astype(np.int32)
    for side in ("left", "right"):
        got = tss.sorted_search(T(tab), T(q), side).numpy()
        want = _np(jss.sorted_search(jnp.asarray(tab), jnp.asarray(q), side,
                                     block_q=64, block_t=256))
        ref = _np(jss_ref.sorted_search_ref(jnp.asarray(tab), n_valid,
                                            jnp.asarray(q), side))
        np.testing.assert_array_equal(got, want, err_msg=side)
        np.testing.assert_array_equal(got, ref, err_msg=side)
        np.testing.assert_array_equal(
            torch.searchsorted(T(tab[:n_valid]), T(q), right=(side == "right"),
                               out_int32=True).numpy(), ref)
        assert got.dtype == np.int32


def test_rank_pallas_kernel_matches_plain():
    from repro.kernels.sorted_search.kernel import rank_pallas
    rng = np.random.default_rng(11)
    tab = _tabs(rng, 1, 256)[0]
    q = rng.integers(0, 500, 64).astype(np.int32)
    for strict in (True, False):
        want = _np(rank_pallas(jnp.asarray(tab).reshape(1, -1),
                               jnp.asarray(q).reshape(-1, 1), strict=strict,
                               block_q=64, block_t=128, interpret=True))[:, 0]
        np.testing.assert_array_equal(tss.rank(T(tab), T(q), strict).numpy(),
                                      want)
        np.testing.assert_array_equal(
            tss.rank_ref(T(tab), T(q), strict).numpy(), want)


# ------------------------------------------------------- segment sum (#5)
@pytest.mark.parametrize("n,n_seg", [(1, 1), (100, 7), (1500, 512),
                                     (3000, 2048)])
def test_segment_sum_matches_jax(n, n_seg):
    """Ids < 0 and >= n_segments are dropped (the JAX wrapper pads the
    segments to its block and slices the pad off); integer-valued sums are
    exact."""
    rng = np.random.default_rng(n + n_seg)
    ids = rng.integers(-3, n_seg + 600, n).astype(np.int32)
    vals = rng.integers(-4, 9, n).astype(np.float32)
    got = tsr.segment_sum(T(ids), T(vals), n_seg).numpy()
    want = _np(jsr.segment_sum(jnp.asarray(ids), jnp.asarray(vals), n_seg,
                               block_n=256, block_s=256))
    ref = _np(jsr_ref.segment_sum_ref(jnp.asarray(ids), jnp.asarray(vals),
                                      n_seg))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.float32 and got.shape == (n_seg,)


def test_segment_sum_pallas_kernel_matches_plain():
    from repro.kernels.segment_reduce.kernel import segment_sum_pallas
    rng = np.random.default_rng(12)
    ids = rng.integers(-1, 256, 512).astype(np.int32)
    vals = rng.integers(0, 5, 512).astype(np.float32)
    want = _np(segment_sum_pallas(jnp.asarray(ids).reshape(-1, 1),
                                  jnp.asarray(vals).reshape(-1, 1),
                                  n_segments=256, block_n=128, block_s=128,
                                  interpret=True))[0]
    np.testing.assert_array_equal(
        tsr.segment_sum_ref(T(ids), T(vals), 256).numpy(), want)


# ------------------------------------------------------------ ELL SpMV (#6)
def _ell(rng, n_r, k, n_c, out_of_range=0):
    cols = rng.integers(0, n_c, (n_r, k)).astype(np.int32)
    fill = rng.integers(0, k + 1, (n_r, 1))
    cols = np.where(np.arange(k) < fill, cols, -1)  # ragged rows, pad -1
    if out_of_range:
        hit = rng.random((n_r, k)) < out_of_range
        cols = np.where(hit & (cols >= 0), n_c + rng.integers(0, 3000,
                                                              (n_r, k)), cols)
    vals = rng.integers(-3, 6, (n_r, k)).astype(np.float32)
    return cols.astype(np.int32), vals


@pytest.mark.parametrize("n_r,k,n_c", [(1, 1, 1), (7, 5, 300), (300, 17, 2500),
                                       (64, 64, 4096)])
def test_spmv_ell_matches_jax(n_r, k, n_c):
    """Integer-valued inputs are exact; random floats within rtol=1e-5."""
    rng = np.random.default_rng(n_r * 31 + k)
    cols, vals = _ell(rng, n_r, k, n_c)
    for x in (rng.integers(-2, 5, n_c).astype(np.float32),
              rng.random(n_c).astype(np.float32)):
        got = tsp.spmv_ell(T(cols), T(vals), T(x)).numpy()
        want = _np(jsp.spmv_ell(jnp.asarray(cols), jnp.asarray(vals),
                                jnp.asarray(x), block_r=64, block_c=512))
        ref = _np(jsp_ref.spmv_ell_ref(jnp.asarray(cols), jnp.asarray(vals),
                                       jnp.asarray(x)))
        exact = bool((x == np.round(x)).all())
        tol = dict(rtol=0, atol=0) if exact else dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, want, **tol)
        np.testing.assert_allclose(got, ref, **tol)
        assert got.dtype == np.float32 and got.shape == (n_r,)


def test_spmv_ell_out_of_range_columns_follow_the_jax_wrapper():
    """A column >= len(x) adds 0, as in the JAX wrapper ``spmv_ell`` (its
    kernel masks columns past the zero-padded x); the JAX ``spmv_ell_ref``
    clips such a column to x[-1] instead."""
    rng = np.random.default_rng(13)
    cols, vals = _ell(rng, 40, 9, 700, out_of_range=0.3)
    x = rng.integers(1, 5, 700).astype(np.float32)
    got = tsp.spmv_ell(T(cols), T(vals), T(x)).numpy()
    want = _np(jsp.spmv_ell(jnp.asarray(cols), jnp.asarray(vals),
                            jnp.asarray(x), block_r=64, block_c=512))
    np.testing.assert_array_equal(got, want)
    clipped = _np(jsp_ref.spmv_ell_ref(jnp.asarray(cols), jnp.asarray(vals),
                                       jnp.asarray(x)))
    assert not np.array_equal(got, clipped)  # the divergence is real
    in_range = np.where(cols < 700, cols, -1).astype(np.int32)
    np.testing.assert_array_equal(got, _np(jsp_ref.spmv_ell_ref(
        jnp.asarray(in_range), jnp.asarray(vals), jnp.asarray(x))))


def test_ell_from_coo_matches_jax():
    rng = np.random.default_rng(14)
    r = np.sort(rng.integers(0, 30, 200))
    c = rng.integers(0, 50, 200)
    v = rng.random(200)
    for got, want in zip(tsp.ell_from_coo(r, c, v, 33),
                         jsp.ell_from_coo(r, c, v, 33)):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ CSR SpMV (#6)
def _coo(rng, n_rows, n_c, hub=0, dup=False, out_of_range=0.0):
    """Row-sorted COO with power-law-ish degrees, empty rows (about a third,
    and the last rows), an optional hub row of ``hub`` entries, repeated
    columns within a row and columns < 0 or >= n_c."""
    deg = rng.integers(0, 9, n_rows) * (rng.random(n_rows) < 0.65)
    deg[-3:] = 0
    if hub:
        deg[n_rows // 3] = hub
    r = np.repeat(np.arange(n_rows), deg)
    c = rng.integers(0, n_c, len(r))
    if dup:  # every 3rd entry repeats the column before it
        c[2::3] = c[1::3][:len(c[2::3])]
    if out_of_range:
        hit = rng.random(len(c)) < out_of_range
        c = np.where(hit, np.where(rng.random(len(c)) < 0.5,
                                   -rng.integers(1, 50, len(c)),
                                   n_c + rng.integers(0, 50, len(c))), c)
    v = rng.integers(-3, 6, len(r)).astype(np.float64)
    return r, c, v


_CSR_CASES = {  # n_rows, n_c, hub entries, duplicate cols, out-of-range share
    "small": (7, 30, 0, False, 0.0),
    "empty_rows": (200, 500, 0, False, 0.0),
    "hub": (300, 4000, 3000, False, 0.0),  # longer than a block's 1,024
    "duplicates": (120, 40, 0, True, 0.0),
    "out_of_range": (150, 300, 0, False, 0.2),
    "all": (400, 2500, 2100, True, 0.1),
}


@pytest.mark.parametrize("case", sorted(_CSR_CASES))
def test_spmv_csr_matches_jax(case):
    """``csr_from_coo`` + ``spmv_csr`` against the JAX ``spmv_ell`` over
    ``ell_from_coo`` of the same COO (both drop columns < 0 or >= len(x)),
    and against the JAX host product over the in-range entries: exact for
    integer-valued x, within rtol=1e-5 for random x."""
    n_rows, n_c, hub, dup, oor = _CSR_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    r, c, v = _coo(rng, n_rows, n_c, hub, dup, oor)
    indptr, cols, vals = tsp.csr_from_coo(r, c, v, n_rows)
    assert indptr.dtype == cols.dtype == np.int32 and vals.dtype == np.float32
    assert indptr[0] == 0 and indptr[-1] == len(r)
    np.testing.assert_array_equal(np.diff(indptr),
                                  np.bincount(r, minlength=n_rows))
    e_cols, e_vals = jsp.ell_from_coo(r, c, v, n_rows)
    ok = (c >= 0) & (c < n_c)
    for x in (rng.integers(-2, 5, n_c).astype(np.float32),
              rng.random(n_c).astype(np.float32)):
        got = tsp.spmv_csr(T(indptr), T(cols), T(vals), T(x)).numpy()
        want = _np(jsp.spmv_ell(jnp.asarray(e_cols), jnp.asarray(e_vals),
                                jnp.asarray(x), block_r=64, block_c=512))
        host = jsg.spmv((r[ok], c[ok], v[ok]), x.astype(np.float64))
        exact = bool((x == np.round(x)).all())
        tol = dict(rtol=0, atol=0) if exact else dict(rtol=1e-5, atol=1e-6)
        assert got.dtype == np.float32 and got.shape == (n_rows,)
        np.testing.assert_allclose(got, want, **tol)
        np.testing.assert_allclose(got[:len(host)], host, **tol)
        assert not got[len(host):].any()


def test_csr_from_coo_refuses_unsorted_or_out_of_range_rows():
    with pytest.raises(ValueError):
        tsp.csr_from_coo(np.array([1, 0]), np.array([0, 0]), np.ones(2), 3)
    with pytest.raises(ValueError):
        tsp.csr_from_coo(np.array([0, 3]), np.array([0, 0]), np.ones(2), 3)
    indptr, cols, vals = tsp.csr_from_coo(np.zeros(0, np.int64),
                                          np.zeros(0, np.int64),
                                          np.zeros(0), 4)
    np.testing.assert_array_equal(indptr, np.zeros(5, np.int32))
    got = tsp.spmv_csr(T(indptr), T(cols), T(vals), torch.ones(3))
    np.testing.assert_array_equal(got.numpy(), np.zeros(4, np.float32))


def test_pair_rank_ref_matches_pallas_kernel():
    from repro.kernels.merge_rank.kernel import pair_rank_pallas
    a = _rand_run(64, 50, 5)
    b = _rand_run(128, 77, 6)
    for strict in (True, False):
        got = tmr.pair_rank(T(b[0])[None], T(b[1])[None], T(a[0])[None],
                            T(a[1])[None], strict).numpy()[0]
        want = _np(pair_rank_pallas(
            jnp.asarray(b[0]).reshape(1, -1), jnp.asarray(b[1]).reshape(1, -1),
            jnp.asarray(a[0]).reshape(-1, 1), jnp.asarray(a[1]).reshape(-1, 1),
            strict=strict, block_q=64, block_t=128, interpret=True))[:, 0]
        np.testing.assert_array_equal(got, want)


def test_cpu_tensors_never_launch():
    reset_launches()
    tss.sorted_search_batched(T(np.zeros((1, 4), np.int32)),
                              T(np.zeros(3, np.int32)))
    tmr.row_rank(T(np.zeros((2, 3), np.int32)))
    tss.sorted_search(T(np.zeros(4, np.int32)), T(np.zeros(3, np.int32)))
    tsr.segment_sum(T(np.zeros(3, np.int32)), T(np.ones(3, np.float32)), 2)
    tsp.spmv_ell(T(np.zeros((2, 3), np.int32)), T(np.ones((2, 3), np.float32)),
                 T(np.ones(4, np.float32)))
    tsp.spmv_csr(T(np.array([0, 1, 3], np.int32)), T(np.zeros(3, np.int32)),
                 T(np.ones(3, np.float32)), T(np.ones(4, np.float32)))
    assert LAUNCHES == {"rank_batched": 0, "pair_rank": 0, "row_rank": 0,
                        "rank": 0, "segment_sum": 0, "spmv_ell": 0,
                        "spmv_csr": 0, "flash_attention": 0}


@pytest.mark.gpu
def test_kernels_on_card_match_plain_versions():
    """On the card each wrapper launches its CUDA kernel; ranks must equal
    the plain versions exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    tabs = _tabs(rng, 4, 1000)
    q = rng.integers(-5, 510, 700).astype(np.int32)
    for strict in (True, False):
        got = tss.rank_batched(T(tabs).cuda(), T(q).cuda(), strict).cpu()
        assert torch.equal(got, tss.rank_batched_ref(T(tabs), T(q), strict))
    a, b = _rand_run(3000, 2500, 1), _rand_run(500, 400, 2)
    for strict in (True, False):
        args = [T(x)[None] for x in (a[0], a[1], b[0], b[1])]
        got = tmr.pair_rank(*(x.cuda() for x in args), strict).cpu()
        assert torch.equal(got, tmr.pair_rank_ref(*args, strict))
    keys, _ = _segment_rows(rng, 64, 7, 32)
    got = tmr.row_rank(T(keys).cuda()).cpu()
    assert torch.equal(got, tmr.row_rank_ref(T(keys)))


@pytest.mark.gpu
def test_new_kernels_on_card_match_plain_versions():
    """The 1-D rank, segment-sum and ELL SpMV kernels on the card: ranks
    and integer-valued sums exactly equal to the plain versions, float
    SpMV within rtol=1e-5 (float atomics and the warp reduction add in
    another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(1)
    tab = _tabs(rng, 1, 5000)[0]
    q = rng.integers(-5, 510, 3000).astype(np.int32)
    for strict in (True, False):
        got = tss.rank(T(tab).cuda(), T(q).cuda(), strict).cpu()
        assert torch.equal(got, tss.rank_ref(T(tab), T(q), strict))
    ids = rng.integers(-3, 3000, 200_000).astype(np.int32)
    ids[:5000] = 7  # a hub: thousands of atomics on one address
    vals = rng.integers(0, 4, 200_000).astype(np.float32)
    got = tsr.segment_sum(T(ids).cuda(), T(vals).cuda(), 2048).cpu()
    assert torch.equal(got, tsr.segment_sum_ref(T(ids), T(vals), 2048))
    cols, vals = _ell(rng, 1000, 300, 5000, out_of_range=0.05)
    for x in (rng.integers(-2, 5, 5000).astype(np.float32),
              rng.random(5000).astype(np.float32)):
        got = tsp.spmv_ell(T(cols).cuda(), T(vals).cuda(), T(x).cuda()).cpu()
        want = tsp.spmv_ell_ref(T(cols), T(vals), T(x))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_spmv_csr_on_card_matches_plain_version():
    """The CSR kernel on the card against its plain version: a hub of 6,000
    entries (a row across six blocks' runs), empty rows, duplicate and
    out-of-range columns; integer-valued x exactly, random x within
    rtol=1e-5 (the segmented scan adds in another order), and the same
    result on a second run (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(2)
    for n_rows, n_c, hub in ((5000, 20000, 6000), (3, 10, 0), (2000, 500, 1500)):
        r, c, v = _coo(rng, n_rows, n_c, hub, dup=True, out_of_range=0.05)
        csr = [T(a) for a in tsp.csr_from_coo(r, c, v, n_rows)]
        for x in (rng.integers(-2, 5, n_c).astype(np.float32),
                  rng.random(n_c).astype(np.float32)):
            reset_launches()
            got = tsp.spmv_csr(*(a.cuda() for a in csr), T(x).cuda())
            assert LAUNCHES["spmv_csr"] == 1
            want = tsp.spmv_csr_ref(*csr, T(x))
            exact = bool((x == np.round(x)).all())
            tol = dict(rtol=0, atol=0) if exact else dict(rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(got.cpu(), want, **tol)
            again = tsp.spmv_csr(*(a.cuda() for a in csr), T(x).cuda())
            assert torch.equal(got, again)
