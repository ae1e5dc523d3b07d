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
    for strict, side in ((True, "left"), (False, "right")):
        want = _np(rank_pallas(jnp.asarray(tab).reshape(1, -1),
                               jnp.asarray(q).reshape(-1, 1), strict=strict,
                               block_q=64, block_t=128, interpret=True))[:, 0]
        np.testing.assert_array_equal(tss.rank(T(tab), T(q), side).numpy(),
                                      want)
        np.testing.assert_array_equal(
            tss.rank_ref(T(tab), T(q), side).numpy(), want)


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
    tss.sorted_search_batched(T(np.zeros((1, 4), np.int32)),
                              T(np.zeros(3, np.int32)), "both")
    tmr.row_rank(T(np.zeros((2, 3), np.int32)))
    tmr.merge_ranks(*(T(np.zeros((2, 3), np.int32)) for _ in range(4)))
    tss.sorted_search(T(np.zeros(4, np.int32)), T(np.zeros(3, np.int32)))
    tss.tablet_read(*(T(np.zeros(4, np.int32)) for _ in range(2)),
                    T(np.ones(4, np.float32)), T(np.zeros(3, np.int32)))
    tsr.segment_sum(T(np.zeros(3, np.int32)), T(np.ones(3, np.float32)), 2)
    tsp.spmv_ell(T(np.zeros((2, 3), np.int32)), T(np.ones((2, 3), np.float32)),
                 T(np.ones(4, np.float32)))
    tsp.spmv_csr(T(np.array([0, 1, 3], np.int32)), T(np.zeros(3, np.int32)),
                 T(np.ones(3, np.float32)), T(np.ones(4, np.float32)))
    tmr.row_merge(T(np.zeros((2, 3), np.int32)),
                  T(np.ones((2, 3), np.float32)))
    assert LAUNCHES == {"rank_batched": 0, "pair_rank": 0,
                        "merge_path_rank": 0, "row_rank": 0, "row_merge": 0,
                        "rank": 0, "tablet_gather": 0, "segment_sum": 0,
                        "spmv_ell": 0, "spmv_csr": 0, "flash_attention": 0}


# ------------------------------------------------------ merge-path ranks (#3)
def _pair_runs(rng, n_s, n, valid, keys=6, dup=True):
    """[S, n] runs sorted over their full width: ``valid[s]`` entries from a
    ``keys`` x ``keys`` key space (equal keys within and across runs when
    ``dup``), then (I32_MAX, I32_MAX) pads."""
    rr = np.full((n_s, n), I32_MAX, np.int32)
    cc = np.full((n_s, n), I32_MAX, np.int32)
    for s in range(n_s):
        m = valid[s]
        if dup:
            r, c = rng.integers(0, keys, m), rng.integers(0, keys, m)
        else:
            flat = np.sort(rng.choice(keys * keys, m, replace=False))
            r, c = flat // keys, flat % keys
        o = np.lexsort((c, r))
        rr[s, :m], cc[s, :m] = r[o], c[o]
    return rr, cc


_MERGE_CASES = {
    # name: (S, n_a, valid_a, n_b, valid_b, keys)
    "ties": (1, 40, [40], 40, [40], 3),
    "dup_inside_a": (1, 64, [64], 16, [16], 4),
    "pads_meet_pads": (1, 24, [10], 32, [7], 5),
    "uneven": (1, 37, [30], 200, [180], 12),
    "empty_a": (1, 0, [0], 20, [15], 6),
    "empty_b": (1, 20, [12], 0, [0], 6),
    "all_pads": (1, 16, [0], 8, [0], 6),
    "shards": (3, 48, [48, 5, 0], 40, [0, 40, 17], 7),
}


@pytest.mark.parametrize("case", sorted(_MERGE_CASES))
def test_merge_ranks_matches_jax_pair_rank(case):
    """Both merge-rank vectors equal the JAX pair_rank_pallas calls
    (interpret mode, B ranked in A strictly and A in B non-strictly) and
    the port's compare-count pair_rank_ref, exactly."""
    from repro.kernels.merge_rank.kernel import pair_rank_pallas
    n_s, n_a, va, n_b, vb, keys = _MERGE_CASES[case]
    rng = np.random.default_rng(len(case))
    ar, ac = _pair_runs(rng, n_s, n_a, va, keys)
    br, bc = _pair_runs(rng, n_s, n_b, vb, keys)
    rank_a, rank_b = tmr.merge_ranks(T(ar), T(ac), T(br), T(bc))
    assert rank_a.dtype == rank_b.dtype == torch.int32
    assert rank_a.shape == (n_s, n_a) and rank_b.shape == (n_s, n_b)
    np.testing.assert_array_equal(
        rank_a, tmr.pair_rank_ref(T(br), T(bc), T(ar), T(ac), True))
    np.testing.assert_array_equal(
        rank_b, tmr.pair_rank_ref(T(ar), T(ac), T(br), T(bc), False))

    def jax_rank(tr, tc, qr, qc, strict):
        if qr.size == 0:
            return np.zeros(0, np.int32)
        if tr.size == 0:  # no table to tile: every rank is 0
            return np.zeros(qr.size, np.int32)
        n_q = -(-qr.size // 8) * 8  # queries padded to the query block
        pad = lambda x: np.pad(x, (0, n_q - x.size))
        return _np(pair_rank_pallas(
            jnp.asarray(tr)[None], jnp.asarray(tc)[None],
            jnp.asarray(pad(qr))[:, None], jnp.asarray(pad(qc))[:, None],
            strict=strict, block_q=n_q, block_t=tr.size,
            interpret=True))[:qr.size, 0]

    for s in range(n_s):
        np.testing.assert_array_equal(
            rank_a[s], jax_rank(br[s], bc[s], ar[s], ac[s], True))
        np.testing.assert_array_equal(
            rank_b[s], jax_rank(ar[s], ac[s], br[s], bc[s], False))


def _corank(a, b, d, lanes=32):
    """The partition kernel's co-rank of diagonal d (one warp, 32-ary):
    each round ``lanes`` probes, a ballot, and the range cut to one step.
    ``a``, ``b`` are lists of (row, col) tuples; a_first is ``<=``."""
    lo, hi = max(0, d - len(b)), min(d, len(a))
    while hi > lo:
        n = hi - lo
        step = -(-n // lanes)
        ok = [a[p - 1] <= b[d - p]
              for p in (lo + min((k + 1) * step, n) for k in range(lanes))]
        assert ok == sorted(ok, reverse=True)  # the ballot is a prefix
        m = sum(ok)
        if m == lanes:
            lo = hi
        else:
            lo, hi = lo + min(m * step, n), lo + min((m + 1) * step, n) - 1
    return lo


def _merge_path_model(a, b, tile, items):
    """csrc/merge_path.cu in plain Python: co-ranks at every tile diagonal,
    then per tile each thread's co-rank (binary search in the tile's
    windows) and its sequential merge of ``items`` outputs."""
    total = len(a) + len(b)
    n_tiles = -(-total // tile)
    bounds = [_corank(a, b, min(t * tile, total)) for t in range(n_tiles + 1)]
    rank_a, rank_b = [None] * len(a), [None] * len(b)
    for t in range(n_tiles):
        d0, d1 = t * tile, min((t + 1) * tile, total)
        i0, i1 = bounds[t], bounds[t + 1]
        j0 = d0 - i0
        wa, wb = a[i0:i1], b[j0:d1 - i1]
        na, nb = len(wa), len(wb)
        for th in range(tile // items):
            dl = min(th * items, na + nb)
            lo, hi = max(0, dl - nb), min(dl, na)
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if wa[mid - 1] <= wb[dl - mid]:
                    lo = mid
                else:
                    hi = mid - 1
            i, j = lo, dl - lo
            for _ in range(dl, min(dl + items, na + nb)):
                if j >= nb or (i < na and wa[i] <= wb[j]):
                    rank_a[i0 + i] = j0 + j
                    i += 1
                else:
                    rank_b[j0 + j] = i0 + i
                    j += 1
    return np.asarray(rank_a, np.int64), np.asarray(rank_b, np.int64)


@pytest.mark.parametrize("tile,items", [(4, 2), (8, 4), (24, 8), (2048, 8)])
def test_merge_path_partition_model_equals_stable_sort(tile, items):
    """The merge-path scheme at small tiles, where equal-key groups (runs
    of 30 copies of one key in both A and B) and the two runs' pads
    straddle tile boundaries, gives the stable-sort ranks; 2,000-entry
    runs take the 32-ary search through several rounds."""
    rng = np.random.default_rng(tile)
    for n_a, va, n_b, vb in ((120, 100, 90, 70), (2000, 1990, 1500, 1480),
                             (50, 0, 60, 45)):
        ar, ac = _pair_runs(rng, 1, n_a, [va], keys=4)
        br, bc = _pair_runs(rng, 1, n_b, [vb], keys=4)
        ar[0, 10:40], ac[0, 10:40] = ar[0, 10], ac[0, 10]  # a group of 30
        key = (int(ar[0, 10]), int(ac[0, 10]))
        lo = np.searchsorted(br[0].astype(np.int64) * 2 ** 32 + bc[0],
                             key[0] * 2 ** 32 + key[1])
        br[0, lo:lo + 30], bc[0, lo:lo + 30] = key  # and 30 in B
        o = np.lexsort((bc[0], br[0]))
        br[0], bc[0] = br[0, o], bc[0, o]
        a = list(zip(ar[0].tolist(), ac[0].tolist()))
        b = list(zip(br[0].tolist(), bc[0].tolist()))
        got_a, got_b = _merge_path_model(a, b, tile, items)
        want_a, want_b = tmr.merge_ranks_ref(T(ar), T(ac), T(br), T(bc))
        np.testing.assert_array_equal(got_a, want_a[0].numpy())
        np.testing.assert_array_equal(got_b, want_b[0].numpy())


def test_merge_inputs_are_sorted_over_full_width(monkeypatch):
    """Every run the merge kernel is given, by the LSM engine's flushes and
    major compactions and by the single engine's tablet_insert, is sorted
    lexicographically over its whole width, pads included: the merge path
    (unlike the binary search) needs sorted queries."""
    from repro_torch.db.kvstore import ShardedTable
    from repro_torch.kernels.merge_rank import ops as merge_ops
    from repro_torch.kernels.merge_rank.ref import pair_key
    seen = []
    real = merge_ops.merge_ranks

    def checked(ar, ac, br, bc):
        for r, c in ((ar, ac), (br, bc)):
            key = pair_key(r, c)
            assert bool((key[:, 1:] >= key[:, :-1]).all()), "unsorted run"
            assert bool(((r == I32_MAX) == (c == I32_MAX)).all())
        seen.append(ar.shape)
        return real(ar, ac, br, bc)

    monkeypatch.setattr(merge_ops, "merge_ranks", checked)
    rng = np.random.default_rng(4)
    for engine, kw in (("lsm", dict(memtable_cap=16, l0_slots=2)),
                       ("single", dict(memtable_cap=64))):
        t = ShardedTable(f"torch_sorted_{engine}", engine=engine,
                         num_shards=2, capacity_per_shard=512, batch_cap=32,
                         id_capacity=128, use_pallas=True, device="cpu", **kw)
        before = len(seen)
        for _ in range(12):
            n = int(rng.integers(1, 17))
            t.insert(rng.integers(0, 128, n).astype(np.int32),
                     rng.integers(0, 128, n).astype(np.int32),
                     np.ones(n, np.float32))
        t.flush()
        if engine == "lsm":
            t.major_compact()
        assert len(seen) > before, engine


# ------------------------------------------------ two-sided fence search (#1)
def _fence_model(row, x, side, stage):
    """csrc/rank_batched.cu for one row and query in plain Python: the
    branch-free search of the staged row, or of every stride-th entry
    (stride 32, doubled until the samples fit ``stage``) narrowed in the
    row to 32 entries and counted. ``both`` searches the right bound from
    the left one. Returns the rank, or (left, right)."""
    n = len(row)
    stride = 1
    if n > stage:
        stride = 32
        while -(-n // stride) > stage:
            stride *= 2
    s = row[::stride]

    def search(lo, strict):
        before = (lambda v: v < x) if strict else (lambda v: v <= x)
        if lo >= len(s):
            return lo
        base, ln = lo, len(s) - lo
        while ln > 1:
            half = ln >> 1
            base = base + half if before(s[base + half]) else base
            ln -= half
        return base + before(s[base])

    def finish(c, strict):
        before = (lambda v: v < x) if strict else (lambda v: v <= x)
        if stride == 1 or c == 0:
            return c
        lo = (c - 1) * stride
        ln = min(stride, n - lo)
        while ln > 32:
            half = ln >> 1
            if before(row[lo + half]):
                lo, ln = lo + half, ln - half
            else:
                ln = half
        return lo + sum(before(v) for v in row[lo:lo + ln])

    c = search(0, side != "right")
    first = finish(c, side != "right")
    if side != "both":
        return first
    return first, finish(search(c, False), False)


@pytest.mark.parametrize("n,stage", [(0, 8), (7, 8), (300, 512), (300, 8),
                                     (600, 4), (2048, 16)])
def test_two_level_fence_search_model(n, stage):
    """The kernel's search, dense (a row that fits) and sampled (every
    32nd fence, or every 64th.. when the samples outgrow the stage, then a
    32-entry window), against rank_batched_ref for all three modes, on
    rows with runs of duplicate fences and I32_MAX pads."""
    rng = np.random.default_rng(n + stage)
    tabs = _tabs(rng, 3, n, hi=60)  # 60 values: long duplicate runs
    if n:
        tabs[0] = np.sort(rng.integers(0, 60, n))  # no pads
    q = np.concatenate([rng.integers(-2, 63, 40),
                        [0, 59, I32_MAX - 1, I32_MAX]]).astype(np.int32)
    for side in ("left", "right", "both"):
        want = tss.rank_sides_ref(T(tabs), T(q), side).numpy()
        got = np.asarray([[_fence_model(list(tabs[k]), int(x), side, stage)
                           for x in q] for k in range(3)])
        if side == "both":
            got = got.transpose(2, 0, 1)
        np.testing.assert_array_equal(got, want, err_msg=side)


@pytest.mark.parametrize("n_tab", [1, 300, 2048])
def test_rank_batched_both_matches_jax(n_tab):
    """side="both" (one launch on the card) equals the JAX batched search's
    left and right ranks, stacked."""
    rng = np.random.default_rng(n_tab + 7)
    tabs = _tabs(rng, 3, n_tab)
    q = rng.integers(-5, 510, 70).astype(np.int32)
    got = tss.sorted_search_batched(T(tabs), T(q), "both").numpy()
    assert got.shape == (2, 3, 70) and got.dtype == np.int32
    for i, side in enumerate(("left", "right")):
        want = _np(jss.sorted_search_batched(jnp.asarray(tabs),
                                             jnp.asarray(q), side,
                                             block_q=64, block_t=256))
        np.testing.assert_array_equal(got[i], want, err_msg=side)


@pytest.mark.gpu
def test_kernels_on_card_match_plain_versions():
    """On the card each wrapper launches its CUDA kernel; ranks must equal
    the plain versions exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    tabs = _tabs(rng, 4, 1000)
    q = rng.integers(-5, 510, 700).astype(np.int32)
    for side in ("left", "right", "both"):
        got = tss.rank_batched(T(tabs).cuda(), T(q).cuda(), side).cpu()
        assert torch.equal(got, tss.rank_sides_ref(T(tabs), T(q), side))
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
    for side in ("left", "right", "both"):
        got = tss.rank(T(tab).cuda(), T(q).cuda(), side).cpu()
        assert torch.equal(got, tss.rank_ref(T(tab), T(q), side))
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


@pytest.mark.gpu
def test_merge_path_rank_on_card_matches_plain_and_pair_rank():
    """The merge-path kernel on the card against its plain version and the
    binary-search pair_rank kernel (both directions), exactly: 10,000
    copies of one key in both runs (a group across many tiles), all-pad
    runs, empty sides, a run of 3 entries, and S = 4 at 815,709 entries
    (the single engine's flush). One launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    same = [np.full((1, 10_000), 5, np.int32)] * 2
    pads = [np.full((2, 3000), I32_MAX, np.int32)] * 2
    cases = [(same, same), (pads, pads),
             (_pair_runs(rng, 2, 0, [0, 0]), _pair_runs(rng, 2, 50, [50, 9])),
             (_pair_runs(rng, 2, 70, [70, 1]), _pair_runs(rng, 2, 0, [0, 0])),
             (_pair_runs(rng, 1, 3, [3]), _pair_runs(rng, 1, 3, [2])),
             (_pair_runs(rng, 1, 3, [3]), same),
             (_pair_runs(rng, 4, 815_709, [815_709, 800_000, 10, 0],
                         keys=2000),
              _pair_runs(rng, 4, 815_709, [0, 815_709, 700_001, 3],
                         keys=2000))]
    for (ar, ac), (br, bc) in cases:
        args = [T(x).cuda() for x in (ar, ac, br, bc)]
        reset_launches()
        got_a, got_b = tmr.merge_ranks(*args)
        assert LAUNCHES["merge_path_rank"] == 1
        want_a, want_b = tmr.merge_ranks_ref(*args)
        assert torch.equal(got_a, want_a) and torch.equal(got_b, want_b)
        ar_, ac_, br_, bc_ = args
        assert torch.equal(got_a, tmr.pair_rank(br_, bc_, ar_, ac_, True))
        assert torch.equal(got_b, tmr.pair_rank(ar_, ac_, br_, bc_, False))


@pytest.mark.gpu
def test_rank_batched_on_card_all_modes_and_row_lengths():
    """The fence search on the card in all three modes against the plain
    version, exactly: rows that fit the shared-memory stage (16, 800 and
    8,192 entries) and rows that take the sampled search (8,193 and 20,000:
    every 32nd entry; 300,000: every 64th), with duplicate runs and pads;
    one launch for both sides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(4)
    for n in (16, 800, 8192, 8193, 20_000, 300_000):
        tabs = _tabs(rng, 3, n, hi=n // 4 + 2)
        q = np.concatenate([rng.integers(-2, n // 4 + 4, 600),
                            [I32_MAX - 1, I32_MAX]]).astype(np.int32)
        for side in ("left", "right", "both"):
            reset_launches()
            got = tss.rank_batched(T(tabs).cuda(), T(q).cuda(), side).cpu()
            assert LAUNCHES["rank_batched"] == 1
            assert torch.equal(got, tss.rank_sides_ref(T(tabs), T(q), side)), \
                (n, side)
