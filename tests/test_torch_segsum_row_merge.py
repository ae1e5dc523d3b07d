"""The shared-memory segment sum (#5) and the fused row merge of the point
read's combine (#2): plain models of the two CUDA designs (slabs, chunks and
per-block flushes; the warp and block routes of the row count) and the
port's plain versions against the JAX package (Pallas in interpret mode,
and its refs), on identical numpy inputs made from a seed. Integer-valued
sums, keys and ranks must be exactly equal."""
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jmr = import_module("repro.kernels.merge_rank.ops")
jsr = import_module("repro.kernels.segment_reduce.ops")
jsr_ref = import_module("repro.kernels.segment_reduce.ref")
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels import merge_rank as tmr
from repro_torch.kernels import segment_reduce as tsr
from repro_torch.kernels.common import I32_MAX

T = torch.from_numpy

# csrc/segment_sum.cu's constants: bins per slab, threads per block, the
# entries a block loads at once (4 groups of 4 a thread) and the least it
# takes; RESIDENT is an H100's 132 SMs at one 1,024-thread block of 128 KB
SLAB_MAX, THREADS, RESIDENT = 32768, 1024, 132
TILE = THREADS * 4 * 4


# ------------------------------------------------------- segment sum (#5)
def _slab_model(ids, vals, n_seg, slab_max=SLAB_MAX, resident=RESIDENT,
                min_chunk=4 * THREADS, tile=TILE):
    """csrc/segment_sum.cu's privatised kernel in numpy: the host's slab and
    chunk sizing, then per block (chunk-major) a zeroed slab and the chunk
    in tiles, each tile's in-slab entries added as int32 while every value
    so far is an integer of at most ``int_limit`` in magnitude, and as
    float32 from the first tile that is not (the int32 sums converted
    then); each non-zero bin is added to the output as float32."""
    n = len(ids)
    out = np.zeros(n_seg, np.float32)
    if n == 0 or n_seg == 0:
        return out
    slabs = -(-n_seg // slab_max)
    slab = -(-n_seg // slabs)
    chunks = max(1, min(resident // slabs, -(-n // min_chunk)))
    chunk = (-(-n // chunks) + 3) // 4 * 4
    chunks = -(-n // chunk)
    int_limit = min(1 << 24, (2 ** 31 - 1) // chunk)
    for b in range(chunks * slabs):
        s0 = (b % slabs) * slab
        width = min(slab, n_seg - s0)
        lo = (b // slabs) * chunk
        bins = np.zeros(width, np.int32)
        for t0 in range(lo, min(n, lo + chunk), tile):
            stop = min(t0 + tile, lo + chunk)
            i, v = ids[t0:stop], vals[t0:stop]
            if bins.dtype == np.int32 and not (
                    (v == np.trunc(v)) & (np.abs(v) <= int_limit)).all():
                bins = bins.astype(np.float32)
            local = i.astype(np.int64) - s0
            ok = (local >= 0) & (local < width)
            np.add.at(bins, local[ok], v[ok].astype(bins.dtype))
        bins = bins.astype(np.float32)
        hit = np.nonzero(bins)[0]
        out[s0 + hit] += bins[hit]
    return out


def _segsum_case(case, rng):
    """(ids, vals, n_segments, model sizing) for each planted case."""
    if case == "hub":  # 5,000 copies of one id among 12,000
        ids = rng.integers(0, 300, 12_000)
        ids[rng.choice(12_000, 5000, replace=False)] = 17
        return ids, 300, dict(slab_max=128, resident=12, min_chunk=64,
                              tile=256)
    if case == "below_one_slab":
        return rng.integers(0, 100, 3000), 100, dict(slab_max=128, resident=5,
                                                     min_chunk=64, tile=256)
    if case == "one_slab_plus_one":
        return rng.integers(0, 129, 3000), 129, dict(slab_max=128, resident=6,
                                                     min_chunk=64, tile=256)
    if case == "out_of_range":  # ids < 0 and >= S, near both int32 ends
        ids = rng.integers(-400, 700, 4000)
        ids[:3] = (-2 ** 31, 2 ** 31 - 1, 300)
        return ids, 300, dict(slab_max=128, resident=8, min_chunk=64,
                              tile=256)
    if case == "past_int_limit":  # chunks of 3,000: |v| <= 715,827 as int32
        return rng.integers(0, 6000, 12_000), 6000, dict(
            slab_max=4096, resident=8, min_chunk=64, tile=256)
    raise KeyError(case)


@pytest.mark.parametrize("case", ["hub", "below_one_slab",
                                  "one_slab_plus_one", "out_of_range",
                                  "past_int_limit"])
def test_segment_sum_slab_model_matches_jax(case):
    """The model at small slabs equals the JAX wrapper (Pallas, interpret)
    and the JAX ref bit for bit on integer-valued inputs (int32 sums in
    every block, or, past the int32 limit of a chunk's values, float32),
    and within rtol 1e-5 on random floats and where a chunk switches; the
    port's wrapper (plain version on the CPU) equals both."""
    rng = np.random.default_rng(len(case))
    ids, n_seg, sizing = _segsum_case(case, rng)
    ids = ids.astype(np.int32)
    mixed = rng.integers(0, 5, len(ids)).astype(np.float64)
    mixed[len(ids) // 2:] += 0.5  # a chunk switches to float32 mid-way
    big = np.full(len(ids), 715_828.0)  # one past the int32 limit: float32
    big[::2] = 1.0  # sums, exact below 2^24
    for label, vals in (("integer", rng.integers(0, 5, len(ids))),
                        ("float", rng.random(len(ids))),
                        ("mixed", mixed),
                        ("integer", big if case == "past_int_limit"
                         else rng.integers(-3, 3, len(ids)))):
        vals = vals.astype(np.float32)
        got = _slab_model(ids, vals, n_seg, **sizing)
        want = np.asarray(jsr.segment_sum(jnp.asarray(ids), jnp.asarray(vals),
                                          n_seg, block_n=1024, block_s=1024,
                                          interpret=True))
        ref = np.asarray(jsr_ref.segment_sum_ref(
            jnp.asarray(np.where(ids < n_seg, ids, -1)), jnp.asarray(vals),
            n_seg))
        port = tsr.segment_sum(T(ids), T(vals), n_seg).numpy()
        if label == "integer":
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(port, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5)
            np.testing.assert_allclose(got, ref, rtol=1e-5)
            np.testing.assert_allclose(port, want, rtol=1e-5)


def test_segment_sum_slab_model_at_the_kernel_sizes():
    """At the kernel's own constants: a degree update's 65,536 segments (two
    slabs) and 70,000 (three), with a planted hub and ids past both ends;
    integer-valued sums exact against the JAX ref and the port's plain
    version."""
    rng = np.random.default_rng(5)
    for n_seg in (65_536, 70_000):
        ids = rng.integers(-50, n_seg + 50, 40_000).astype(np.int32)
        ids[::7] = 40_123  # a hub across every chunk
        vals = rng.integers(0, 3, len(ids)).astype(np.float32)
        got = _slab_model(ids, vals, n_seg)
        want = np.asarray(jsr_ref.segment_sum_ref(
            jnp.asarray(np.where(ids < n_seg, ids, -1)), jnp.asarray(vals),
            n_seg))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tsr.segment_sum(T(ids), T(vals), n_seg).numpy(), want)


# ------------------------------------------------------------ row merge (#2)
def _rows(rng, n_q, n_seg, seg_w, mid_pads=0.0):
    """Rows of concatenated sorted segments (each 0..seg_w valid keys, the
    rest I32_MAX) with keys unique per row, as the fused read packs its
    (col, age) keys; ``mid_pads`` masks that share of the valid keys in
    place, as the residual column filter does (pads inside a segment).
    Row 0 is all pads and row 1 full."""
    keys = np.full((n_q, n_seg * seg_w), I32_MAX, np.int32)
    for i in range(n_q):
        pool = rng.permutation(4 * n_seg * seg_w)[:n_seg * seg_w]
        for s in range(n_seg):
            m = seg_w if i == 1 else int(rng.integers(0, seg_w + 1))
            keys[i, s * seg_w:s * seg_w + m] = np.sort(
                pool[s * seg_w:s * seg_w + m])
    keys[0] = I32_MAX
    if mid_pads:
        mask = rng.random(keys.shape) < mid_pads
        mask[1] = False
        keys[mask] = I32_MAX
    vals = rng.normal(size=keys.shape).astype(np.float32)
    return keys, vals


_ROW_CASES = {  # W = n_seg * seg_w
    "w8": (16, 2, 4, 0.0), "w32_mid_pads": (12, 4, 8, 0.3),
    "w40": (9, 5, 8, 0.0), "w128_mid_pads": (10, 8, 16, 0.25),
    "w256": (9, 8, 32, 0.0), "w256_mid_pads": (9, 8, 32, 0.4),
}


@pytest.mark.parametrize("case", sorted(_ROW_CASES))
def test_row_merge_plain_version_matches_jax(case):
    """The fused merge's plain version (and ``merge_combine_rows`` on both
    routes, which take it on the CPU) equals the JAX ``merge_combine_rows``
    with the Pallas row rank (interpret) and without, keys and values in
    every slot; each merged row is ascending and holds the row's valid
    keys."""
    n_q, n_seg, seg_w, mid = _ROW_CASES[case]
    rng = np.random.default_rng(n_q * 1000 + n_seg * seg_w)
    keys, vals = _rows(rng, n_q, n_seg, seg_w, mid)
    gk, gv = (x.numpy() for x in tmr.row_merge_ref(T(keys), T(vals)))
    for use_pallas in (False, True):
        wk, wv = jmr.merge_combine_rows(jnp.asarray(keys), jnp.asarray(vals),
                                        use_pallas=use_pallas)
        np.testing.assert_array_equal(gk, np.asarray(wk))
        np.testing.assert_array_equal(gv, np.asarray(wv))
        pk, pv = tmr.merge_combine_rows(T(keys), T(vals),
                                        use_pallas=use_pallas)
        np.testing.assert_array_equal(pk.numpy(), gk)
        np.testing.assert_array_equal(pv.numpy(), gv)
    pk, pv = tmr.row_merge(T(keys), T(vals))
    np.testing.assert_array_equal(pk.numpy(), gk)
    assert (np.diff(gk.astype(np.int64), axis=1) >= 0).all()
    for i in range(n_q):
        ok = keys[i] != I32_MAX
        np.testing.assert_array_equal(gk[i, :ok.sum()], np.sort(keys[i, ok]))
        np.testing.assert_array_equal(gv[i, :ok.sum()],
                                      vals[i, ok][np.argsort(keys[i, ok])])
        assert not gv[i, ok.sum():].any()
    assert (gk[0] == I32_MAX).all() and (gk[1] != I32_MAX).all()


def _row_launch_model(width):
    """csrc/row_rank.cu's launch: ('warp', 32) for W <= 32, else ('block',
    threads), one thread per key in passes of at most 1,024."""
    if width <= 32:
        return "warp", 32
    return "block", min(1024, -(-width // 32) * 32)


@pytest.mark.parametrize("width", [8, 32, 33, 40, 64, 100, 128, 256, 1000,
                                   1025, 2049])
def test_row_count_launch_model_equals_plain_rank(width):
    """The block route's counting in numpy: passes of ``threads`` keys cover
    the row, and each key counts the staged keys (tiles of 2,048, padded
    with I32_MAX to a multiple of 4) 4 at a time. Every key is counted once
    and the ranks equal the plain version's; a block never exceeds 1,024
    threads."""
    rng = np.random.default_rng(width)
    row = rng.integers(0, max(2, width // 2), width).astype(np.int32)
    row[::5] = I32_MAX
    route, threads = _row_launch_model(width)
    assert threads % 32 == 0 and threads <= 1024
    if route == "warp":
        assert width <= threads
    got = np.full(width, -1, np.int64)
    for j0 in range(0, width, threads):
        for j in range(j0, min(width, j0 + threads)):
            assert got[j] == -1
            count = 0
            for t0 in range(0, width, 2048):
                tile = row[t0:t0 + 2048]
                tile = np.concatenate([tile, np.full(-len(tile) % 4, I32_MAX,
                                                     np.int32)])
                count += int((tile.reshape(-1, 4) < row[j]).sum())
            got[j] = count
    want = tmr.row_rank_ref(T(row[None])).numpy()[0]
    np.testing.assert_array_equal(got, want)


def test_row_merge_refuses_mismatched_shapes():
    keys = T(np.zeros((2, 3), np.int32))
    with pytest.raises(ValueError):
        tmr.row_merge(keys, T(np.zeros((2, 4), np.float32)))
    with pytest.raises(ValueError):
        tmr.row_merge(T(np.zeros(3, np.int32)), T(np.zeros(3, np.float32)))


def test_cpu_merge_combine_rows_launches_nothing():
    keys, vals = _rows(np.random.default_rng(0), 4, 2, 8)
    reset_launches()
    tmr.merge_combine_rows(T(keys), T(vals), use_pallas=True)
    tsr.segment_sum(T(keys[0]), T(vals[0]), 5)
    assert not any(LAUNCHES.values())


# ------------------------------------------------------------------- card
@pytest.mark.gpu
def test_segment_sum_on_card_matches_plain_version():
    """The privatised kernel (and the direct one it replaced) on the card
    against the plain version: 10,000 copies of one id, S in {1, 65,536,
    70,000}, ids < 0 and >= S, arrays offset by one entry (the scalar
    loads), no entries, values that are integers (int32 sums), random or
    both; integer-valued sums exact, others within rtol 1e-5 (float atomics
    add in no fixed order). One launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(6)
    for n_seg in (1, 65_536, 70_000):
        ids = rng.integers(-3, n_seg + 3, 300_001).astype(np.int32)
        ids[rng.choice(len(ids), 10_000, replace=False)] = n_seg // 2
        mixed = rng.integers(0, 4, len(ids)).astype(np.float32)
        mixed[len(ids) // 2:] += 0.25  # chunks of int32 and float32 sums
        for vals in (rng.integers(0, 4, len(ids)).astype(np.float32),
                     rng.random(len(ids)).astype(np.float32), mixed):
            want = tsr.segment_sum_ref(T(ids), T(vals), n_seg)
            exact = bool((vals == np.round(vals)).all())
            tol = dict(rtol=0, atol=0) if exact else dict(rtol=1e-5, atol=0)
            di, dv = T(ids).cuda(), T(vals).cuda()
            for fn in (tsr.segment_sum, tsr.segment_sum_direct):
                reset_launches()
                got = fn(di, dv, n_seg)
                assert LAUNCHES["segment_sum"] == 1
                torch.testing.assert_close(got.cpu(), want, **tol)
            got = tsr.segment_sum(di[1:], dv[1:], n_seg).cpu()
            torch.testing.assert_close(
                got, tsr.segment_sum_ref(T(ids[1:]), T(vals[1:]), n_seg),
                **tol)
    empty = torch.zeros(0, dtype=torch.int32, device="cuda")
    assert not tsr.segment_sum(empty, empty.float(), 7).cpu().any()


@pytest.mark.gpu
def test_row_merge_on_card_matches_plain_version():
    """The fused row merge and the row rank on the card against their plain
    versions, exactly: both routes (W <= 32 and wider), all-pad rows, full
    rows, pads inside segments, a row past one shared-memory tile (W =
    2,304), float32 and int32 values (float64 refused); one launch per
    ``merge_combine_rows`` call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(7)
    for n_q, n_seg, seg_w, mid in ((512, 1, 8, 0.0), (600, 4, 8, 0.3),
                                   (512, 8, 16, 0.2), (8, 8, 32, 0.4),
                                   (8, 2, 8, 0.0), (33, 5, 9, 0.1),
                                   (5, 9, 256, 0.3)):
        keys, vals = _rows(rng, n_q, n_seg, seg_w, mid)
        dk = T(keys).cuda()
        assert torch.equal(tmr.row_rank(dk).cpu(), tmr.row_rank_ref(T(keys)))
        with pytest.raises(TypeError):
            tmr.row_merge(dk, T(vals.astype(np.float64)).cuda())
        for v in (vals, vals.view(np.int32)):
            wk, wv = tmr.row_merge_ref(T(keys), T(v))
            reset_launches()
            gk, gv = tmr.merge_combine_rows(dk, T(v).cuda(), use_pallas=True)
            assert LAUNCHES["row_merge"] == 1 and sum(LAUNCHES.values()) == 1
            assert torch.equal(gk.cpu(), wk) and torch.equal(gv.cpu(), wv)
