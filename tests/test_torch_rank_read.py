"""The single engine's point read on the card's design: the warp search of
the 1-D rank (``csrc/rank.cu``: a group of lanes per (query, side), a
pivot level per round trip, a ballot, a last window) and the compacting
gather (``tablet_gather``: equal output tiles, the tile's queries found by
the same search over the end offsets), as numpy models; the port's plain
versions against the JAX package (Pallas in interpret mode, and its
single-run store) on identical numpy inputs made from a seed. Ranks, row
ids, cols and values must be exactly equal."""
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.db import kvstore as jkv
from repro_torch.db import kvstore as tkv
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels import sorted_search as tss
from repro_torch.kernels.common import I32_MAX

jss = import_module("repro.kernels.sorted_search.ops")

T = torch.from_numpy

# csrc/rank.cu's constants: the rank's lanes per (query, side), the
# gather's entries per block and the queries a block stages
GROUP, GATHER_TILE, STAGE = 32, 1024, 2048


def _group_rank(tab, x, strict, g=GROUP):
    """``group_rank``: a g-ary search, one pivot level per round trip, the
    ballot's popcount narrowing [lo, lo + len] g-fold, then one window of g
    entries. Checks that every ballot is a true prefix."""
    n = len(tab)

    def ballot(ps):
        ok = [p < n and (tab[p] < x if strict else tab[p] <= x) for p in ps]
        m = sum(ok)
        assert ok == [True] * m + [False] * (g - m), "ballot not a prefix"
        return m

    length, lo = g, 0
    while length < n:
        length *= g
    while length > g:
        step = length // g
        lo += ballot([lo + (j + 1) * step - 1 for j in range(g)]) * step
        length = step
    return lo + ballot([lo + j for j in range(g)])


def _upper(e, n, p):
    """The gather's branch-free search: #{j < n : e[j] <= p}."""
    base = 0
    while n > 1:
        half = n >> 1
        base = base + half if e[base + half] <= p else base
        n -= half
    return base + int(e[base] <= p)


def _gather_model(cols, vals, start, ends, q, total, tile=GATHER_TILE,
                  stage=STAGE):
    """``tablet_gather_kernel``: per output tile, every query while they
    fit the stage, else those between the queries of its first and last
    entry (the 32-ary search over ``ends``), then each entry's query among
    those and its copy."""
    out_r = np.full(total, -7, np.int32)
    out_c = np.full(total, -7, np.int32)
    out_v = np.full(total, np.nan, np.float32)
    for p0 in range(0, total, tile):
        p1 = min(total, p0 + tile) - 1
        qa, n_s = 0, len(q)
        if len(q) > stage:
            qa = _group_rank(ends, p0, False, 32)
            n_s = _group_rank(ends, p1, False, 32) - qa + 1
        e = ends[qa:qa + n_s]
        off0 = ends[qa - 1] if qa > 0 else 0
        for p in range(p0, p1 + 1):
            j = _upper(e, n_s, p)
            src = start[qa + j] + p - (e[j - 1] if j > 0 else off0)
            out_r[p], out_c[p], out_v[p] = q[qa + j], cols[src], vals[src]
    return out_r, out_c, out_v


def _tablet(rng, n, valid, keys, hub=0):
    """One tablet of ``n`` slots: ``valid`` entries sorted by (row, col)
    over ``keys`` row ids (``hub`` more of row 3), then I32_MAX pads."""
    r = np.concatenate([rng.integers(0, keys, valid - hub),
                        np.full(hub, 3)]).astype(np.int32)
    c = rng.integers(0, 1000, valid).astype(np.int32)
    o = np.lexsort((c, r))
    rows = np.full(n, I32_MAX, np.int32)
    cols = np.full(n, I32_MAX, np.int32)
    vals = np.zeros(n, np.float32)
    rows[:valid], cols[:valid] = r[o], c[o]
    vals[:valid] = rng.integers(-50, 50, valid)
    return rows, cols, vals


# ------------------------------------------------------------ the rank (#4)
@pytest.mark.parametrize("g", [32, 16])
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1023, 1025])
def test_warp_rank_model_equals_searchsorted(n, g):
    """Both group widths (one warp per (query, side), or half a warp a
    side), both sides, at table lengths around the powers of 32, on a
    table with runs of equal keys and I32_MAX pads, and on an all-pad
    table; queries below, inside and above the keys, I32_MAX - 1 and
    I32_MAX."""
    rng = np.random.default_rng(n * 3 + g)
    m = int(rng.integers(0, n + 1))
    tab = np.full(n, I32_MAX, np.int64)
    tab[:m] = np.sort(rng.integers(0, 40, m))
    q = np.concatenate([rng.integers(-2, 43, 20), [0, 39, I32_MAX - 1,
                                                   I32_MAX]])
    for t in (tab, np.full(n, I32_MAX, np.int64)):
        for strict, side in ((True, "left"), (False, "right")):
            got = [_group_rank(t, int(x), strict, g) for x in q]
            np.testing.assert_array_equal(got, np.searchsorted(t, q, side))


def test_warp_rank_model_on_a_run_of_10000_equal_keys():
    """One key over 10,000 entries spans every pivot of the first levels:
    left and right land at the run's two ends."""
    tab = np.concatenate([np.arange(100), np.full(10_000, 500),
                          np.arange(600, 700), np.full(50, I32_MAX)])
    for g in (32, 16):
        for x in (499, 500, 501):
            for strict, side in ((True, "left"), (False, "right")):
                assert _group_rank(tab, x, strict, g) == \
                    np.searchsorted(tab, x, side)


@pytest.mark.parametrize("n_tab", [1, 300, 2048])
def test_rank_both_matches_jax(n_tab):
    """``rank(side="both")`` (one launch on the card) equals the JAX
    search's left and right ranks, stacked; each side alone equals its
    row; the binary-search yardstick gives the same on the CPU."""
    rng = np.random.default_rng(n_tab + 11)
    tab = np.full(n_tab, I32_MAX, np.int32)
    m = int(rng.integers(1, n_tab + 1))
    tab[:m] = np.sort(rng.integers(0, 500, m))
    q = np.concatenate([rng.integers(-5, 510, 70),
                        [I32_MAX - 1]]).astype(np.int32)
    got = tss.rank(T(tab), T(q), "both").numpy()
    assert got.shape == (2, 71) and got.dtype == np.int32
    for i, side in enumerate(("left", "right")):
        want = np.asarray(jss.sorted_search(jnp.asarray(tab), jnp.asarray(q),
                                            side, block_q=64, block_t=256))
        np.testing.assert_array_equal(got[i], want, err_msg=side)
        np.testing.assert_array_equal(tss.rank(T(tab), T(q), side).numpy(),
                                      want)
        np.testing.assert_array_equal(
            tss.rank_binary(T(tab), T(q), side).numpy(), want)
    np.testing.assert_array_equal(
        tss.sorted_search(T(tab), T(q), "both").numpy(), got)
    with pytest.raises(ValueError, match="side"):
        tss.rank(T(tab), T(q), "middle")


# ----------------------------------------------------------- the gather
@pytest.mark.parametrize("tile,stage", [(3, 8), (64, 8), (64, STAGE),
                                        (GATHER_TILE, 8),
                                        (GATHER_TILE, STAGE)])
def test_gather_model_equals_plain_versions(tile, stage):
    """The gather's tiling (tiles of 3 and 64 entries cut every row; a hub
    of 700 entries spans many), its stage of every query or of the tile's
    (a stage of 8 queries takes the search), with duplicated, absent and
    pad-valued ids, equals ``tablet_gather_ref`` and the old route
    (``tablet_read_ref``: the padded block, then ``nonzero``)."""
    rng = np.random.default_rng(tile + stage)
    rows, cols, vals = _tablet(rng, 3000, 2500, 60, hub=700)
    q = np.concatenate([rng.integers(0, 70, 40), [3, 3, 65, 3, 0],
                        [I32_MAX - 1]]).astype(np.int32)
    ranks = tss.rank(T(rows), T(q), "both")
    ends = torch.cumsum(ranks[1] - ranks[0], 0, dtype=torch.int32)
    total = int(ends[-1])
    want = tss.tablet_read_ref(T(rows), T(cols), T(vals), T(q))
    ref = tss.tablet_gather_ref(T(cols), T(vals), ranks[0], ends, T(q),
                                total)
    model = _gather_model(cols, vals, ranks[0].numpy(), ends.numpy(), q,
                          total, tile, stage)
    for w, r, m, part in zip(want, ref, model, ("rows", "cols", "vals")):
        np.testing.assert_array_equal(r.numpy(), w.numpy(), err_msg=part)
        np.testing.assert_array_equal(m, w.numpy(), err_msg=part)
    assert total == len(want[0]) > 700


def test_tablet_read_edges():
    """No query, no match, an all-pad tablet and an empty table: int32 /
    float32 empties; a single entry; the plain versions agree."""
    rng = np.random.default_rng(4)
    rows, cols, vals = _tablet(rng, 64, 40, 10)
    pads = np.full(16, I32_MAX, np.int32)
    empty = np.zeros(0, np.int32)
    cases = [(rows, cols, vals, empty),
             (rows, cols, vals, np.asarray([50, 11], np.int32)),
             (pads, pads, np.zeros(16, np.float32),
              np.asarray([0, I32_MAX - 1], np.int32)),
             (empty, empty, np.zeros(0, np.float32),
              np.asarray([1], np.int32)),
             (rows[:1], cols[:1], vals[:1], rows[:1].copy())]
    for r, c, v, q in cases:
        got = tss.tablet_read(T(r), T(c), T(v), T(q))
        want = tss.tablet_read_ref(T(r), T(c), T(v), T(q))
        assert [x.dtype for x in got] == [torch.int32, torch.int32,
                                          torch.float32]
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert len(got[0]) == 1


def test_tablet_read_matches_jax_single_store():
    """The JAX single-run store's ``query_rows`` (its padded block, widen
    and ``nonzero``, Pallas in interpret mode) against the port's store on
    ``tablet_read`` and against ``tablet_read_ref`` on the same shard: a
    row longer than ``max_return`` (the widen case), duplicated and absent
    ids, and an empty shard."""
    geom = dict(num_shards=2, capacity_per_shard=512, batch_cap=64,
                id_capacity=64, memtable_cap=256)
    jt = jkv.ShardedTable("jax_tablet_read", engine="single", **geom)
    tt = tkv.ShardedTable("torch_tablet_read", engine="single",
                          use_pallas=True, device="cpu", **geom)
    rng = np.random.default_rng(8)
    r = np.concatenate([rng.integers(0, 32, 200), np.full(40, 5)])
    c = rng.integers(0, 64, len(r))
    v = rng.integers(-3, 9, len(r)).astype(np.float32)
    for t in (jt, tt):  # ids < 32 only: shard 1 stays empty
        t.insert(r.astype(np.int32), c.astype(np.int32), v)
    q = np.asarray([5, 7, 5, 31, 30, 40, 63, 7, 5], np.int32)
    reset_launches()
    got = tt.query_rows(q, max_return=4)
    assert not any(LAUNCHES.values())  # CPU tensors take plain versions
    want = jt.query_rows(q, max_return=4)
    for g, w, part in zip(got, want, ("rows", "cols", "vals")):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=part)
    assert (got[0] == 5).sum() > 3 * 4  # row 5 is past max_return, thrice
    shard = tt._shard_tablet(0)
    own = q[q < 32]
    ref = tss.tablet_read_ref(shard.rows, shard.cols, shard.vals, T(own))
    cut = int((want[0] < 32).sum())
    for x, w in zip(ref, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(w)[:cut])
    assert len(tt.query_rows(np.asarray([40, 50], np.int32))[0]) == 0


# ------------------------------------------------------------- on the card
@pytest.mark.gpu
def test_rank_and_gather_on_card_match_plain_versions():
    """On the card: the warp rank in all three modes and the binary-search
    yardstick at table lengths around the powers of 32 (all-pad and with
    runs of equal keys), at Q = 1,024 x N = 815,709 (the single engine's
    read), and the gather (a hub of 13,000 entries across 13 tiles; 1,024
    queries, all staged, and 5,000, past the stage), each exactly equal to
    its plain version, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    for n in (0, 1, 31, 32, 33, 1023, 1025, 33_000, 815_709):
        m = int(rng.integers(0, n + 1))
        keyed = np.full(n, I32_MAX, np.int32)
        keyed[:m] = np.sort(rng.integers(0, max(2, m // 40), m))
        for tab in (np.full(n, I32_MAX, np.int32), keyed):
            q = np.concatenate([rng.integers(-2, max(3, m // 40) + 2, 1021),
                                [0, I32_MAX - 1, I32_MAX]]).astype(np.int32)
            tc, qc = T(tab).cuda(), T(q).cuda()
            for side in ("left", "right", "both"):
                want = tss.rank_ref(T(tab), T(q), side)
                for fn in (tss.rank, tss.rank_binary):
                    reset_launches()
                    got = fn(tc, qc, side).cpu()
                    assert LAUNCHES["rank"] == 1
                    assert torch.equal(got, want), (n, side, fn.__name__)
    rows, cols, vals = _tablet(rng, 815_709, 600_000, 40_000, hub=13_000)
    tab = [T(x).cuda() for x in (rows, cols, vals)]
    for n_q in (1024, 5000):  # every query staged; the tile's queries only
        q = np.concatenate([rng.integers(0, 40_100, n_q - 4),
                            [3, 3, 40_500, I32_MAX - 1]]).astype(np.int32)
        qc = T(q).cuda()
        reset_launches()
        got = tss.tablet_read(*tab, qc)
        assert LAUNCHES["rank"] == 1 and LAUNCHES["tablet_gather"] == 1
        want = tss.tablet_read_ref(*tab, qc)
        for g, w in zip(got, want):
            assert torch.equal(g, w), n_q
        assert len(got[0]) > 2 * 13_000
        ranks = tss.rank(tab[0], qc, "both")
        ends = torch.cumsum(ranks[1] - ranks[0], 0, dtype=torch.int32)
        args = (tab[1], tab[2], ranks[0], ends, qc, int(ends[-1]))
        for g, w in zip(tss.tablet_gather(*args),
                        tss.tablet_gather_ref(*args)):
            assert torch.equal(g, w), n_q
