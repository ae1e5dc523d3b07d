"""The port's mesh path (``repro_torch.db.spmd``) against the JAX package's
``repro.db.spmd`` on the same numpy inputs (4 ranks, batches of 128, ids
4,096, 4 L0 slots, level capacity 4,096).

* The JAX side runs once, in a subprocess with 4 fake XLA host devices
  (the device count must be set before jax starts). It drives every step
  builder with ``use_pallas=False`` and writes each call's input state,
  operands and outputs to an npz.
* The port side runs once: 4 gloo ranks spawned on the CPU (a ``file://``
  rendezvous, joined under a timeout) start each call from the JAX call's
  input state (``from_jax_stacked``), run the same step and gather their
  outputs (``to_stacked_numpy``) and registry snapshots to rank 0.
* Keys, ``k``, ``n``, keep masks and ``cnt_max`` must be exactly equal, and
  so must the values of ``last`` / ``min`` / ``max``; values of ``sum``
  within rtol = atol = 1e-6 (both packages add a key's values in the same
  order, so they come out equal in practice).

The calls cover the full-stack no-op (a fifth ingest into 4 slots), a
split and a move between calls of the tablet step (built once), a query
step with and without ``q_tile``, scans with and without
``transpose_output`` (and a window narrower than a run's slice), and a
compaction into a non-empty level. In-process tests hold the bucketing,
``ShardedTable.insert_routed``, ``DBserver.attach_process_snapshot`` /
``metrics(all_processes=True)`` and ``merge_process_metrics`` against the
JAX package, and the ranks' snapshots show the step counters. A
``gpu``-marked test runs the pair step and a compaction on the card.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.db import spmd
from repro_torch.db.tablets import TabletMap
from repro_torch.kernels.common import I32_MAX

ROOT = Path(__file__).resolve().parents[1]
S, BCAP, IDCAP, SLOTS, CAP = 4, 128, 1 << 12, 4, 1 << 12
STEPS = SLOTS + 2
MAX_T, SPLIT_AT_CALL, SPLIT_KEY, MOVE_TO = 16, 2, 1536, 3
QB, MAX_RETURN = 20, 4
LO, HI = IDCAP // 8, IDCAP * 5 // 8
JOIN_S = 120
SUM_TOL = dict(rtol=1e-6, atol=1e-6)

CASES = ("ingest-last", "ingest-max",
         "lsm_ingest-last", "lsm_ingest-sum", "lsm_ingest-min",
         "lsm_ingest-max", "pair_ingest-last", "tablet_ingest-last",
         "compact-last", "compact-sum",
         "query-last", "query-sum", "query-last-tile8",
         "scan-last-w16", "scan-sum-w1024", "scan-last-w1024-T")
# the outputs that hold values (a state's vals, the query's and scan's)
VALUE_OUTS = {"query": "o1", "scan": "o2"}
# calls each rank makes of each step, by op
CALLS = {"spmd_ingest": 6, "spmd_lsm_ingest": 4 * (SLOTS + 1),
         "spmd_lsm_pair_ingest": SLOTS + 1, "spmd_tablet_ingest": SLOTS,
         "spmd_lsm_compact": 4, "spmd_lsm_query": 3, "spmd_lsm_scan": 3}

JAX_SCRIPT = r'''
import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.db import spmd
from repro.db.kvstore import Tablet
from repro.db.tablets import TabletMap

inp = dict(np.load(sys.argv[1]))
S, IDCAP, SLOTS, CAP, MAX_T, MAX_RETURN = (
    int(inp[k]) for k in ("S", "IDCAP", "SLOTS", "CAP", "MAX_T",
                          "MAX_RETURN"))
BCAP, STEPS = inp["br"].shape[2], inp["br"].shape[0]
mesh = jax.make_mesh((S,), ("data",))
out = {}


def sharded(x):
    x = jnp.asarray(x)
    spec = P("data", *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def state(st):
    return jax.tree.map(sharded, st)


def record(key, **named):
    for name, v in named.items():
        if isinstance(v, (Tablet, spmd.L0Stack)):
            count = "n" if isinstance(v, Tablet) else "k"
            for f in ("rows", "cols", "vals", count):
                out[f"{key}/{name}.{f}"] = np.asarray(getattr(v, f))
        else:
            out[f"{key}/{name}"] = np.asarray(v)


def batch(i):
    return tuple(sharded(inp[k][i]) for k in ("br", "bc", "bv"))


def empty_l0():
    return state(spmd.l0_stacked_empty(S, SLOTS, S * BCAP))


def empty_level():
    return state(spmd.stacked_empty(S, CAP))


for comb in ("last", "max"):
    case = f"ingest-{comb}"
    step = spmd.make_spmd_ingest_step(mesh, "data", S, IDCAP, comb,
                                      use_pallas=False)
    t = empty_level()
    for i in range(3):
        record(f"{case}/{i}/in", tablet=t, step=i)
        t = step(t, *batch(i))
        record(f"{case}/{i}/out", tablet=t)

lsm = {}
for comb in ("last", "sum", "min", "max"):
    case = f"lsm_ingest-{comb}"
    step = lsm[comb] = spmd.make_spmd_lsm_ingest_step(mesh, "data", S,
                                                      IDCAP, comb)
    l0 = empty_l0()
    for i in range(SLOTS + 1):  # the last call meets a full stack
        record(f"{case}/{i}/in", l0=l0, step=i)
        l0 = step(l0, *batch(i))
        record(f"{case}/{i}/out", l0=l0)

step = spmd.make_spmd_lsm_pair_ingest_step(mesh, "data", S, IDCAP, "last")
l0, l0t = empty_l0(), empty_l0()
for i in range(SLOTS + 1):
    record(f"pair_ingest-last/{i}/in", l0=l0, l0t=l0t, step=i)
    l0, l0t = step(l0, l0t, *batch(i))
    record(f"pair_ingest-last/{i}/out", l0=l0, l0t=l0t)
    if i == SLOTS - 1:
        pair_t = l0t

tm = TabletMap.uniform(S, IDCAP)
step = spmd.make_spmd_tablet_ingest_step(mesh, "data", S, "last")
l0 = empty_l0()
for i in range(SLOTS):
    if i == int(inp["SPLIT_AT_CALL"]):
        nid = tm.split(int(tm.tablet_ids[1]), int(inp["SPLIT_KEY"]))
        tm.move(nid, int(inp["MOVE_TO"]))
    splits, owners = tm.device_routing(MAX_T)
    record(f"tablet_ingest-last/{i}/in", l0=l0, step=i, splits=splits,
           owners=owners)
    l0 = step(l0, *batch(i), jnp.asarray(splits), jnp.asarray(owners))
    record(f"tablet_ingest-last/{i}/out", l0=l0)

mixed = {}
for comb in ("last", "sum"):
    case = f"compact-{comb}"
    compact = spmd.make_spmd_lsm_compact_step(mesh, "data", comb,
                                              use_pallas=False)
    l0, level = empty_l0(), empty_level()
    for i in range(SLOTS):
        l0 = lsm[comb](l0, *batch(i))
    record(f"{case}/0/in", l0=l0, level=level)
    l0, level = compact(l0, level)
    record(f"{case}/0/out", l0=l0, level=level)
    for i in range(SLOTS, STEPS):
        l0 = lsm[comb](l0, *batch(i))
    mixed[comb] = (l0, level)  # a level and two L0 runs
    record(f"{case}/1/in", l0=l0, level=level)
    l0, level = compact(l0, level)
    record(f"{case}/1/out", l0=l0, level=level)

for comb, tile in (("last", None), ("sum", None), ("last", 8)):
    case = f"query-{comb}" + (f"-tile{tile}" if tile else "")
    step = spmd.make_spmd_lsm_query_step(mesh, "data", comb,
                                         max_return=MAX_RETURN, q_tile=tile)
    l0, level = mixed[comb]
    record(f"{case}/0/in", l0=l0, level=level, q=inp["q"])
    res = step(l0, level, sharded(inp["q"]))
    record(f"{case}/0/out", **{f"o{j}": x for j, x in enumerate(res)})

for comb, width, tr in (("last", 16, False), ("sum", 1024, False),
                        ("last", 1024, True)):
    case = f"scan-{comb}-w{width}" + ("-T" if tr else "")
    step = spmd.make_spmd_lsm_scan_step(mesh, "data", comb, width=width,
                                        transpose_output=tr)
    l0, level = (pair_t, empty_level()) if tr else mixed[comb]
    record(f"{case}/0/in", l0=l0, level=level, bounds=inp["bounds"])
    res = step(l0, level, sharded(inp["bounds"]))
    record(f"{case}/0/out", **{f"o{j}": x for j, x in enumerate(res)})

np.savez(sys.argv[2], **out)
'''


def _inputs(seed=0):
    """The batches (``[STEPS, S, BCAP]``, pads I32_MAX / 0), each rank's
    owner-routed query ids (pad -1) and scan bounds. Rows and columns come
    from a pool of 160 ids and columns from 13 of them, so keys repeat
    within a batch, across ranks and across steps."""
    rng = np.random.default_rng(seed)
    pool = np.sort(rng.choice(IDCAP, 160, replace=False)).astype(np.int32)
    col_pool = pool[::13]
    br = np.full((STEPS, S, BCAP), I32_MAX, np.int32)
    bc = np.full((STEPS, S, BCAP), I32_MAX, np.int32)
    bv = np.zeros((STEPS, S, BCAP), np.float32)
    for i in range(STEPS):
        for s in range(S):
            n = int(rng.integers(BCAP // 2, BCAP + 1))
            br[i, s, :n] = rng.choice(pool, n)
            bc[i, s, :n] = rng.choice(col_pool, n)
            bv[i, s, :n] = rng.normal(size=n)
    q = np.full((S, QB), -1, np.int32)
    bounds = np.zeros((S, 2), np.int32)
    span = IDCAP // S
    for s in range(S):
        own = pool[(pool >= s * span) & (pool < (s + 1) * span)]
        absent = np.setdiff1d(np.arange(s * span, (s + 1) * span), pool)[:2]
        ids = np.concatenate([rng.choice(own, min(len(own), QB - 5),
                                         replace=False), absent])
        q[s, :len(ids)] = ids
        lo, hi = max(LO, s * span), min(HI, (s + 1) * span)
        bounds[s] = (lo, hi) if lo < hi else (lo, lo)
    return dict(br=br, bc=bc, bv=bv, q=q, bounds=bounds, S=S, IDCAP=IDCAP,
                SLOTS=SLOTS, CAP=CAP, MAX_T=MAX_T, MAX_RETURN=MAX_RETURN,
                SPLIT_AT_CALL=SPLIT_AT_CALL, SPLIT_KEY=SPLIT_KEY,
                MOVE_TO=MOVE_TO)


# ------------------------------------------------------------ the ranks
def _init_rank(rank, world, rdv):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    return spmd.make_mesh("data")


def _state_in(jx, key, name, rank):
    pre = f"{key}/{name}."
    return spmd.from_jax_stacked(
        {k[len(pre):]: v for k, v in jx.items() if k.startswith(pre)},
        rank, "cpu")


def _port_calls(case, jx, inp, rank, mesh):
    """Run ``case``'s recorded calls on this rank; returns {key: array}."""
    kind, comb, *opt = case.split("-")
    calls = sorted({int(k.split("/")[1]) for k in jx
                    if k.startswith(case + "/")})
    if kind == "ingest":
        step = spmd.make_spmd_ingest_step(mesh, "data", S, IDCAP, comb)
    elif kind == "lsm_ingest":
        step = spmd.make_spmd_lsm_ingest_step(mesh, "data", S, IDCAP, comb)
    elif kind == "pair_ingest":
        step = spmd.make_spmd_lsm_pair_ingest_step(mesh, "data", S, IDCAP,
                                                   comb)
    elif kind == "tablet_ingest":  # built once, the map changes between calls
        step = spmd.make_spmd_tablet_ingest_step(mesh, "data", S, comb)
        tm = TabletMap.uniform(S, IDCAP)
    elif kind == "compact":
        step = spmd.make_spmd_lsm_compact_step(mesh, "data", comb)
    elif kind == "query":
        tile = int(opt[0][4:]) if opt else None
        step = spmd.make_spmd_lsm_query_step(mesh, "data", comb,
                                             max_return=MAX_RETURN,
                                             q_tile=tile)
    else:
        step = spmd.make_spmd_lsm_scan_step(mesh, "data", comb,
                                            width=int(opt[0][1:]),
                                            transpose_output="T" in opt)
    mine = {}
    for i in calls:
        key = f"{case}/{i}/in"

        def st(name):
            return _state_in(jx, key, name, rank)

        if kind in ("ingest", "lsm_ingest", "pair_ingest", "tablet_ingest"):
            b = int(jx[f"{key}/step"])
            batch = [torch.as_tensor(inp[k][b, rank])
                     for k in ("br", "bc", "bv")]
        if kind == "ingest":
            outs = {"tablet": step(st("tablet"), *batch)}
        elif kind == "lsm_ingest":
            outs = {"l0": step(st("l0"), *batch)}
        elif kind == "pair_ingest":
            outs = dict(zip(("l0", "l0t"), step(st("l0"), st("l0t"), *batch)))
        elif kind == "tablet_ingest":
            if i == SPLIT_AT_CALL:
                tm.move(tm.split(int(tm.tablet_ids[1]), SPLIT_KEY), MOVE_TO)
            routing = tm.device_routing(MAX_T)
            for got, name in zip(routing, ("splits", "owners")):
                if not np.array_equal(got, jx[f"{key}/{name}"]):
                    raise AssertionError(f"{case} call {i}: {name} differ")
            outs = {"l0": step(st("l0"), *batch, *routing)}
        elif kind == "compact":
            outs = dict(zip(("l0", "level"), step(st("l0"), st("level"))))
        else:
            name = "q" if kind == "query" else "bounds"
            arg = torch.as_tensor(jx[f"{key}/{name}"][rank])
            outs = {f"o{j}": x for j, x in enumerate(
                step(st("l0"), st("level"), arg))}
        for name, v in outs.items():
            if isinstance(v, torch.Tensor):
                mine[f"{case}/{i}/out/{name}"] = v.numpy()
            else:
                for f, a in spmd.to_stacked_numpy([v]).items():
                    mine[f"{case}/{i}/out/{name}.{f}"] = a[0]
    return mine


def _sorted_merges():
    """Wrap the merge-path wrapper: every run it is given must be sorted
    over its whole width, pads included (the merge path, unlike a binary
    search, needs sorted queries). Returns the count of checked merges."""
    from repro_torch.kernels.merge_rank import ops as merge_ops
    from repro_torch.kernels.merge_rank.ref import pair_key
    real, checked = merge_ops.merge_ranks, [0]

    def merge_ranks(ar, ac, br, bc):
        for r, c in ((ar, ac), (br, bc)):
            key = pair_key(r, c)
            if not bool((key[:, 1:] >= key[:, :-1]).all()) \
                    or not bool(((r == I32_MAX) == (c == I32_MAX)).all()):
                raise AssertionError("a merge input is not sorted")
        checked[0] += 1
        return real(ar, ac, br, bc)

    merge_ops.merge_ranks = merge_ranks
    return checked


def _rank_main(rank, rdv, inputs, jax_npz, out_dir):
    mesh = _init_rank(rank, S, rdv)
    try:
        inp = dict(np.load(inputs))
        jx = dict(np.load(jax_npz))
        merges = _sorted_merges()
        mine = {}
        for case in CASES:
            mine.update(_port_calls(case, jx, inp, rank, mesh))
        from repro_torch.obs import default_registry
        got = [None] * S if rank == 0 else None
        dist.gather_object((mine, default_registry().snapshot(), merges[0]),
                           got, dst=0)
        if rank == 0:
            np.savez(Path(out_dir) / "port.npz", **{
                k: np.stack([g[0][k] for g in got]) for k in mine})
            (Path(out_dir) / "snapshots.json").write_text(
                json.dumps([g[1] for g in got]))
            (Path(out_dir) / "merges.json").write_text(
                json.dumps([g[2] for g in got]))
    finally:
        dist.destroy_process_group()


def _spawn(fn, args, n_ranks, timeout=JOIN_S):
    """``torch.multiprocessing`` spawn of ``n_ranks`` ranks, each called as
    ``fn(rank, *args)``; joined under ``timeout`` seconds (a hung
    collective fails the test, and its ranks are killed)."""
    import torch.multiprocessing as tmp
    ctx = tmp.start_processes(fn, args=args, nprocs=n_ranks, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise AssertionError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' outputs: (JAX npz, port npz, the ranks' snapshots)."""
    d = tmp_path_factory.mktemp("spmd")
    np.savez(d / "inputs.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT,
                          str(d / "inputs.npz"), str(d / "jax.npz")],
                         env=env, capture_output=True, text=True,
                         timeout=JOIN_S)
    assert res.returncode == 0, res.stderr[-3000:]
    _spawn(_rank_main, (str(d / "rdv"), str(d / "inputs.npz"),
                        str(d / "jax.npz"), str(d)), S)
    return (dict(np.load(d / "jax.npz")), dict(np.load(d / "port.npz")),
            json.loads((d / "snapshots.json").read_text()),
            json.loads((d / "merges.json").read_text()))


@pytest.mark.parametrize("case", CASES)
def test_step_equals_jax(case, runs):
    jx, pt = runs[:2]
    kind, comb = case.split("-")[:2]
    keys = sorted(k for k in jx if k.startswith(case + "/") and "/out/" in k)
    assert keys and set(keys) == {k for k in pt if k.startswith(case + "/")}
    for k in keys:
        want, got = jx[k], pt[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        is_val = k.endswith(".vals") or k.endswith("/" + VALUE_OUTS.get(
            kind, "-"))
        if is_val and comb == "sum":
            np.testing.assert_allclose(got, want, err_msg=k, **SUM_TOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_full_stack_step_is_a_noop(runs):
    """The fifth ingest into 4 slots leaves the stack and ``k`` as they
    were (both packages, every rank)."""
    pt = runs[1]
    for case in ("lsm_ingest-last", "pair_ingest-last"):
        pre = f"{case}/{SLOTS}/out/l0"
        last = f"{case}/{SLOTS - 1}/out/l0"
        for f in ("rows", "cols", "vals", "k"):
            np.testing.assert_array_equal(pt[f"{pre}.{f}"], pt[f"{last}.{f}"])
        assert (pt[f"{pre}.k"] == SLOTS).all()


def test_last_wins_by_source_rank(runs):
    """Across ingestors, ``last`` keeps the value of the highest source
    rank (then the latest in its batch): a numpy oracle of step 0."""
    pt = runs[1]
    inp = _inputs()
    r, c, v = (inp[k][0].reshape(-1) for k in ("br", "bc", "bv"))
    ok = r != I32_MAX
    latest = {}
    for key, val in zip(zip(r[ok], c[ok]), v[ok]):
        latest[key] = val
    owner = np.minimum(np.array([k[0] for k in latest]) * S // IDCAP, S - 1)
    keys = list(latest)
    for s in range(S):
        want = sorted(k for k, o in zip(keys, owner) if o == s)
        n = len(want)
        pre = "lsm_ingest-last/0/out/l0"
        np.testing.assert_array_equal(pt[f"{pre}.rows"][s, 0, :n],
                                      [k[0] for k in want])
        np.testing.assert_array_equal(pt[f"{pre}.cols"][s, 0, :n],
                                      [k[1] for k in want])
        np.testing.assert_array_equal(pt[f"{pre}.vals"][s, 0, :n],
                                      [latest[k] for k in want])
        assert (pt[f"{pre}.rows"][s, 0, n:] == I32_MAX).all()


def test_spmd_step_counters(runs):
    """Each rank counts its own steps (``spmd_steps{op}`` and the latency
    histogram); the retrace series exist and stay at 0; the merged
    snapshots count every rank's steps."""
    from repro_torch.db.spmd import merge_process_metrics
    from repro_torch.obs.export import registry_from_snapshot
    snaps = runs[2]
    assert len(snaps) == S
    for snap in snaps:
        for op, n in CALLS.items():
            assert snap[f"spmd_steps{{op={op}}}"] == n, op
            assert snap[f"db_op_latency_s{{op={op},table=spmd}}"]["count"] == n
            assert snap[f"lsm_retraces{{op={op},table=spmd}}"] == 0
            assert snap[f"lsm_compiled_shapes{{op={op},table=spmd}}"] == 0
    merged = registry_from_snapshot(merge_process_metrics(snaps))
    for op, n in CALLS.items():
        assert sum(c.value for c in merged.series("spmd_steps", op=op)) \
            == S * n


def test_mesh_merge_inputs_are_sorted_over_full_width(runs):
    """Every run the mesh steps give the merge path (the legacy step's
    ``tablet_insert``, the compaction's ``kway_merge``) is sorted over its
    whole width: one merge per legacy step, 4 per compaction of a level and
    4 slots, on every rank."""
    merges = CALLS["spmd_ingest"] + 4 * CALLS["spmd_lsm_compact"]
    assert runs[3] == [merges] * S


# ------------------------------------------------------- in-process tests
def _batch(rng, n_valid, skew=False):
    br = np.full(BCAP, I32_MAX, np.int32)
    bc = np.full(BCAP, I32_MAX, np.int32)
    bv = np.zeros(BCAP, np.float32)
    hi = IDCAP // 8 if skew else IDCAP
    br[:n_valid] = rng.integers(0, hi, n_valid)
    bc[:n_valid] = rng.integers(0, IDCAP, n_valid)
    bv[:n_valid] = rng.normal(size=n_valid)
    return br, bc, bv


def _same_buffers(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n_valid,skew", [(0, False), (BCAP, False),
                                          (77, False), (BCAP, True)])
def test_bucket_local_equals_jax(n_valid, skew):
    from repro.db import spmd as jspmd
    br, bc, bv = _batch(np.random.default_rng(n_valid), n_valid, skew)
    got = spmd._bucket_local(*map(torch.as_tensor, (br, bc, bv)), S, IDCAP)
    _same_buffers(got, jspmd._bucket_local(br, bc, bv, S, IDCAP))


def test_bucket_local_tablets_equals_jax():
    """A split and moved map routes as the JAX package routes."""
    from repro.db import spmd as jspmd
    from repro.db.tablets import TabletMap as JaxMap
    br, bc, bv = _batch(np.random.default_rng(5), 101)
    for tm in (TabletMap.uniform(S, IDCAP), JaxMap.uniform(S, IDCAP)):
        tm.move(tm.split(int(tm.tablet_ids[1]), SPLIT_KEY), MOVE_TO)
        tm.split(int(tm.tablet_ids[0]), 100)
    routing = tm.device_routing(MAX_T)
    np.testing.assert_array_equal(
        TabletMap.uniform(S, IDCAP).device_routing(MAX_T)[0],
        JaxMap.uniform(S, IDCAP).device_routing(MAX_T)[0])
    got = spmd._bucket_local_tablets(*map(torch.as_tensor, (br, bc, bv)),
                                     *routing, S)
    _same_buffers(got, jspmd._bucket_local_tablets(br, bc, bv, *routing, S))


@pytest.mark.parametrize("skew", [False, True])
def test_uniform_map_routes_as_the_range_split(skew):
    """The uniform tablet map's routing reproduces the static bucketing
    bit for bit."""
    br, bc, bv = (torch.as_tensor(x) for x in _batch(
        np.random.default_rng(9), 120, skew))
    routing = TabletMap.uniform(S, IDCAP).device_routing(MAX_T)
    _same_buffers(spmd._bucket_local_tablets(br, bc, bv, *routing, S),
                  spmd._bucket_local(br, bc, bv, S, IDCAP))


def _routed(rng, n):
    """Owner-routed ``[S, BCAP]`` buffers of ``n`` random triples."""
    from repro_torch.db.kvstore import shard_of
    r = rng.integers(0, IDCAP, n).astype(np.int32)
    c = rng.integers(0, 64, n).astype(np.int32)
    v = rng.normal(size=n).astype(np.float32)
    br = np.full((S, BCAP), I32_MAX, np.int32)
    bc = np.full((S, BCAP), I32_MAX, np.int32)
    bv = np.zeros((S, BCAP), np.float32)
    dest = shard_of(r, S, IDCAP)
    for s in range(S):
        sel = np.flatnonzero(dest == s)[:BCAP]
        br[s, :len(sel)], bc[s, :len(sel)], bv[s, :len(sel)] = \
            r[sel], c[sel], v[sel]
    return br, bc, bv


@pytest.mark.parametrize("engine", ["lsm", "single"])
def test_insert_routed_equals_jax(engine):
    """Routed appends (with a flush when a shard would overflow), then a
    host ``insert`` on the stale mirror: memtables, counts, point reads and
    scans equal the JAX store's fed the same calls."""
    import jax.numpy as jnp
    from repro.db.kvstore import ShardedTable as JaxTable
    from repro_torch.db.kvstore import ShardedTable
    cfg = dict(num_shards=S, capacity_per_shard=CAP, batch_cap=BCAP,
               id_capacity=IDCAP, memtable_cap=256, engine=engine,
               use_pallas=False)
    pt = ShardedTable(f"routed_{engine}", device="cpu", **cfg)
    jt = JaxTable(f"routed_{engine}_jax", **cfg)
    rng = np.random.default_rng(3)
    for _ in range(4):  # the third append overflows a shard: a flush
        bufs = _routed(rng, 400)
        pt.insert_routed(*bufs)
        jt.insert_routed(*map(jnp.asarray, bufs))
        np.testing.assert_array_equal(pt._mem_n, jt._mem_n)
        m = pt.mem_cap
        for got, want in zip(pt._mem_views(), (jt._mem_r, jt._mem_c,
                                               jt._mem_v)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not pt._mirror_ok and m == 256
    rows = rng.integers(0, IDCAP, 50).astype(np.int32)
    cols = rng.integers(0, 64, 50).astype(np.int32)
    vals = rng.normal(size=50).astype(np.float32)
    pt.insert(rows, cols, vals)
    jt.insert(rows, cols, vals)
    q = np.unique(np.concatenate([rows[:10], bufs[0][:, :5].ravel()]))
    q = q[q != I32_MAX]
    for got, want in zip(pt.query_rows(q), jt.query_rows(q)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(pt.scan(), jt.scan()):
        np.testing.assert_array_equal(got, want)
    pt.flush()
    jt.flush()
    if engine == "single":
        arrays = pt.tablet_arrays()
        for k in ("rows", "cols", "vals", "n"):
            np.testing.assert_array_equal(arrays[k],
                                          np.asarray(getattr(jt.tablets, k)))
    else:
        assert pt.engine_stats()["flushes"] == jt.engine_stats()["flushes"]
    assert pt._mirror_ok


def test_insert_routed_refuses_a_transpose_store():
    from repro.db.kvstore import ShardedTable as JaxTable
    from repro_torch.db.kvstore import ShardedTable
    cfg = dict(num_shards=S, capacity_per_shard=CAP, batch_cap=BCAP,
               id_capacity=IDCAP, transpose=True)
    bufs = _routed(np.random.default_rng(0), 10)
    msgs = []
    for st in (ShardedTable("routed_t", device="cpu", **cfg),
               JaxTable("routed_t_jax", **cfg)):
        with pytest.raises(ValueError) as err:
            st.insert_routed(*bufs)
        msgs.append(str(err.value).split(" (or ")[0])
    assert msgs[0] == msgs[1]


def _mesh_db(dbsetup, name, device=None):
    kw = {} if device is None else {"device": device}
    DB = dbsetup(name, dict(num_shards=2, capacity_per_shard=1024,
                            batch_cap=256, id_capacity=1 << 10), **kw)
    T = DB["mtab_" + name]
    T.put_triple(np.asarray(["a", "b", "c"], object),
                 np.asarray(["x", "x", "y"], object),
                 np.asarray([1.0, 2.0, 3.0]))
    return DB


def _counts(m, table):
    """The deterministic part of a metrics() table: entry counts per shard
    and each op's latency sample count."""
    t = m["tables"][table]
    return ({s: v["ingest_entries"] for s, v in t["shards"].items()},
            {op: h["count"] for op, h in t["latency_s"].items()})


def test_attach_process_snapshot_equals_jax(tmp_path):
    """A peer snapshot as a dict and another as a JSON path merge into
    ``metrics(all_processes=True)`` as in the JAX connector; the live
    registry does not change."""
    from repro.db import dbsetup as jax_dbsetup
    from repro.obs import Registry as JaxRegistry
    from repro_torch.db import dbsetup
    from repro_torch.obs import Registry
    views = []
    for setup, reg_cls, name, dev in ((dbsetup, Registry, "pmesh", "cpu"),
                                      (jax_dbsetup, JaxRegistry, "jmesh",
                                       None)):
        DB = _mesh_db(setup, name, dev)
        table = "mtab_" + name
        peer = reg_cls()
        peer.counter("db_ingest_entries", table=table, shard=0).inc(123)
        peer.histogram("db_op_latency_s", table=table, op="ingest").observe(
            0.5)
        peer.counter("spmd_steps", op="spmd_ingest").inc(7)
        DB.attach_process_snapshot(peer.snapshot())
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(peer.snapshot()))
        DB.attach_process_snapshot(str(path))
        local = _counts(DB.metrics(), table)
        merged = _counts(DB.metrics(all_processes=True), table)
        assert _counts(DB.metrics(), table) == local
        assert merged[0]["0"] == local[0]["0"] + 246
        assert merged[1]["ingest"] == local[1]["ingest"] + 2
        views.append((local, merged))
    assert views[0] == views[1]


def test_merge_process_metrics_equals_jax():
    from repro.db.spmd import merge_process_metrics as jax_merge
    from repro_torch.obs import Registry
    snaps = []
    rng = np.random.default_rng(2)
    for p in range(3):
        reg = Registry()
        reg.counter("spmd_steps", op="spmd_lsm_ingest").inc(5 + p)
        reg.gauge("lsm_compiled_shapes", table="spmd", op="x").set(0)
        h = reg.histogram("db_op_latency_s", table="spmd", op="x")
        for x in rng.exponential(1e-3, 20 + p):
            h.observe(float(x))
        snaps.append(json.loads(json.dumps(reg.snapshot())))
    assert spmd.merge_process_metrics(snaps) == jax_merge(snaps)


# ------------------------------------------------------------- on the card
def _gpu_rank(rank, rdv, out_dir):
    """The pair step (two calls) and a compaction of both stacks, once on
    CPU tensors and once on the card, from the same batches."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    mesh = _init_rank(rank, 2, rdv)
    try:
        torch.cuda.set_device(0)
        rng = np.random.default_rng(10 + rank)
        batches = [_batch(rng, int(rng.integers(64, BCAP + 1)))
                   for _ in range(2)]
        res = {}
        for dev in ("cpu", "cuda"):
            pair = spmd.make_spmd_lsm_pair_ingest_step(mesh, "data", 2,
                                                       IDCAP, "sum")
            compact = spmd.make_spmd_lsm_compact_step(mesh, "data", "sum")
            l0 = spmd.l0_stacked_empty(2, 2 * BCAP, dev)
            l0t = spmd.l0_stacked_empty(2, 2 * BCAP, dev)
            for b in batches:
                l0, l0t = pair(l0, l0t, *(torch.as_tensor(x, device=dev)
                                          for x in b))
            reset_launches()
            out = [compact(x, spmd.stacked_empty(CAP, dev))[1]
                   for x in (l0, l0t)]
            if dev == "cuda":
                torch.cuda.synchronize()
                # a compaction of a level and 2 slots is 2 merges a side
                if LAUNCHES["merge_path_rank"] != 4:
                    raise AssertionError(f"launches {LAUNCHES}")
            res[dev] = spmd.to_stacked_numpy(out)
        for k in res["cpu"]:
            if not np.array_equal(res["cpu"][k], res["cuda"][k]):
                raise AssertionError(f"rank {rank}: {k} differs on the card")
        Path(out_dir, f"ok{rank}").write_text(
            str(int(res["cuda"]["n"].sum())))
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA device (the merge-path kernel has "
                           "no CPU mode)")
def test_pair_step_and_compaction_on_the_card(tmp_path):
    """2 gloo ranks share the card (the exchange host-staged): the pair
    step and a compaction launch ``merge_path_rank`` and equal the same
    ranks' run on CPU tensors."""
    from repro_torch.kernels import common
    common.build()
    _spawn(_gpu_rank, (str(tmp_path / "rdv"), str(tmp_path)), 2)
    assert all(int((tmp_path / f"ok{r}").read_text()) > 0 for r in range(2))
