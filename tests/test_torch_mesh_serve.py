"""Serving on real ranks under the production rules, in every family: a
DTensor prefill and two decode steps, against the JAX package's prefill
and the port's plain path on the same weights.

Four gloo ranks (spawned, ``file://`` rendezvous, joined under a timeout)
on a (1, 4) ("data", "model") mesh (olmoe-1b-7b also on a (2, 2) one,
whisper-large-v3 also on a (4, 1) one) with the dry run's rules
(``dryrun.rules_for(False)``): the parameters and the batch are DTensors
placed by ``sharding_tree`` (zamba2-2.7b also with the batch a plain
tensor, the same on every rank), and ``model.prefill`` then
``model.decode`` run as a user calls them, with no
``ReshardOnRefusal``. Reduced configs, float32, 2 layers (zamba2-2.7b: one
group of two Mamba2 layers and the shared attention); MoE at
``capacity_factor = n_experts / experts_per_token``, so that the
expert-parallel prefill drops no token. What this holds:

* the MoE decode step (a sequence of 1 takes the local routing, as JAX's
  ``apply_moe`` does) counts its experts' start offsets with ops DTensor
  has rules for (it has none for ``searchsorted``);
* the Mamba2 state, the hybrid's ``(ssm, conv)`` and the enc-dec cross
  keys and values are DTensors placed as their specs say, so that the
  step's in-place writes of DTensor slices have a DTensor target; every
  family's state takes its mesh from the embedded activations, so a
  plain batch with DTensor parameters gets DTensor states too;
* a rank that holds several heads wraps the attention's output (the
  plain version's is a permuted view) as a contiguous shard.

Held: the DTensor prefill's logits within rtol 1e-5 of JAX's ``prefill``
(atol 1e-5 of the largest entry); each decode step's logits and the final
state within rtol 1e-5 of the port's plain path run from the gathered
prefill state (``test_torch_{moe,mamba2,hybrid,encdec,vlm}.py`` hold that
path to JAX); every rank the same values; no rank a fallback. The weights
are numpy draws from a seed (each normal leaf at std 0.02), carried
across by ``params_from_jax``.

Also: ``moe.route`` on DTensors (a 1-rank fake world) gives the integers
of ``torch.searchsorted``, bit for bit, on a draw with empty experts and
on one with every pair on one expert; Mamba2's padding by concatenation
gives ``F.pad``'s values.
"""
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_reduced as jax_reduced
from repro.models import build as jax_build

N_RANKS, B, S, STEPS, MAX_LEN, LAYERS = 4, 4, 16, 2, 24, 2
JOIN_S = 120
# case -> (arch, mesh shape ("data", "model"), the batch as DTensors)
CASES = {"olmoe": ("olmoe-1b-7b", (1, 4), True),
         "olmoe_2x2": ("olmoe-1b-7b", (2, 2), True),
         "kimi": ("kimi-k2-1t-a32b", (1, 4), True),
         "mamba2": ("mamba2-2.7b", (1, 4), True),
         "zamba2": ("zamba2-2.7b", (1, 4), True),
         "whisper": ("whisper-large-v3", (1, 4), True),
         "internvl2": ("internvl2-26b", (1, 4), True),
         # every rank all the heads: the attention's output as it comes
         "whisper_4x1": ("whisper-large-v3", (4, 1), True),
         # the batch plain, the same on every rank: the states take their
         # mesh from the parameters
         "zamba2_plain_batch": ("zamba2-2.7b", (1, 4), False)}


def _cfg(case, jax_side):
    from repro_torch.configs import get_reduced
    base = (jax_reduced if jax_side else get_reduced)(CASES[case][0])
    kw = {}
    if base.n_experts:  # no token dropped at the expert-parallel capacity
        kw["capacity_factor"] = base.n_experts / base.experts_per_token
    return dataclasses.replace(base, param_dtype="float32", n_layers=LAYERS,
                               **kw)


def _params(specs, seed):
    """A numpy draw of every leaf of the JAX spec tree ``specs``."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree.flatten(specs, is_leaf=lambda x: hasattr(
        x, "init"))
    out = []
    for s in leaves:
        if s.init in ("zeros", "ones"):
            x = np.full(s.shape, 1.0 if s.init == "ones" else 0.0)
        else:
            x = rng.normal(size=s.shape) * 0.02
        out.append(x.astype(np.float32))
    return jax.tree.unflatten(tree, out)


def _batch(case, seed):
    """The prefill batch (JAX's input names) and the decode tokens."""
    cfg = _cfg(case, True)
    rng = np.random.default_rng(seed)
    n = cfg.n_img_tokens if cfg.family == "vlm" else 0
    out = {"tokens": rng.integers(1, cfg.vocab, (B, S - n)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = (rng.normal(size=(B, cfg.n_frames, cfg.d_model))
                         * 0.02).astype(np.float32)
    if cfg.family == "vlm":
        out["img_embeds"] = (rng.normal(size=(B, n, cfg.d_model))
                             * 0.02).astype(np.float32)
    nxt = rng.integers(1, cfg.vocab, (B, STEPS)).astype(np.int32)
    return out, nxt


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _nest(flat):
    out = {}
    for name, x in flat.items():
        *path, last = name.split("/")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[last] = x
    return out


# ------------------------------------------------------------ the ranks
def _rank_main(rank, rdv, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=N_RANKS, rank=rank)
    try:
        _rank_body(rank, d)
    finally:
        dist.destroy_process_group()


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _map(fn, state):
    """``fn`` of every tensor of a nest of tuples and lists, the nest
    kept."""
    if isinstance(state, (tuple, list)):
        return type(state)(_map(fn, s) for s in state)
    return fn(state)


def _leaves(state):
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    return [state]


def _decode(model, params, state, nxt, sh=None, place=lambda t: t):
    """A decode step per column of ``nxt`` from ``state`` (the prefill's
    outputs after its logits: the cache, and an enc-dec's cross keys and
    values): (the steps' logits side by side, the final state)."""
    f = model.cfg.family
    steps = []
    for t in range(nxt.shape[1]):
        b = {"token": place(nxt[:, t:t + 1]), "cache": state[0]}
        if f == "encdec":
            b["cross"] = state[1]
        if f != "ssm":
            b["pos"] = S + t
        out, state[0] = model.decode(params, b, sh)
        steps.append(_whole(out))
    return torch.cat(steps, 1), state


def _rank_body(rank, d):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch import dryrun
    from repro_torch.models import (build, make_sharder, params_from_jax,
                                    sharding_tree)
    from repro_torch.models.spec import flatten_up_to, tree_map
    meshes = {shape: init_device_mesh("cpu", shape,
                                      mesh_dim_names=("data", "model"))
              for shape in sorted({c[1] for c in CASES.values()})}
    rules = dryrun.rules_for(False)
    mine = {}
    for case, (_, shape, placed) in CASES.items():
        mesh = meshes[shape]
        cfg = _cfg(case, False)
        model = build(cfg)
        sh = make_sharder(rules, mesh)
        arrays = dict(np.load(os.path.join(d, f"{case}_params.npz")))
        params = params_from_jax(cfg, _nest(arrays), device="cpu")
        pls = flatten_up_to(model.param_specs, sharding_tree(
            model.param_specs, rules, mesh))
        leaves = iter(distribute_tensor(p, mesh, list(pl)) for p, pl in zip(
            flatten_up_to(model.param_specs, params), pls))
        dparams = tree_map(lambda _: next(leaves), model.param_specs)
        batch_np = dict(np.load(os.path.join(d, f"{case}_batch.npz")))
        nxt = torch.from_numpy(batch_np.pop("next"))
        bpl = sharding_tree(model.prefill_input_specs(B, S), rules, mesh)
        batch = {k: distribute_tensor(torch.from_numpy(x), mesh,
                                      list(bpl[k])) if placed
                 else torch.from_numpy(x) for k, x in batch_np.items()}
        tpl = list(sharding_tree(model.decode_input_specs(B, MAX_LEN), rules,
                                 mesh)["token"])
        logits, *state = model.prefill(dparams, dict(batch, max_len=MAX_LEN),
                                       sh)
        mine[f"{case}/prefill"] = _whole(logits).numpy()
        gathered = _map(lambda x: _whole(x).clone(), state)
        for tag, p, st, hook, place in (
                ("dtensor", dparams, state, sh,
                 lambda t: distribute_tensor(t, mesh, tpl) if placed else t),
                ("plain", params, gathered, None, lambda t: t)):
            steps, st = _decode(model, p, st, nxt, hook, place)
            mine[f"{case}/steps/{tag}"] = steps.numpy()
            for i, x in enumerate(_leaves(st)):
                mine[f"{case}/state{i}/{tag}"] = _whole(x).float().numpy()
        mine[f"{case}/fallbacks"] = np.array(sum(sh.fallbacks.values()))
    np.savez(os.path.join(d, f"rank{rank}.npz"), **mine)


def _spawn(fn, args, n_ranks, timeout=JOIN_S):
    import torch.multiprocessing as tmp
    ctx = tmp.start_processes(fn, args=args, nprocs=n_ranks, join=False,
                              start_method="spawn")
    return ctx, time.monotonic() + timeout


def _join(ctx, deadline, timeout=JOIN_S):
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
    d = tmp_path_factory.mktemp("mesh_serve")
    jax_side = {}
    for i, case in enumerate(CASES):
        model = jax_build(_cfg(case, True))
        params = _params(model.param_specs, i)
        batch, nxt = _batch(case, 100 + i)
        np.savez(d / f"{case}_params.npz", **_flat(params))
        np.savez(d / f"{case}_batch.npz", next=nxt, **batch)
        jax_side[case] = (model, params, batch)
    ctx, deadline = _spawn(_rank_main, (str(d / "rdv"), str(d)), N_RANKS)
    want = {}
    try:  # the JAX side while the ranks run
        for case, (model, params, batch) in jax_side.items():
            jb = {k: jnp.asarray(x) for k, x in batch.items()}
            out = jax.jit(lambda p, b, m=model: m.prefill(
                p, b, lambda x, *a: x))(params, jb)
            want[case] = np.asarray(out[0])
    finally:
        _join(ctx, deadline)
    got = [dict(np.load(d / f"rank{r}.npz")) for r in range(N_RANKS)]
    return want, got


# ----------------------------------------------------------------- tests
@pytest.mark.parametrize("case", list(CASES))
def test_dtensor_prefill_matches_jax(runs, case):
    want, got = runs
    w = want[case]
    assert got[0][f"{case}/prefill"].shape == w.shape
    np.testing.assert_allclose(got[0][f"{case}/prefill"], w, rtol=1e-5,
                               atol=1e-5 * float(np.abs(w).max()))


@pytest.mark.parametrize("case", list(CASES))
def test_dtensor_decode_matches_the_plain_path(runs, case):
    """Two decode steps from the DTensor prefill state: the logits and the
    final state equal the plain path's from the same state, gathered."""
    _, got = runs
    names = [k[:-len("/dtensor")] for k in got[0]
             if k.startswith(case + "/") and k.endswith("/dtensor")]
    assert f"{case}/steps" in names and f"{case}/state0" in names
    for name in names:
        w = got[0][f"{name}/plain"]
        np.testing.assert_allclose(got[0][f"{name}/dtensor"], w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_holds_the_same_values_and_no_fallback(runs, case):
    _, got = runs
    for r in range(N_RANKS):
        assert int(got[r][f"{case}/fallbacks"]) == 0, r
        for name in got[0]:
            if name.startswith(case + "/"):
                np.testing.assert_array_equal(got[r][name], got[0][name],
                                              err_msg=f"rank {r} {name}")


# ------------------------------------------------------------- routing
@pytest.fixture
def one_rank_mesh():
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import start_fake_world
    start_fake_world(1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("draw", ["empty_experts", "one_expert"])
def test_route_on_dtensors_is_searchsorted_bit_for_bit(one_rank_mesh, draw):
    """``route`` on a DTensor (which has no rule for ``searchsorted``)
    and on plain tensors gives the integers of a route whose offsets are
    ``torch.searchsorted``'s: ``eidx``, ``order``, ``slot``, ``keep``
    equal. Draws: 16 experts, top 2 of 12 tokens whose router favours 3
    of them (the others empty); top 1 with every token on expert 5, at a
    capacity that drops some."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.models import moe
    cfg = _cfg("olmoe", False)
    g = torch.Generator().manual_seed(5)
    if draw == "empty_experts":
        cfg = dataclasses.replace(cfg, n_experts=16, experts_per_token=2,
                                  capacity_factor=1.0)
        router = torch.randn(cfg.d_model, 16, generator=g)
        router[:, [0, 7, 11]] += 40.0
    else:
        cfg = dataclasses.replace(cfg, n_experts=8, experts_per_token=1,
                                  capacity_factor=2.0)
        router = torch.zeros(cfg.d_model, 8)
        router[:, 5] = 1.0
    xt = torch.rand(12, cfg.d_model, generator=g)
    plain = moe.route(cfg, router, xt)
    e, k = cfg.n_experts, cfg.experts_per_token
    se = plain.eidx.reshape(-1)[plain.order]
    starts = torch.searchsorted(se, torch.arange(e))
    pos = torch.arange(se.numel()) - starts[se]
    keep = pos < plain.cap
    slot = torch.where(keep, se * plain.cap + pos,
                       torch.full_like(se, e * plain.cap))
    hit = torch.bincount(se, minlength=e)
    assert (hit == 0).any() if draw == "empty_experts" else \
        (hit == se.numel()).any() and not keep.all()
    assert torch.equal(plain.keep, keep) and torch.equal(plain.slot, slot)

    def lift(t):
        return DTensor.from_local(t, one_rank_mesh, [Replicate()],
                                  run_check=False)

    from repro_torch.models.spec import make_sharder
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.models.spec import mesh_scope
    with mesh_scope(make_sharder(rules_for(False), one_rank_mesh)):
        dt = moe.route(cfg, lift(router), lift(xt))
    assert plain.cap == dt.cap and k == plain.eidx.shape[1]
    for name in ("eidx", "order", "stok", "slot", "keep"):
        got = getattr(dt, name)
        assert isinstance(got, DTensor), name
        assert torch.equal(got.to_local(), getattr(plain, name)), name
    assert torch.equal(dt.sgate.to_local(), plain.sgate)


@pytest.mark.parametrize("before,after", [(3, 0), (0, 5), (2, 1), (0, 0)])
def test_mamba2_pads_as_f_pad(before, after):
    """Mamba2 pads its sequence by a concatenation (torch 2.11's ``F.pad``
    of a DTensor gives shards of the wrong width): ``F.pad``'s values, bit
    for bit, in the activation dtype."""
    from repro_torch.models.mamba2 import _pad_seq
    x = torch.randn(2, 7, 3, 4, generator=torch.Generator().manual_seed(0))
    x = x.to(torch.bfloat16)
    want = torch.nn.functional.pad(x, (0, 0, 0, 0, before, after))
    got = _pad_seq(x, before, after)
    assert got.dtype == x.dtype and torch.equal(got, want)
