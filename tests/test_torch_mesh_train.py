"""A whole-model DTensor train step on real ranks in the MoE, SSM, hybrid
and VLM families, against the JAX package's own step on the same weights.

Four gloo ranks (spawned, ``file://`` rendezvous, joined under a timeout)
on a (1, 4) ("data", "model") mesh (olmoe-1b-7b also on a (2, 2) one)
with the dry run's production rules (``dryrun.rules_for(False)``): the
parameters and the batch are DTensors placed by ``sharding_tree``
(zamba2-2.7b also with the batch a plain tensor, the same on every rank),
and ``train_step.loss_and_grads`` runs as a user calls it, with no
``ReshardOnRefusal``. Reduced configs, float32, 2 layers (zamba2-2.7b:
one group of two Mamba2 layers and the shared attention); MoE at
``capacity_factor = n_experts / experts_per_token``, so that the
expert-parallel dispatch drops no token.

The references:

* MoE (olmoe-1b-7b, kimi-k2-1t-a32b): JAX's ``train_loss`` under
  ``make_sharder(rules_for(False), mesh)`` on a mesh of 4 fake XLA host
  devices of the same shape, in a subprocess. On a mesh JAX's MoE layer
  is ``_apply_moe_spmd``, whose aux loss is the mean of the shards'
  (a mean of products, not the product of the means), so the mesh step's
  router gradient is not the unsharded step's: the unsharded step is no
  reference for it. The port's ``apply_moe_spmd`` takes the same mean.
* mamba2-2.7b, zamba2-2.7b, internvl2-26b: JAX's ``train_loss`` with the
  identity hook, in this process. These families have no ``shard_map``,
  so a mesh does not change JAX's function.

The weights and the batch are numpy draws from a seed (each normal leaf
at std 0.02), carried across by ``params_from_jax``. Held: the loss and
every gradient leaf within rtol 1e-5 (atol 1e-5 of the leaf's largest
entry), every rank the same values, no sharder fallback on any rank.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_reduced as jax_reduced
from repro.models import build as jax_build

ROOT = Path(__file__).resolve().parents[1]
N_RANKS, B, S, LAYERS = 4, 4, 24, 2
JOIN_S = 120
# case -> (arch, mesh shape ("data", "model"), the batch as DTensors)
CASES = {"olmoe": ("olmoe-1b-7b", (1, 4), True),
         "olmoe_2x2": ("olmoe-1b-7b", (2, 2), True),
         "kimi": ("kimi-k2-1t-a32b", (1, 4), True),
         "mamba2": ("mamba2-2.7b", (1, 4), True),
         "zamba2": ("zamba2-2.7b", (1, 4), True),
         "internvl2": ("internvl2-26b", (1, 4), True),
         # the batch plain, the same on every rank
         "zamba2_plain_batch": ("zamba2-2.7b", (1, 4), False)}
MOE = [c for c, (arch, _, _) in CASES.items() if arch in
       ("olmoe-1b-7b", "kimi-k2-1t-a32b")]

JAX_MESH_SCRIPT = r'''
import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

devices = jax.devices()[:4]  # before the dry run's import asks for 512
from repro.configs import get_reduced
from repro.launch.dryrun import rules_for
from repro.models import build
from repro.models.spec import make_sharder

d, out = sys.argv[1], {}
for case, arch, shape in (a.split(":") for a in sys.argv[2:]):
    shape = tuple(int(n) for n in shape.split("x"))
    base = get_reduced(arch)
    cfg = dataclasses.replace(
        base, param_dtype="float32", n_layers=%(layers)d,
        capacity_factor=base.n_experts / base.experts_per_token)
    model = build(cfg)
    mesh = Mesh(np.array(devices).reshape(shape), ("data", "model"))
    sh = make_sharder(rules_for(False), mesh)
    flat = dict(np.load(os.path.join(d, case + "_params.npz")))
    params = {}
    for name, x in flat.items():
        *path, last = name.split("/")
        node = params
        for k in path:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(x)
    batch = {k: jnp.asarray(x) for k, x in
             np.load(os.path.join(d, case + "_batch.npz")).items()}
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: model.train_loss(p, batch, sh)))(params)
    out[case + "/loss"] = np.asarray(loss)
    stack = [(case + "/grad", grads)]
    while stack:
        name, g = stack.pop()
        if isinstance(g, dict):
            stack += [(name + "/" + k, v) for k, v in g.items()]
        else:
            out[name] = np.asarray(g)
np.savez(os.path.join(d, "jax_mesh.npz"), **out)
''' % {"layers": LAYERS}


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
    """The train batch in JAX's input names: an image prefix takes its
    ``n_img_tokens`` of the ``S`` positions."""
    cfg = _cfg(case, True)
    rng = np.random.default_rng(seed)
    n = cfg.n_img_tokens if cfg.family == "vlm" else 0
    out = {"tokens": rng.integers(1, cfg.vocab, (B, S - n)).astype(np.int32)}
    if cfg.family == "vlm":
        out["img_embeds"] = (rng.normal(size=(B, n, cfg.d_model))
                             * 0.02).astype(np.float32)
    return out


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


def _rank_body(rank, d):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.launch import dryrun
    from repro_torch.models import (build, make_sharder, params_from_jax,
                                    sharding_tree)
    from repro_torch.models.spec import flatten_up_to, tree_map
    from repro_torch.train.train_step import loss_and_grads
    meshes = {shape: init_device_mesh("cpu", shape,
                                      mesh_dim_names=("data", "model"))
              for shape in sorted({c[1] for c in CASES.values()})}
    rules = dryrun.rules_for(False)

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

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
        bpl = sharding_tree(model.train_input_specs(B, S), rules, mesh)
        batch = {k: distribute_tensor(torch.from_numpy(x), mesh,
                                      list(bpl[k])) if placed
                 else torch.from_numpy(x) for k, x in batch_np.items()}
        loss, grads = loss_and_grads(model, dparams, batch, "dots_no_batch",
                                     sh)
        mine[f"{case}/loss"] = whole(loss).numpy()
        for name, g in _flat(grads).items():
            assert isinstance(g, DTensor), name
            mine[f"{case}/grad/{name}"] = g.full_tensor().numpy()
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
    d = tmp_path_factory.mktemp("mesh_train")
    jax_side = {}
    for i, case in enumerate(CASES):
        model = jax_build(_cfg(case, True))
        params = _params(model.param_specs, i)
        batch = _batch(case, 100 + i)
        np.savez(d / f"{case}_params.npz", **_flat(params))
        np.savez(d / f"{case}_batch.npz", **batch)
        jax_side[case] = (model, params, batch)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    mesh_job = subprocess.Popen(
        [sys.executable, "-c", JAX_MESH_SCRIPT, str(d)]
        + [f"{c}:{CASES[c][0]}:{'x'.join(map(str, CASES[c][1]))}"
           for c in MOE], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ctx, deadline = _spawn(_rank_main, (str(d / "rdv"), str(d)), N_RANKS)
    want = {}
    try:  # the JAX side while the ranks run
        for case, (model, params, batch) in jax_side.items():
            # the MoE cases' unsharded step is kept apart: no reference
            key = f"unsharded/{case}" if case in MOE else case
            jb = {k: jnp.asarray(x) for k, x in batch.items()}
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, m=model: m.train_loss(p, jb, lambda x, *a: x)))(
                    params)
            want[f"{key}/loss"] = np.asarray(loss)
            for name, g in _flat(grads).items():
                want[f"{key}/grad/{name}"] = np.asarray(g)
        _, err = mesh_job.communicate(timeout=JOIN_S)
        assert mesh_job.returncode == 0, err[-3000:]
        want.update(np.load(d / "jax_mesh.npz"))
    finally:
        if mesh_job.poll() is None:
            mesh_job.kill()
        _join(ctx, deadline)
    got = [dict(np.load(d / f"rank{r}.npz")) for r in range(N_RANKS)]
    return want, got


# ----------------------------------------------------------------- tests
@pytest.mark.parametrize("case", list(CASES))
def test_dtensor_step_matches_jax(runs, case):
    """The loss and every gradient leaf: the MoE cases against JAX's step
    on a mesh of the same shape, the others against JAX's ``train_loss``
    (a mesh does not change it there)."""
    want, got = runs
    names = [k for k in want if k.startswith(case + "/")]
    n_leaves = len([k for k in got[0] if k.startswith(case + "/grad/")])
    assert len(names) == n_leaves + 1 and all(k in got[0] for k in names)
    for name in names:
        w = want[name]
        atol = 1e-5 * float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(got[0][name], w, rtol=1e-5, atol=atol,
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


@pytest.mark.parametrize("case", MOE)
def test_moe_mesh_step_is_not_the_unsharded_step(runs, case):
    """On a mesh the MoE aux loss is the mean of the shards' (JAX's
    ``_apply_moe_spmd``, and the port's), so the router gradient moves
    off the unsharded step's by a thousand times the tolerance: the
    unsharded step is no reference for a mesh step."""
    want, got = runs
    name = "grad/blocks/moe/router"
    plain = want[f"unsharded/{case}/{name}"]
    rel = float(np.abs(got[0][f"{case}/{name}"] - plain).max()
                / np.abs(plain).max())
    assert rel > 1e-2, rel
