"""The port's expert-parallel MoE layer (``models.moe.apply_moe_spmd``) and
its int8 FSDP weight gather (``gather_w_int8``) against the JAX package's
``_apply_moe_spmd`` / ``gather_w_int8`` on the same numpy inputs: the
reduced olmoe-1b-7b in float32 on a (2, 2) ("data", "model") mesh, with
``moe_gather`` "bf16" and "int8" (fsdp on "data"), and the reduced
kimi-k2-1t-a32b (one shared expert, which runs on the full x beside the
expert-parallel part) with "bf16". Not kimi with "int8": on its draw
XLA's compiled quantiser puts one w_gate code a step away from JAX's own
eager quantiser (the quotient -59.499996, which the port and eager JAX
round to -59), so that case would compare against a compiler rewrite.

* The JAX side runs once, in a subprocess with 4 fake XLA host devices:
  y, aux and the gradients of ``sum(y * gy) + ga * aux`` against x and
  every parameter; the int8 codes and scales of each rank's weight block;
  the gathered weights.
* The port side runs once on 4 gloo ranks (``torch.multiprocessing``
  spawn, ``file://`` rendezvous, joined under a timeout), each holding
  the full inputs: y and every gradient come back whole on every rank.
  Then the same step on DTensors placed as ``sharding_tree`` places them
  (the dry run's mode), whose gradients' full tensors are compared.
* y, aux and the gradients within rtol 1e-5 (atol 1e-6 for entries near
  zero); codes and scales exactly, and the gathered weights exactly equal
  to the JAX codes times their scales (XLA's compiled gather rounds a
  float32 product an ulp off in ~1.5% of entries: within rtol 1e-6 of it).
* With ``capacity_factor = n_experts / experts_per_token`` no token drops
  and the port's expert-parallel y equals its local path's.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("router", "w_gate", "w_up", "w_down")
SHARED = ("shared.w_down", "shared.w_gate", "shared.w_up")
ARCHS = ("olmoe-1b-7b", "kimi-k2-1t-a32b")
GATHERS = ("bf16", "int8")
# (arch, moe_gather) cases of the layer; kimi's is about its shared expert,
# which does not depend on the gather's wire format
CASES = (("olmoe-1b-7b", "bf16"), ("olmoe-1b-7b", "int8"),
         ("kimi-k2-1t-a32b", "bf16"))
B, S = 4, 8
JOIN_S = 120
TOL = dict(rtol=1e-5, atol=1e-6)

JAX_SCRIPT = r'''
import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax
import jax.numpy as jnp
import numpy as np

from repro.compat import SHARD_MAP_KW, make_mesh_auto, shard_map
from repro.configs import get_reduced
from repro.models import moe
from repro.models.spec import ShardingRules, make_sharder

P = jax.sharding.PartitionSpec
inp = dict(np.load(sys.argv[1]))
mesh = make_mesh_auto((2, 2), ("data", "model"), devices=jax.devices())
x, gy, ga = jnp.asarray(inp["x"]), jnp.asarray(inp["gy"]), float(inp["ga"])
out = {}
for arch, gathers in (("olmoe-1b-7b", ("bf16", "int8")),
                      ("kimi-k2-1t-a32b", ("bf16",))):
    cfg = dataclasses.replace(get_reduced(arch), param_dtype="float32")
    p = {}
    for key, v in inp.items():
        if key.startswith(arch + "/"):
            *outer, leaf = key[len(arch) + 1:].split(".")
            d = p
            for k in outer:
                d = d.setdefault(k, {})
            d[leaf] = jnp.asarray(v)
    for g in gathers:
        rules = ShardingRules(batch=("data",), model="model", fsdp="data",
                              expert="model", moe_gather=g)
        sh = make_sharder(rules, mesh)

        def loss(x, p):
            y, aux = moe._apply_moe_spmd(cfg, p, x, sh, rules, mesh)
            return jnp.sum(y * gy) + ga * aux, (y, aux)

        with mesh:
            (_, (y, aux)), (gx, gp) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(x, p)
        pre = f"{arch}/{g}/"
        out[pre + "y"], out[pre + "aux"] = np.asarray(y), np.asarray(aux)
        out[pre + "x"] = np.asarray(gx)
        for k, v in gp.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    out[pre + k + "." + kk] = np.asarray(vv)
            else:
                out[pre + k] = np.asarray(v)

cfg = dataclasses.replace(get_reduced("olmoe-1b-7b"), param_dtype="float32")

for dt in ("float32", "bfloat16"):
    w = jnp.asarray(inp["olmoe-1b-7b/w_gate"]).astype(dt)
    fn = shard_map(lambda wl: moe.gather_w_int8(wl, "data", 1), mesh=mesh,
                   in_specs=(P("model", "data", None),),
                   out_specs=P("model", None, None), **SHARD_MAP_KW)
    with mesh:
        out["gathered/" + dt] = np.asarray(jax.jit(fn)(w).astype(jnp.float32))
    e, d = w.shape[0] // 2, w.shape[1] // 2
    for m in range(2):
        for r in range(2):
            wf = w[m * e:(m + 1) * e, r * d:(r + 1) * d].astype(jnp.float32)
            scale = jnp.max(jnp.abs(wf), axis=1, keepdims=True) / 127.0 \
                + 1e-12
            q = jnp.clip(jnp.round(wf / scale), -127, 127).astype(jnp.int8)
            out[f"codes/{dt}/{r}{m}"] = np.asarray(q)
            out[f"scales/{dt}/{r}{m}"] = np.asarray(scale)
np.savez(sys.argv[2], **out)
'''


def _cfg(arch="olmoe-1b-7b", **kw):
    from repro_torch.configs import get_reduced
    return dataclasses.replace(get_reduced(arch), param_dtype="float32",
                               **kw)


def _names(arch):
    return NAMES + (SHARED if _cfg(arch).n_shared_experts else ())


def _nest(flat):
    """{"shared.w_up": t, ...} -> {"shared": {"w_up": t}, ...}"""
    out = {}
    for k, v in flat.items():
        *outer, leaf = k.split(".")
        d = out
        for o in outer:
            d = d.setdefault(o, {})
        d[leaf] = v
    return out


def _flat(tree, pre=""):
    """{"shared": {"w_up": t}, ...} -> {"shared.w_up": t, ...}"""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        else:
            out[pre + k] = v
    return out


def _inputs(seed=0):
    from repro_torch.models import init_params, moe
    out = {}
    for i, arch in enumerate(ARCHS):
        p = init_params(moe.moe_specs(_cfg(arch)),
                        torch.Generator().manual_seed(seed + i))
        for k in _names(arch):
            leaf = p
            for part in k.split("."):
                leaf = leaf[part]
            out[f"{arch}/{k}"] = leaf.numpy()
    rng = np.random.default_rng(seed)
    cfg = _cfg()
    out["x"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    out["gy"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    out["ga"] = np.float32(0.7)
    return out


def _rank_main(rank, rdv, inputs, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=4, rank=rank)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.models import ShardingRules, make_sharder, moe
        from repro_torch.models.spec import (local_block, placements,
                                             sharding_tree)
        from torch.distributed.tensor import Replicate, distribute_tensor
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        inp = dict(np.load(inputs))
        gy, ga = torch.from_numpy(inp["gy"]), float(inp["ga"])
        mine = {}
        for arch, g in CASES:
            rules = ShardingRules(batch=("data",), model="model",
                                  fsdp="data", expert="model", moe_gather=g)
            x = torch.from_numpy(inp["x"]).requires_grad_()
            flat = {k: torch.from_numpy(inp[f"{arch}/{k}"]).requires_grad_()
                    for k in _names(arch)}
            y, aux = moe.apply_moe(_cfg(arch), _nest(flat), x,
                                   make_sharder(rules, mesh))
            ((y * gy).sum() + ga * aux).backward()
            pre = f"{arch}/{g}/"
            mine[pre + "y"], mine[pre + "aux"] = y.detach(), aux.detach()
            for k, t in [("x", x)] + list(flat.items()):
                mine[pre + k] = t.grad
            # the same step on DTensors placed as sharding_tree places them
            pls = _flat(sharding_tree(moe.moe_specs(_cfg(arch)), rules,
                                      mesh))
            xd = distribute_tensor(x.detach(), mesh, placements(
                (("data",), "model", None), mesh)).requires_grad_()
            fd = {k: distribute_tensor(t.detach(), mesh,
                                       pls[k]).requires_grad_()
                  for k, t in flat.items()}
            y, aux = moe.apply_moe(_cfg(arch), _nest(fd), xd,
                                   make_sharder(rules, mesh))
            ((y * distribute_tensor(gy, mesh, [Replicate()] * 2)).sum()
             + ga * aux).backward()
            pre = f"dtensor/{arch}/{g}/"
            mine[pre + "y"] = y.detach().full_tensor()
            mine[pre + "aux"] = aux.detach().full_tensor()
            for k, t in [("x", xd)] + list(fd.items()):
                mine[pre + k] = t.grad.full_tensor()
        fsdp = mesh.get_group("data")
        pl = placements(("model", "data", None), mesh)
        for dt in (torch.float32, torch.bfloat16):
            w = local_block(torch.from_numpy(
                inp["olmoe-1b-7b/w_gate"]).to(dt), pl, mesh)
            q, s = moe._int8_codes(w, 1)
            name = str(dt).split(".")[1]
            mine["codes/" + name] = q
            mine["scales/" + name] = s
            mine["gathered/" + name] = moe.gather_w_int8(w, fsdp, 1).float()
        # no drops: the expert-parallel y equals the local path's
        wide = _cfg(capacity_factor=8 / 2)
        rules = ShardingRules(batch=("data",), fsdp="data")
        x = torch.from_numpy(inp["x"])
        p = {k: torch.from_numpy(inp["olmoe-1b-7b/" + k]) for k in NAMES}
        mine["nodrop/spmd"] = moe.apply_moe(wide, p, x,
                                            make_sharder(rules, mesh))[0]
        mine["nodrop/local"] = moe.apply_moe(wide, p, x)[0]
        mine = {k: v.numpy() for k, v in mine.items()}
        got = [None] * 4 if rank == 0 else None
        dist.gather_object((mine, mesh.get_coordinate()), got, dst=0)
        if rank == 0:
            flat = {}
            for r, (arrs, coord) in enumerate(got):
                for k, v in arrs.items():
                    flat[f"{r}/{k}"] = v
                flat[f"{r}/coord"] = np.asarray(coord)
            np.savez(out_path, **flat)
    finally:
        dist.destroy_process_group()


def _spawn(fn, args, n_ranks, timeout=JOIN_S):
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
    d = tmp_path_factory.mktemp("moe_spmd")
    inputs = d / "inputs.npz"
    np.savez(inputs, **_inputs())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    jax_out = d / "jax.npz"
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(inputs),
                          str(jax_out)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    port_out = d / "port.npz"
    _spawn(_rank_main, (str(d / "rdv"), str(inputs), str(port_out)), 4)
    return dict(np.load(jax_out)), dict(np.load(port_out))


def _check_spmd(runs, key):
    jx, port = runs
    for r in range(4):  # y and every gradient whole on every rank
        np.testing.assert_allclose(port[f"{r}/{key}"], jx[key], **TOL,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("what", ["y", "aux", "x"] + list(NAMES))
@pytest.mark.parametrize("gather", GATHERS)
def test_spmd_moe_matches_jax(runs, gather, what):
    _check_spmd(runs, f"olmoe-1b-7b/{gather}/{what}")


@pytest.mark.parametrize("what", ["y", "aux", "x"] + list(NAMES + SHARED))
def test_spmd_moe_with_shared_expert_matches_jax(runs, what):
    _check_spmd(runs, f"kimi-k2-1t-a32b/bf16/{what}")


@pytest.mark.parametrize("arch,gather,what", [
    (a, g, w) for a, g in CASES for w in ("y", "aux", "x") + _names(a)])
def test_spmd_moe_on_dtensors_matches_jax(runs, arch, gather, what):
    """The same step on DTensors (the dry run's mode): y and the full
    gradients, whose local parts the layer marks ``Partial`` over the
    token axes, equal JAX's."""
    jx, port = runs
    key = f"{arch}/{gather}/{what}"
    for r in range(4):
        np.testing.assert_allclose(port[f"{r}/dtensor/{key}"], jx[key], **TOL,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_w_int8_codes_scales_and_gather_exact(runs, dtype):
    jx, port = runs
    for r in range(4):
        d, m = (int(c) for c in port[f"{r}/coord"])
        np.testing.assert_array_equal(port[f"{r}/codes/{dtype}"],
                                      jx[f"codes/{dtype}/{d}{m}"])
        np.testing.assert_array_equal(port[f"{r}/scales/{dtype}"],
                                      jx[f"scales/{dtype}/{d}{m}"])
        want = np.concatenate(
            [jx[f"codes/{dtype}/{k}{m}"].astype(np.float32)
             * jx[f"scales/{dtype}/{k}{m}"] for k in range(2)], axis=1)
        if dtype == "bfloat16":  # the gather returns the weights' dtype
            want = torch.from_numpy(want).bfloat16().float().numpy()
        np.testing.assert_array_equal(port[f"{r}/gathered/{dtype}"], want)
        e = jx[f"gathered/{dtype}"].shape[0] // 2
        np.testing.assert_allclose(port[f"{r}/gathered/{dtype}"],
                                   jx[f"gathered/{dtype}"][m * e:(m + 1) * e],
                                   rtol=1e-6, atol=0)


def test_gather_w_int8_plain_version():
    from repro_torch.models import moe
    w = torch.randn(4, 6, 5, generator=torch.Generator().manual_seed(3))
    shards = list(w.chunk(3, dim=1))
    q = [moe._int8_codes(s, 1) for s in shards]
    want = torch.cat([qq.float() * ss for qq, ss in q], dim=1)
    assert torch.equal(moe.gather_w_int8_ref(shards, 1), want)


def test_expert_parallel_without_drops_equals_local(runs):
    _, port = runs
    for r in range(4):
        np.testing.assert_allclose(port[f"{r}/nodrop/spmd"],
                                   port[f"{r}/nodrop/local"],
                                   rtol=1e-5, atol=1e-6)
