"""The port's checkpoints, gradient compression and elastic helpers
against the JAX package's, on the CPU:

- a port ``save`` and a JAX ``save`` of the same ``{"params", "opt"}``
  (bf16 parameters; plain and int8 moments) give the same file names,
  equal ``manifest.json`` dicts (``treedef`` included) and byte-equal
  ``.npy`` files; each package restores the other's directory bit for
  bit; ``keep_last_k``, ``LATEST`` and ``latest_step`` behave alike;
- a cross-package restart: JAX trains 3 steps and saves, the port
  restores and trains 3 more, and the result equals JAX's uninterrupted 6
  steps within rtol 1e-4;
- top-k compression picks JAX's indices in JAX's order (ties to the lower
  index; fuzzed with many tied magnitudes), int8 codes and scales and the
  error-feedback residuals are bit-equal, ``wire_bytes`` equal;
- the counterparts of ``tests/test_fault.py``'s checkpoint, restart,
  dead-ingestor, work-queue, compression and wire-bytes tests;
- ``elastic_restore`` of one checkpoint onto meshes of 4 and then 2 gloo
  ranks gives each rank the block that JAX's ``elastic_restore`` gives
  the device at the same mesh coordinate (4 fake XLA devices, in a
  subprocess).
"""
import dataclasses
import filecmp
import functools
import json
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

from _hypothesis_compat import given, settings, st
from repro.configs import get_reduced as jax_reduced
from repro.models import build as jax_build
from repro.models import init_params as jax_init
from repro.train import checkpoint as jax_ckpt
from repro.train import compress as jax_compress
from repro.train import elastic as jax_elastic
from repro.train import optimizer as jax_opt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_reduced
from repro_torch.models import build, init_params, params_from_jax
from repro_torch.models.convert import opt_state_from_jax, tree_to_numpy
from repro_torch.models.spec import tree_leaves, tree_map
from repro_torch.train import (AdamWConfig, adamw_init, checkpoint, compress,
                               elastic, make_train_step)


def _jcfg(cfg):
    return jax_opt.AdamWConfig(**dataclasses.asdict(cfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _words(x):
    """numpy of a leaf, bf16 as uint16 words (either package's)."""
    if isinstance(x, torch.Tensor):
        return tree_to_numpy(x)
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


@functools.lru_cache(maxsize=None)
def _state(quant):
    """A trained-once JAX state of the reduced smollm (2 layers, bf16) and
    the port's copy of it."""
    jcfg = dataclasses.replace(jax_reduced("smollm-135m"), n_layers=2)
    cfg = dataclasses.replace(get_reduced("smollm-135m"), n_layers=2)
    opt_cfg = AdamWConfig(quantized_state=quant)
    specs = jax_build(jcfg).param_specs
    jp = jax.jit(lambda k: jax_init(specs, k))(jax.random.key(4))
    rng = np.random.default_rng(4)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape),
                                               p.dtype), jp)
    jp, jo = jax.jit(lambda g, p: jax_opt.adamw_update(
        g, jax_opt.adamw_init(p, _jcfg(opt_cfg)), p, _jcfg(opt_cfg)))(grads,
                                                                       jp)
    jtree = {"params": _np(jp), "opt": _np(jo)}
    ttree = {"params": params_from_jax(cfg, jtree["params"], device="cpu"),
             "opt": opt_state_from_jax(cfg, opt_cfg, jtree["opt"],
                                       device="cpu")}
    return jtree, ttree


@pytest.mark.parametrize("quant", [False, True], ids=["f32-moments", "int8"])
def test_save_matches_jax_layout(tmp_path, quant):
    jtree, ttree = _state(quant)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save(jdir, 7, jtree, extra={"k": 1})
    checkpoint.save(tdir, 7, ttree, extra={"k": 1})
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == \
        ["LATEST", "step_00000007"]
    jd, td = (os.path.join(d, "step_00000007") for d in (jdir, tdir))
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(td))
    with open(os.path.join(jd, "manifest.json")) as f:
        jm = json.load(f)
    with open(os.path.join(td, "manifest.json")) as f:
        tm = json.load(f)
    assert tm == jm
    assert "bfloat16" in jm["dtypes"] and ("int8" in jm["dtypes"]) == quant
    for name in names:
        if name.endswith(".npy"):
            assert filecmp.cmp(os.path.join(jd, name), os.path.join(td, name),
                               shallow=False), name
    for d in (jdir, tdir):
        with open(os.path.join(d, "LATEST")) as f:
            assert f.read() == "step_00000007"


@pytest.mark.parametrize("quant", [False, True], ids=["f32-moments", "int8"])
def test_each_package_restores_the_other(tmp_path, quant):
    jtree, ttree = _state(quant)
    jax_ckpt.save(str(tmp_path / "jax"), 3, jtree)
    checkpoint.save(str(tmp_path / "port"), 3, ttree)
    got, man = checkpoint.restore(str(tmp_path / "jax"), ttree, device="cpu")
    assert man["step"] == 3
    for g, w in zip(tree_leaves(got), tree_leaves(ttree)):
        assert g.dtype == w.dtype and g.device.type == "cpu"
        assert torch.equal(g, w)
    back, man = jax_ckpt.restore(str(tmp_path / "port"), jtree)
    assert man["step"] == 3
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(_words(g), _words(w))


def test_keep_last_k_and_latest_match_jax(tmp_path):
    jtree = {"a": np.zeros((2, 3), np.float32), "c": np.int32(5)}
    ttree = tree_map(lambda x: torch.from_numpy(np.array(x)), jtree)
    for s in (0, 5, 2, 9, 4):
        jax_ckpt.save(str(tmp_path / "jax"), s, jtree, keep_last_k=2)
        checkpoint.save(str(tmp_path / "port"), s, ttree, keep_last_k=2)
        assert sorted(os.listdir(tmp_path / "jax")) == \
            sorted(os.listdir(tmp_path / "port"))
        assert checkpoint.latest_step(str(tmp_path / "port")) == s == \
            jax_ckpt.latest_step(str(tmp_path / "jax"))
    assert sorted(d for d in os.listdir(tmp_path / "port")
                  if d.startswith("step_")) == ["step_00000005",
                                                "step_00000009"]
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), ttree, device="cpu")
    (tmp_path / "port" / "LATEST").write_text("garbage")
    assert checkpoint.latest_step(str(tmp_path / "port")) is None
    assert checkpoint.treedef_str(ttree) == str(jax.tree.structure(jtree))
    nested = {"b": (1, [2, 3]), "a": {"z": (4,), "y": 5}}
    assert checkpoint.treedef_str(nested) == str(jax.tree.structure(nested))


def test_cross_package_restart(tmp_path):
    """JAX trains 3 steps and checkpoints; the port restores and trains 3
    more; its parameters equal JAX's uninterrupted 6 steps (float32)."""
    jcfg = dataclasses.replace(jax_reduced("smollm-135m"), n_layers=2,
                               param_dtype="float32")
    cfg = dataclasses.replace(get_reduced("smollm-135m"), n_layers=2,
                              param_dtype="float32")
    opt_cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jmodel = jax_build(jcfg)
    jstep = jax.jit(jax_make_train_step(jmodel, _jcfg(opt_cfg)))
    rng = np.random.default_rng(0)
    batches = [rng.integers(1, 500, (2, 32)).astype(np.int32)
               for _ in range(6)]
    jp = jax.jit(lambda k: jax_init(jmodel.param_specs, k))(jax.random.key(0))
    jo = jax_opt.adamw_init(jp, _jcfg(opt_cfg))
    for i, b in enumerate(batches):
        jp, jo, _ = jstep(jp, jo, {"tokens": jnp.asarray(b)})
        if i == 2:
            jax_ckpt.save(str(tmp_path), 3, {"params": jp, "opt": jo})
    like = init_params(build(cfg).param_specs,
                       torch.Generator().manual_seed(0))
    state, man = checkpoint.restore(
        str(tmp_path), {"params": like, "opt": adamw_init(like, opt_cfg)},
        device="cpu")
    assert man["step"] == 3 and int(state["opt"]["count"]) == 3
    params, opt = state["params"], state["opt"]
    step = make_train_step(build(cfg), opt_cfg)
    for b in batches[3:]:
        params, opt, _ = step(params, opt, {"tokens": torch.from_numpy(b)})
    for w, g in zip(jax.tree.leaves(_np(jp)), tree_leaves(params)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5)


# -------------------------------- counterparts of tests/test_fault.py
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32)}}
    checkpoint.save(str(tmp_path), 7, tree)
    got, manifest = checkpoint.restore(str(tmp_path), tree, device="cpu")
    assert manifest["step"] == 7
    assert torch.equal(got["a"], tree["a"])
    assert torch.equal(got["b"]["c"], tree["b"]["c"])


def test_checkpoint_keep_last_k(tmp_path):
    tree = {"a": torch.zeros(2)}
    for s in range(5):
        checkpoint.save(str(tmp_path), s, tree, keep_last_k=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]
    assert checkpoint.latest_step(str(tmp_path)) == 4


def test_restart_after_kill_resumes(tmp_path):
    """Train 3 steps, 'crash', restart from disk, resume: the trajectory
    equals an uninterrupted 6-step run (bf16, the reduced config)."""
    model = build(get_reduced("smollm-135m"))
    opt_cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    step = make_train_step(model, opt_cfg)
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.from_numpy(rng.integers(1, 500, (2, 32))
                                           .astype(np.int32))}
               for _ in range(6)]

    def fresh():
        p = init_params(model.param_specs, torch.Generator().manual_seed(0))
        return p, adamw_init(p, opt_cfg)

    ref = fresh()
    for b in batches:
        ref = step(*ref, b)[:2]
    params, opt = fresh()
    for b in batches[:3]:
        params, opt, _ = step(params, opt, b)
    checkpoint.save(str(tmp_path), 3, {"params": params, "opt": opt})
    del params, opt  # "crash"
    state, _ = checkpoint.restore(str(tmp_path),
                                  {"params": ref[0], "opt": ref[1]},
                                  device="cpu")
    params, opt = state["params"], state["opt"]
    for b in batches[3:]:
        params, opt, _ = step(params, opt, b)
    for got, want in zip(tree_leaves(params), tree_leaves(ref[0])):
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-5,
                                   atol=1e-5)


def test_dead_ingestor_rerouting():
    sp = np.asarray([100, 200, 300], np.int32)  # 4 shards
    for dead in range(4):
        new_sp = elastic.reassign_dead_ingestor(sp, dead)
        np.testing.assert_array_equal(
            new_sp, jax_elastic.reassign_dead_ingestor(sp, dead))
        assert len(new_sp) == 2
        keys = np.arange(0, 400, 7, dtype=np.int32)
        owners = np.searchsorted(new_sp, keys, side="right")
        assert owners.max() < 3 and owners.min() >= 0


def test_work_stealing_survives_dead_worker():
    q = elastic.WorkQueue(list(range(10)), timeout_batches=3)
    j = jax_elastic.WorkQueue(list(range(10)), timeout_batches=3)
    bid0, _ = q.claim(0)
    assert j.claim(0)[0] == bid0
    while not q.complete():
        for w in (1, 2):
            bid, _ = q.claim(w)
            assert j.claim(w)[0] == bid  # the same schedule
            if bid is not None:
                q.ack(bid)
                j.ack(bid)
        if q.clock > 200:
            raise AssertionError("queue did not drain")
    assert bid0 in q.done and j.complete()


ELASTIC_JAX = r'''
import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import numpy as np
from repro.compat import make_mesh_auto
from repro.configs import get_reduced
from repro.models import build
from repro.models.spec import ShardingRules
from repro.train import elastic

specs = build(get_reduced("smollm-135m")).param_specs
rules = ShardingRules(batch=("data",), model="model", fsdp="data")
out = {}
for shape in ((2, 2), (1, 2)):
    n = shape[0] * shape[1]
    mesh = make_mesh_auto(shape, ("data", "model"), devices=jax.devices()[:n])
    tree, _ = elastic.elastic_restore(sys.argv[1], specs, mesh, rules)
    for i, leaf in enumerate(jax.tree.leaves(tree)):
        for sh in leaf.addressable_shards:
            d, m = np.argwhere(mesh.devices == sh.device)[0]
            out[f"{n}/{i}/{d}{m}"] = np.asarray(sh.data.astype(jnp.float32))
np.savez(sys.argv[2], **out)
'''


def _elastic_rank(rank, world, rdv, ckpt, out_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import ShardingRules
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (world // 2, 2),
                                mesh_dim_names=("data", "model"))
        specs = build(get_reduced("smollm-135m")).param_specs
        rules = ShardingRules(batch=("data",), model="model", fsdp="data")
        tree, _ = elastic.elastic_restore(ckpt, specs, mesh, rules)
        d, m = mesh.get_coordinate()
        mine = {f"{world}/{i}/{d}{m}": t.to_local().float().numpy()
                for i, t in enumerate(tree_leaves(tree))}
        got = [None] * world if rank == 0 else None
        dist.gather_object(mine, got, dst=0)
        if rank == 0:
            np.savez(out_path, **{k: v for g in got for k, v in g.items()})
    finally:
        dist.destroy_process_group()


def _spawn(fn, args, n_ranks, timeout=120):
    """Spawn ``n_ranks`` ranks of ``fn(rank, *args)``, joined under
    ``timeout`` seconds (a hung collective fails the test)."""
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


def test_elastic_restore_waits_for_the_mesh_item(tmp_path):
    """``elastic_restore`` onto 4 gloo ranks (2, 2) and then 2 (1, 2):
    each rank's DTensor block equals JAX's shard at its coordinate."""
    params = init_params(build(get_reduced("smollm-135m")).param_specs,
                         torch.Generator().manual_seed(5), device="cpu")
    ckpt = str(tmp_path / "ckpt")
    checkpoint.save(ckpt, 3, params)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(
        Path(__file__).resolve().parents[1] / "src"))
    env.pop("XLA_FLAGS", None)
    jax_out = tmp_path / "jax.npz"
    res = subprocess.run([sys.executable, "-c", ELASTIC_JAX, ckpt,
                          str(jax_out)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want = dict(np.load(jax_out))
    got = {}
    for world in (4, 2):
        out = tmp_path / f"port{world}.npz"
        _spawn(_elastic_rank, (world, str(tmp_path / f"rdv{world}"), ckpt,
                               str(out)), world)
        got.update(dict(np.load(out)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compress_roundtrip_bounded_error(scheme):
    g = torch.from_numpy(np.random.default_rng(2).normal(size=(300, 70))
                         .astype(np.float32))
    if scheme == "int8":
        payload, shape, n = compress.int8_compress(g)
        d = compress.int8_decompress(payload, shape, n)
        assert float((d - g).abs().max()) <= float(g.abs().max()) / 100
    else:
        payload, shape, n = compress.topk_compress(g, 0.1)
        d = compress.topk_decompress(payload, shape, n)
        assert int((d != 0).sum()) == int(g.numel() * 0.1)


def test_error_feedback_converges():
    target = torch.ones(3)
    cfg = compress.CompressConfig(scheme="topk", topk_frac=0.34)
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    residual = compress.zero_residual(params)
    for _ in range(200):
        grads = {"w": 2 * (params["w"] - target)}
        cg, residual = compress.compress_with_feedback(grads, residual, cfg)
        params = {"w": params["w"] - 0.05 * cg["w"]}
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)


def test_wire_bytes_accounting():
    g = {"a": torch.zeros(1000, 100), "b": torch.zeros(7, 3)}
    jg = {"a": jnp.zeros((1000, 100)), "b": jnp.zeros((7, 3))}
    for cfg in (compress.CompressConfig(scheme="int8"),
                compress.CompressConfig(scheme="topk", topk_frac=0.05),
                compress.CompressConfig(scheme="none")):
        jc = jax_compress.CompressConfig(**dataclasses.asdict(cfg))
        assert compress.wire_bytes(g, cfg) == jax_compress.wire_bytes(jg, jc)
    raw, comp = compress.wire_bytes(g, compress.CompressConfig(scheme="int8"))
    assert raw == 400_084 and comp < raw / 3.5


# ------------------------------------------------- compression against JAX
def _tied(rng, n, levels):
    """n float32 values over a few magnitudes, both signs: many ties."""
    mags = rng.integers(0, levels, n).astype(np.float32) * 0.25
    return (mags * rng.choice([-1.0, 1.0], n)).astype(np.float32)


def _check_topk(x, frac):
    (idx, sel), shape, n = compress.topk_compress(torch.from_numpy(x), frac)
    (jidx, jsel), jshape, jn = jax_compress.topk_compress(jnp.asarray(x),
                                                          frac)
    assert idx.dtype == torch.int32 and (shape, n) == (tuple(jshape), jn)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))


@pytest.mark.parametrize("seed", range(2))
def test_topk_ties_match_jax(seed):
    rng = np.random.default_rng(seed)
    for n, levels, frac in ((1000, 3, 0.1), (513, 8, 0.5), (64, 1, 0.25),
                            (4096, 40, 0.01)):
        x = _tied(rng, n, levels).reshape(-1, 1) if n % 2 else \
            _tied(rng, n, levels).reshape(2, -1)
        _check_topk(x, frac)


@settings(max_examples=15, deadline=None)
@given(st.lists(st.integers(-4, 4), min_size=1, max_size=200),
       st.sampled_from([0.01, 0.1, 0.3, 0.9]))
def test_topk_ties_match_jax_fuzz(vals, frac):
    _check_topk(np.asarray(vals, np.float32) * 0.5, frac)


@pytest.mark.parametrize("block", [256, 64])
def test_int8_compress_matches_jax_bit_for_bit(block):
    rng = np.random.default_rng(block)
    x = (rng.normal(size=(37, 50)) * rng.uniform(0.01, 10, (37, 1))).astype(
        np.float32)
    x[3, :] = 0.0                          # an all-zero block
    (q, s), shape, n = compress.int8_compress(torch.from_numpy(x), block)
    (jq, js), jshape, jn = jax_compress.int8_compress(jnp.asarray(x), block)
    assert q.dtype == torch.int8 and (shape, n) == (tuple(jshape), jn)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        compress.int8_decompress((q, s), shape, n).numpy(),
        np.asarray(jax_compress.int8_decompress((jq, js), jshape, jn)))


@pytest.mark.parametrize("scheme", ["int8", "topk", "none"])
def test_error_feedback_matches_jax(scheme):
    """Eager JAX, as ``compress_with_feedback`` runs outside a jitted step
    (under ``jax.jit`` XLA may fuse the scale and the decode and round
    them otherwise)."""
    cfg = compress.CompressConfig(scheme=scheme, topk_frac=0.05, block=128)
    jc = jax_compress.CompressConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(8)
    shapes = {"w": (40, 30), "b": (30,), "e": {"x": (3, 7, 11)}}
    res = jres = None
    for _ in range(3):
        grads = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                             shapes, is_leaf=lambda s: isinstance(s, tuple))
        tg = tree_map(torch.from_numpy, grads)
        if res is None:
            res, jres = compress.zero_residual(tg), jax_compress.zero_residual(
                jax.tree.map(jnp.asarray, grads))
        got, res = compress.compress_with_feedback(tg, res, cfg)
        want, jres = jax_compress.compress_with_feedback(
            jax.tree.map(jnp.asarray, grads), jres, jc)
        for a, b in zip(tree_leaves(got) + tree_leaves(res),
                        jax.tree.leaves(want) + jax.tree.leaves(jres)):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
