"""The port's AdamW and train step against the JAX package's, on the CPU:

- ``adamw_update`` from the same numpy gradients, float32 and bf16
  parameters, int8 moments off and on, steps 1-5, each step starting both
  packages from the JAX state of the step before: float32 parameters and
  moments within rtol 1e-6 (atol 0), bf16 parameters equal or one bf16 ulp
  apart, int8 codes equal in >= 99.9% of entries and never more than 1
  apart, scales within rtol 1e-6. The JAX update runs op by op: under
  ``jax.jit`` XLA contracts ``b1 * m + (1 - b1) * g`` into one fused
  multiply-add, and moments that cancel near 0 then keep a rounding the
  unfused ops do not (up to 1.4e-3 relative). Step 5's gradients bind the
  clip, which scales them by the global norm; the two packages sum its
  squares in different orders, so the norms are held to each other within
  rtol 2e-6, and that step's update is taken with JAX's norm;
- ``lr_at`` over steps 0 ... total + 10 within rtol 1e-6;
- the counterparts of ``tests/test_optimizer.py``'s five tests;
- ``make_train_step`` against ``jax.jit(make_train_step)``: three steps,
  1 and 2 microbatches, losses within rtol 1e-5, parameters after three
  steps within rtol 1e-4, atol 1e-5;
- F6's pins: a plain leaf's update taken a block of rows at a time equals
  the whole leaf's bit for bit (float32 and bf16 parameters, int8 moments
  off and on, a transposed leaf among them), and no temporary of the update
  is larger than a block but the new state and the global norm's squares
  (at qwen2.5-3b's full depth with float32 moments the whole-leaf update's
  temporaries and the new state beside the old did not fit on an 80 GB
  card).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import build as jax_build
from repro.models import init_params as jax_init
from repro.train import optimizer as jax_opt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_reduced
from repro_torch.models import build, params_from_jax
from repro_torch.models.convert import tensor_from_numpy, tree_to_numpy
from repro_torch.models.spec import PSpec, tree_leaves, tree_map
from repro_torch.train import optimizer
from repro_torch.train import (AdamWConfig, adamw_init, adamw_update, lr_at,
                               make_train_step, opt_state_specs)


def _jcfg(cfg):
    return jax_opt.AdamWConfig(**dataclasses.asdict(cfg))


def _to_torch(arr):
    """A numpy leaf (bf16 from JAX included) -> a CPU tensor, same bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return tensor_from_numpy(arr, torch.bfloat16, device="cpu")
    return torch.from_numpy(arr.copy())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol, what):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=what)


def _check_state(got, want, quant, what, rtol=1e-6):
    """got: the port's (params, state); want: JAX's, as numpy."""
    gp, gs = got
    wp, ws = want
    for name, w in wp.items():
        g = gp[name]
        if w.dtype.name == "bfloat16":
            gw = tree_to_numpy(g).astype(np.int32)
            ww = w.view(np.uint16).astype(np.int32)
            assert np.abs(gw - ww).max() <= 1, f"{what} {name}: > 1 ulp"
        else:
            _close(g.numpy(), w, rtol, f"{what} {name}")
    assert int(gs["count"]) == int(ws["count"])
    for mom in ("m", "v"):
        for name, w in ws[mom].items():
            g = gs[mom][name]
            if isinstance(w, dict):
                assert quant and g["q"].dtype == torch.int8
                d = np.abs(g["q"].numpy().astype(np.int32) - w["q"])
                assert d.max() <= 1 and (d == 0).mean() >= 0.999, \
                    f"{what} {mom}/{name} codes"
                np.testing.assert_allclose(g["s"].numpy(), w["s"], rtol=rtol,
                                           err_msg=f"{what} {mom}/{name} s")
            else:
                _close(g.numpy(), w, rtol, f"{what} {mom}/{name}")


@pytest.mark.parametrize("quant", [False, True], ids=["f32-moments", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype, quant, monkeypatch):
    cfg = AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=8,
                      quantized_state=quant)
    rng = np.random.default_rng(7)
    shapes = {"w": (256, 160), "emb": (3, 64, 128), "b": (160,)}
    jdt = getattr(jnp, dtype)
    params = {k: jnp.asarray(rng.normal(size=s), jdt if len(s) > 1 else
                             jnp.float32) for k, s in shapes.items()}
    state = jax_opt.adamw_init(params, _jcfg(cfg))
    for step in range(1, 6):
        # global norms ~0.5 (no clip) on steps 1-4, ~2,600 on step 5
        scale = 50.0 if step == 5 else 0.002
        grads = {k: jnp.asarray(rng.normal(size=s) * scale, p.dtype)
                 for (k, s), p in zip(shapes.items(), params.values())}
        tp, ts, tg = (jax.tree.map(_to_torch, _np(x))
                      for x in (params, state, grads))
        jnorm = np.asarray(jax_opt._global_norm(grads))
        np.testing.assert_allclose(
            float(optimizer._global_norm(tree_leaves(tg))), jnorm, rtol=2e-6)
        if step == 5:
            monkeypatch.setattr(optimizer, "_global_norm",
                                lambda leaves: torch.from_numpy(jnorm.copy()))
        got = adamw_update(tg, ts, tp, cfg)
        params, state = jax_opt.adamw_update(grads, state, params, _jcfg(cfg))
        _check_state(got, (_np(params), _np(state)), quant,
                     f"{dtype} step {step}")
        assert got[0]["w"].dtype == getattr(torch, dtype)
        assert got[0]["b"].dtype == torch.float32


def test_adamw_init_matches_jax():
    for quant in (False, True):
        cfg = AdamWConfig(quantized_state=quant)
        p = {"a": np.ones((4, 6), np.float32), "b": np.ones(6, np.float32)}
        want = _np(jax_opt.adamw_init(p, _jcfg(cfg)))
        got = adamw_init(tree_map(torch.from_numpy, p), cfg)
        for w, g in zip(jax.tree.leaves(want), tree_leaves(got)):
            assert g.dtype == getattr(torch, w.dtype.name)
            np.testing.assert_array_equal(g.numpy(), w)


def test_lr_at_matches_jax():
    cfg = AdamWConfig(peak_lr=3e-3, warmup_steps=7, total_steps=60)
    for step in range(0, cfg.total_steps + 11):
        want = float(jax_opt.lr_at(_jcfg(cfg), jnp.asarray(step, jnp.int32)))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = lr_at(cfg, s)
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                       err_msg=f"step {step}")


# ------------------------------- counterparts of tests/test_optimizer.py
def _quad_grads(p):
    return {"w": 2 * (p["w"] - 3.0), "b": 2 * (p["b"] - 1.0)}


def _run_steps(cfg, steps=300):
    params = {"w": torch.zeros(8, 4), "b": torch.zeros(4)}
    state = adamw_init(params, cfg)
    for _ in range(steps):
        params, state = adamw_update(_quad_grads(params), state, params, cfg)
    return params


def test_adamw_converges():
    cfg = AdamWConfig(peak_lr=0.05, warmup_steps=10, total_steps=300,
                      weight_decay=0.0)
    p = _run_steps(cfg)
    np.testing.assert_allclose(p["w"].numpy(), 3.0, atol=0.05)
    np.testing.assert_allclose(p["b"].numpy(), 1.0, atol=0.05)


def test_quantized_states_track_fp32():
    kw = dict(peak_lr=0.05, warmup_steps=10, total_steps=300,
              weight_decay=0.0)
    p32 = _run_steps(AdamWConfig(**kw))
    p8 = _run_steps(AdamWConfig(**kw, quantized_state=True))
    np.testing.assert_allclose(p8["w"].numpy(), p32["w"].numpy(), atol=0.1)


def test_quantized_state_memory_layout():
    specs = {"w": PSpec((128, 256), torch.bfloat16)}
    os8 = opt_state_specs(specs, AdamWConfig(quantized_state=True))
    assert os8["m"]["w"]["q"].dtype == torch.int8
    assert os8["m"]["w"]["q"].shape == (128, 256)
    assert os8["m"]["w"]["s"].shape == (128, 1)
    assert os8["count"].shape == () and os8["count"].dtype == torch.int32
    plain = opt_state_specs(specs, AdamWConfig())
    assert plain["v"]["w"].dtype == torch.float32


def test_grad_clip_applies():
    cfg = AdamWConfig(peak_lr=0.1, grad_clip=1e-6, warmup_steps=0,
                      total_steps=10, weight_decay=0.0)
    params = {"w": torch.ones(4)}
    state = adamw_init(params, cfg)
    new_p, _ = adamw_update({"w": torch.full((4,), 1e6)}, state, params, cfg)
    assert float((new_p["w"] - params["w"]).abs().max()) < 0.2


def test_lr_schedule_shape():
    cfg = AdamWConfig(peak_lr=1.0, warmup_steps=100, total_steps=1000)
    assert float(lr_at(cfg, 0)) == 0.0
    assert float(lr_at(cfg, 100)) == pytest.approx(1.0)
    assert float(lr_at(cfg, 1000)) == pytest.approx(0.1, abs=0.01)
    assert float(lr_at(cfg, 550)) < 1.0


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    jcfg = dataclasses.replace(jax_reduced("smollm-135m"), n_layers=2,
                               param_dtype="float32")
    cfg = dataclasses.replace(get_reduced("smollm-135m"), n_layers=2,
                              param_dtype="float32")
    opt_cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=6)
    jmodel = jax_build(jcfg)
    jp = jax.jit(lambda k: jax_init(jmodel.param_specs, k))(jax.random.key(2))
    jo = jax_opt.adamw_init(jp, _jcfg(opt_cfg))
    jstep = jax.jit(jax_make_train_step(jmodel, _jcfg(opt_cfg),
                                        microbatches=microbatches))
    params = params_from_jax(cfg, _np(jp), device="cpu")
    opt = adamw_init(params, opt_cfg)
    step = make_train_step(build(cfg), opt_cfg, microbatches=microbatches)
    rng = np.random.default_rng(11)
    for i in range(3):
        toks = rng.integers(1, cfg.vocab, (4, 24)).astype(np.int32)
        jp, jo, jl = jstep(jp, jo, {"tokens": jnp.asarray(toks)})
        params, opt, loss = step(params, opt,
                                 {"tokens": torch.from_numpy(toks)})
        assert loss.dim() == 0
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5,
                                   err_msg=f"step {i} loss")
    assert int(opt["count"]) == 3
    for w, g in zip(jax.tree.leaves(_np(jp)), tree_leaves(params)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5)


# ------------------------------------------------- F6: the update in blocks
def _f6_state(dtype, quant, steps=2):
    """Parameters, float32 gradients and the state after ``steps`` updates
    (so that int8 moments hold codes), seeded."""
    cfg = AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=8,
                      quantized_state=quant)
    g = torch.Generator().manual_seed(3)
    params = {"w": torch.randn(40, 96, generator=g).to(dtype),
              "t": torch.randn(96, 24, generator=g).to(dtype).t(),
              "emb": torch.randn(3, 16, 64, generator=g).to(dtype),
              "b": torch.randn(96, generator=g)}
    state = adamw_init(params, cfg)
    for _ in range(steps):
        grads = {k: torch.randn(p.shape, generator=g) * 1e-3
                 for k, p in params.items()}
        params, state = adamw_update(grads, state, params, cfg)
    grads = {k: torch.randn(p.shape, generator=g) * 1e-3
             for k, p in params.items()}
    return cfg, params, state, grads


@pytest.mark.parametrize("quant", [False, True], ids=["f32-moments", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_update_in_blocks_equals_the_whole_leaf(dtype, quant,
                                                      monkeypatch):
    cfg, params, state, grads = _f6_state(dtype, quant)
    whole = adamw_update(grads, state, params, cfg)
    monkeypatch.setattr(optimizer, "UPDATE_ELEMENTS", 200)  # 1-8 rows
    blocks = adamw_update(grads, state, params, cfg)
    for w, b in zip(tree_leaves(whole), tree_leaves(blocks)):
        assert w.dtype == b.dtype and w.shape == b.shape
        assert torch.equal(w, b)


def test_adamw_update_temporaries_are_one_block(monkeypatch):
    from torch.utils._python_dispatch import TorchDispatchMode
    cfg, params, state, grads = _f6_state(torch.bfloat16, False)
    monkeypatch.setattr(optimizer, "UPDATE_ELEMENTS", 256)
    seen = []

    class Sizes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            aliases = any(r.alias_info for r in func._schema.returns)
            if isinstance(out, torch.Tensor) and not aliases:
                seen.append((func.__name__, out.numel()))
            return out

    with Sizes():
        adamw_update(grads, state, params, cfg)
    block = max(256, 96)  # a block of rows, or one row where it is longer
    big = {name for name, n in seen if n > block}
    # the new state's allocations, and each leaf's square in the norm
    assert big <= {"empty.memory_format", "pow.Tensor_Scalar"}, big
    assert max(n for name, n in seen if name == "_to_copy.default") <= block
