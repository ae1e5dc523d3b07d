"""The port's hybrid family (zamba2-2.7b reduced: 2 groups of 2 Mamba2
layers, each group ending in the shared attention + MLP block) against the
JAX package on the CPU, in float32, weights from the JAX init carried by
``params_from_jax``: prefill logits and the state tree ``((ssm, conv), (k,
v))`` (shapes and values), three decode steps continuing from it, and
``train_loss`` with every leaf's gradient, within 1e-4 (gradients rtol
1e-4, atol 1e-6)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import build as jax_build
from repro.models import init_params as jax_init
from repro.models import hybrid as jax_hy
from repro_torch.configs import get_reduced
from repro_torch.models import build, hybrid, params_from_jax
from repro_torch.models.spec import tree_leaves
from repro_torch.train.train_step import loss_and_grads

SH = lambda x, *a: x  # noqa: E731  (the JAX identity sharder)
ARCH = "zamba2-2.7b"
B, S, STEPS = 2, 19, 3
TOL = 1e-4


def _cfgs():
    return (dataclasses.replace(jax_reduced(ARCH), param_dtype="float32"),
            dataclasses.replace(get_reduced(ARCH), param_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _jax_params():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jax_init(jax_build(jcfg).param_specs,
                                             jax.random.key(0)))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL, err_msg=what)


def _tokens(cfg, s, seed=3):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (B, s)).astype(
        np.int32)


def _flat_states(states):
    (ssm, conv), (ck, cv) = states
    return {"ssm": ssm, "conv": conv, "k": ck, "v": cv}


def test_hybrid_prefill_and_decode_match_jax():
    jcfg, cfg = _cfgs()
    jp = _jax_params()
    tp = params_from_jax(cfg, jp, device="cpu")
    max_len = S + STEPS
    toks = _tokens(cfg, S)
    jl, jst = jax.jit(lambda p, t: jax_hy.prefill(jcfg, p, t, SH, max_len))(
        jp, jnp.asarray(toks))
    model = build(cfg)
    tl, tst = model.prefill(tp, {"tokens": torch.from_numpy(toks),
                                 "max_len": max_len})
    g, per = cfg.n_layers // cfg.shared_attn_every, cfg.shared_attn_every
    di, n = cfg.d_inner, cfg.ssm_state
    shapes = {"ssm": (g, per, B, cfg.ssm_heads, cfg.ssm_headdim, n),
              "conv": (g, per, B, cfg.ssm_conv - 1, di + 2 * n),
              "k": (g, B, max_len, cfg.n_kv_heads, cfg.hd),
              "v": (g, B, max_len, cfg.n_kv_heads, cfg.hd)}
    assert tl.shape == (B, 1, cfg.vocab_padded)
    _close(tl, jl, "prefill logits")
    for name, want in _flat_states(jst).items():
        got = _flat_states(tst)[name]
        assert tuple(got.shape) == shapes[name] == want.shape, name
        _close(got, want, f"prefill state {name}")
    jdec = jax.jit(lambda p, t, st, pos: jax_hy.decode_step(jcfg, p, t, st,
                                                            pos, SH))
    nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for step in range(STEPS):
        pos = S + step
        jl, jst = jdec(jp, jnp.asarray(nxt), jst, jnp.asarray(pos, jnp.int32))
        tl, tst = model.decode(tp, {"token": torch.from_numpy(nxt),
                                    "cache": tst, "pos": pos})
        _close(tl, jl, f"decode {step} logits")
        for name, want in _flat_states(jst).items():
            _close(_flat_states(tst)[name], want, f"decode {step} {name}")
        nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def test_hybrid_prefill_then_decode_matches_full_prefill():
    _, cfg = _cfgs()
    tp = params_from_jax(cfg, _jax_params(), device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 33, seed=1))
    full, _ = hybrid.prefill(cfg, tp, toks)
    _, st = hybrid.prefill(cfg, tp, toks[:, :-1], max_len=33)
    dec, _ = hybrid.decode_step(cfg, tp, toks[:, -1:], st, 32)
    torch.testing.assert_close(dec, full, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("remat", ["none", "dots_no_batch"])
def test_hybrid_train_loss_and_grads_match_jax(remat):
    jcfg, cfg = _cfgs()
    jp = _jax_params()
    toks = _tokens(cfg, 24)
    jl, jg = jax.tree.map(np.asarray, jax.jit(jax.value_and_grad(
        lambda p: jax_hy.train_loss(jcfg, p, {"tokens": jnp.asarray(toks)},
                                    SH, remat)))(jp))
    loss, grads = loss_and_grads(build(cfg), params_from_jax(
        cfg, jp, device="cpu"), {"tokens": torch.from_numpy(toks)}, remat)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(flat) == len(tree_leaves(grads))
    for path, want in flat:
        got = grads
        for key in path:
            got = got[key.key]
        name = "/".join(str(key.key) for key in path)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    assert float(grads["shared"]["attn"]["wq"].norm()) > 0


def test_hybrid_needs_whole_groups():
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="groups"):
        build(dataclasses.replace(cfg, n_layers=5))
