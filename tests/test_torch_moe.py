"""The port's MoE family against the JAX package on the CPU, weights from the
JAX init carried by ``params_from_jax``:

- the layer alone (JAX ``_apply_moe_local``, identity sharder) in float32
  and bf16: the routing (expert choices, dispatch slots, kept pairs)
  exactly equal to the JAX ops', ``y`` within 1e-5 (f32) / about one
  bf16 ulp (bf16: rtol 8e-3, atol 1e-2 x max|y|, relative error norm
  <= 1e-2), the aux loss within 1e-6; a zero router (every probability
  tied) picks the lower experts as ``lax.top_k`` does;
  ``capacity_factor=0.25`` overflows and drops the same pairs;
- the bf16 combine alone, on the same expert outputs and routing (top 4,
  so that the order of the sums shows): bit for bit JAX's scatter-add;
- olmoe-1b-7b and kimi-k2 reduced (the shared expert, GQA 4/2): prefill
  and decode logits and caches within 1e-4 in float32, ``train_loss``
  (rtol 1e-5) and every leaf's gradient (rtol 1e-4, atol 1e-6: the
  dense family's tolerances) under remat ``none`` and ``dots_no_batch``.
"""
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
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro_torch.configs import get_reduced
from repro_torch.models import build, moe, params_from_jax, transformer
from repro_torch.models.spec import tree_leaves, tree_map
from repro_torch.train.train_step import loss_and_grads

SH = lambda x, *a: x  # noqa: E731  (the JAX identity sharder)
ARCHS = ["olmoe-1b-7b", "kimi-k2-1t-a32b"]
B, S, STEPS = 2, 9, 3


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jax_reduced(arch), param_dtype=dtype, **kw),
            dataclasses.replace(get_reduced(arch), param_dtype=dtype, **kw))


@functools.lru_cache(maxsize=None)
def _jax_params(arch, dtype="float32", seed=0):
    jcfg, _ = _cfgs(arch, dtype)
    params = jax_init(jax_build(jcfg).param_specs, jax.random.key(seed))
    return jax.tree.map(np.asarray, params)


def _layer_params(arch, dtype):
    """Layer 0's MoE parameters: numpy (JAX side) and the port's tensors."""
    _, cfg = _cfgs(arch, dtype)
    jp = _jax_params(arch, dtype)
    tp = params_from_jax(cfg, jp, device="cpu")
    return (jax.tree.map(lambda w: w[0], jp["blocks"]["moe"]),
            tree_map(lambda w: w[0], tp["blocks"]["moe"]))


def _jax_routing(jcfg, router, xt):
    """The routing lines of JAX ``_apply_moe_local`` (the module returns
    only y and aux): (eidx, slot, keep)."""
    t, k, e = xt.shape[0], jcfg.experts_per_token, jcfg.n_experts
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32), router)
    probs = jax.nn.softmax(logits, axis=-1)
    _, eidx = jax.lax.top_k(probs, k)
    flat_e = eidx.reshape(t * k)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    starts = jnp.searchsorted(se, jnp.arange(e, dtype=se.dtype))
    pos_in_e = jnp.arange(t * k, dtype=jnp.int32) - starts[se].astype(
        jnp.int32)
    cap = jax_moe.capacity(jcfg, t)
    keep = pos_in_e < cap
    slot = jnp.where(keep, se.astype(jnp.int32) * cap + pos_in_e, e * cap)
    return tuple(np.asarray(a) for a in (eidx, slot, keep))


def _layer_case(arch, dtype, x, jp, tp, **kw):
    jcfg, cfg = _cfgs(arch, dtype, **kw)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jy, jaux = jax.jit(lambda p, v: jax_moe._apply_moe_local(
        jcfg, p, v, SH))(jp, jx)
    ty, taux = moe.apply_moe(cfg, tp, tx)
    eidx, slot, keep = _jax_routing(jcfg, jp["router"],
                                    jx.reshape(-1, x.shape[-1]))
    r = moe.route(cfg, tp["router"], tx.reshape(-1, x.shape[-1]))
    np.testing.assert_array_equal(r.eidx.numpy(), eidx)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    got, want = ty.float().numpy(), np.asarray(jy, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:  # the bf16 expert products round apart: about one bf16 ulp
        np.testing.assert_allclose(got, want, rtol=8e-3,
                                   atol=1e-2 * np.abs(want).max())
        assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)
    assert taux.dtype == torch.float32 and taux.dim() == 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6,
                               atol=1e-6)
    return r


def _x(cfg, seed, b=3, s=7, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model))).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_jax(arch, dtype):
    _, cfg = _cfgs(arch, dtype)
    jp, tp = _layer_params(arch, dtype)
    # a router of std 1 spreads the tokens, so several experts are chosen
    rng = np.random.default_rng(4)
    jp = dict(jp, router=rng.normal(size=jp["router"].shape).astype(
        np.float32))
    tp = dict(tp, router=torch.from_numpy(jp["router"]))
    r = _layer_case(arch, dtype, _x(cfg, 1), jp, tp)
    assert len(np.unique(r.eidx.numpy())) > cfg.experts_per_token


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_bf16_combine_matches_jax_scatter_add(arch):
    """The combine alone in bf16, on the same expert outputs and routing,
    equals JAX's ``zeros.at[stok].add(contrib)`` bit for bit: a token's
    contributions are added in ascending expert order. Top 4 of the
    config's experts, and outputs spread over 13 binades, so that another
    order of the bf16 sums gives other values."""
    _, cfg = _cfgs(arch, "bfloat16", experts_per_token=4)
    rng = np.random.default_rng(7)
    t, d = 64, cfg.d_model
    router = torch.from_numpy(rng.normal(size=(d, cfg.n_experts)).astype(
        np.float32))
    r = moe.route(cfg, router, torch.from_numpy(rng.normal(size=(t, d)).astype(
        np.float32)).bfloat16())
    e_cap = cfg.n_experts * r.cap
    out = torch.from_numpy((rng.normal(size=(e_cap, d)) * np.exp2(
        rng.integers(-6, 7, (e_cap, d)))).astype(np.float32)).bfloat16()
    got = moe.combine(r, out, torch.bfloat16)

    # JAX ``_apply_moe_local``'s combine lines, on the same inputs
    slot, keep, stok, sgate = (jnp.asarray(a.numpy()) for a in (
        r.slot, r.keep, r.stok, r.sgate))
    jout = jnp.asarray(out.float().numpy()).astype(jnp.bfloat16)
    contrib = jout[jnp.minimum(slot, e_cap - 1)] * sgate[:, None].astype(
        jnp.bfloat16)
    contrib = jnp.where(keep[:, None], contrib, 0)
    want = jnp.zeros((t, d), jnp.bfloat16).at[stok].add(contrib)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ties_pick_the_lower_experts(arch):
    """A zero router ties every probability: both packages pick experts
    0..k-1 for every token, in that order."""
    _, cfg = _cfgs(arch)
    jp, tp = _layer_params(arch, "float32")
    jp = dict(jp, router=np.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    r = _layer_case(arch, "float32", _x(cfg, 2), jp, tp)
    k = cfg.experts_per_token
    np.testing.assert_array_equal(
        r.eidx.numpy(), np.broadcast_to(np.arange(k), r.eidx.shape))


def test_moe_overflow_drops_the_same_pairs():
    """``capacity_factor=0.25``: experts overflow and both packages drop
    the same (token, expert) pairs."""
    arch = "olmoe-1b-7b"
    _, cfg = _cfgs(arch, capacity_factor=0.25)
    jp, tp = _layer_params(arch, "float32")
    jp = dict(jp, router=np.random.default_rng(6).normal(
        size=jp["router"].shape).astype(np.float32))
    tp = dict(tp, router=torch.from_numpy(jp["router"]))
    r = _layer_case(arch, "float32", _x(cfg, 3, b=4, s=8), jp, tp,
                    capacity_factor=0.25)
    dropped = int((~r.keep).sum())
    assert 0 < dropped < r.keep.numel()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_and_decode_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp = _jax_params(arch)
    tp = params_from_jax(cfg, jp, device="cpu")
    max_len = S + STEPS
    toks = np.random.default_rng(3).integers(1, cfg.vocab, (B, S)).astype(
        np.int32)
    jl, jc = jax.jit(lambda p, t: jax_tf.prefill(jcfg, p, t, SH, max_len))(
        jp, jnp.asarray(toks))
    model = build(cfg)
    tl, tc = model.prefill(tp, {"tokens": torch.from_numpy(toks),
                                "max_len": max_len})
    assert tl.shape == (B, 1, cfg.vocab_padded)
    assert tc[0].shape == (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.hd)
    _close(tl, jl, "prefill logits")
    for got, want, name in zip(tc, jc, "kv"):
        _close(got, want, f"prefill cache {name}")
    jdec = jax.jit(lambda p, t, c, pos: jax_tf.decode_step(jcfg, p, t, c, pos,
                                                           SH))
    nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for step in range(STEPS):
        pos = S + step
        jl, jc = jdec(jp, jnp.asarray(nxt), jc, jnp.asarray(pos, jnp.int32))
        tl, tc = model.decode(tp, {"token": torch.from_numpy(nxt),
                                   "cache": tc, "pos": pos})
        _close(tl, jl, f"decode {step} logits")
        for got, want, name in zip(tc, jc, "kv"):
            _close(got, want, f"decode {step} cache {name}")
        nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def _close(got, want, what, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, remat):
    jcfg, cfg = _cfgs(arch)
    toks = jnp.asarray(_tokens(cfg))
    return jax.tree.map(np.asarray, jax.jit(jax.value_and_grad(
        lambda p: jax_tf.train_loss(jcfg, p, {"tokens": toks}, SH, remat)))(
        _jax_params(arch)))


def _tokens(cfg, seed=3):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (B, 16)).astype(
        np.int32)


@pytest.mark.parametrize("remat", ["none", "dots_no_batch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_train_loss_and_grads_match_jax(arch, remat):
    _, cfg = _cfgs(arch)
    jl, jg = _jax_loss_and_grads(arch, remat)
    loss, grads = loss_and_grads(
        build(cfg), params_from_jax(cfg, _jax_params(arch), device="cpu"),
        {"tokens": torch.from_numpy(_tokens(cfg))}, remat)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(flat) == len(tree_leaves(grads))
    for path, want in flat:
        got = grads
        for key in path:
            got = got[key.key]
        name = "/".join(str(key.key) for key in path)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    router = grads["blocks"]["moe"]["router"]
    assert float(router.norm()) > 0  # the gates and the aux loss reach it


def test_moe_aux_loss_enters_train_loss():
    """``train_loss`` adds 0.01 x the layers' summed aux loss."""
    _, cfg = _cfgs("olmoe-1b-7b")
    tp = params_from_jax(cfg, _jax_params("olmoe-1b-7b"), device="cpu")
    toks = torch.from_numpy(_tokens(cfg))
    positions = torch.arange(toks.shape[1], dtype=torch.int32)
    x = tp["embed"]["embedding"][toks]
    _, aux = transformer.apply_stack(cfg, tp["blocks"], x, positions, "none")
    assert float(aux) > 0
    with torch.no_grad():
        loss = transformer.train_loss(cfg, tp, {"tokens": toks}, "none")
        real = moe.apply_moe
        try:
            moe.apply_moe = lambda *a: (real(*a)[0], torch.zeros(()))
            bare = transformer.train_loss(cfg, tp, {"tokens": toks}, "none")
        finally:
            moe.apply_moe = real
    np.testing.assert_allclose(float(loss - bare), 0.01 * float(aux),
                               rtol=1e-4)
