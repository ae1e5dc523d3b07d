"""The port's Mamba2 family against the JAX package on the CPU, in float32 at
the reduced mamba2-2.7b config (chunk 16), weights from the JAX init
carried by ``params_from_jax``:

- ``_ssd_chunked``, ``apply_mamba`` (with its states), ``mamba_decode``,
  ``prefill``, ``decode_step`` continuing from prefill's states, and
  ``train_loss``, within 1e-4 (Sq 21: a ragged tail);
- every leaf's gradient at Sq 24 (where the JAX gradient is finite) within
  rtol 1e-4, atol 1e-6;
- the reference fault R1: at ``ssm_chunk=128`` and Sq 64 the JAX gradient
  is non-finite (``where(mask, exp(seg), 0)`` overflows above the
  diagonal), the port's is finite and equal to the gradient through a
  float64 step-by-step recurrence written here (rtol 1e-3, atol 1e-7).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import build as jax_build
from repro.models import init_params as jax_init
from repro.models import mamba2 as jax_m2
from repro_torch.configs import get_reduced
from repro_torch.models import build, mamba2, params_from_jax
from repro_torch.models.spec import tree_leaves
from repro_torch.train.train_step import loss_and_grads

SH = lambda x, *a: x  # noqa: E731  (the JAX identity sharder)
ARCH = "mamba2-2.7b"
B, S = 2, 21
TOL = 1e-4


def _cfgs(**kw):
    return (dataclasses.replace(jax_reduced(ARCH), param_dtype="float32",
                                **kw),
            dataclasses.replace(get_reduced(ARCH), param_dtype="float32",
                                **kw))


@functools.lru_cache(maxsize=None)
def _jax_params(seed=0, **kw):
    jcfg, _ = _cfgs(**kw)
    return jax.tree.map(np.asarray, jax_init(jax_build(jcfg).param_specs,
                                             jax.random.key(seed)))


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _tokens(cfg, s=S, seed=3):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (B, s)).astype(
        np.int32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def test_ssd_chunked_matches_jax():
    """The SSD scan alone, on inputs of the scale the layer feeds it, a
    ragged tail and an initial state."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(0)
    h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    x = rng.normal(size=(B, S, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, h)))).astype(np.float32)
    a_log = rng.normal(size=h).astype(np.float32)
    b_, c_ = (rng.normal(size=(B, S, n)).astype(np.float32) for _ in "bc")
    h0 = rng.normal(size=(B, h, p, n)).astype(np.float32)
    for init in (None, h0):
        jy, jst = jax_m2._ssd_chunked(
            jcfg, *(jnp.asarray(a) for a in (x, dt, a_log, b_, c_)),
            None if init is None else jnp.asarray(init))
        ty, tst = mamba2._ssd_chunked(
            cfg, *(_t(a) for a in (x, dt, a_log, b_, c_)),
            None if init is None else _t(init))
        _close(ty, jy, "ssd y")
        _close(tst, jst, "ssd final state")


def test_mamba_layer_and_decode_match_jax():
    jcfg, cfg = _cfgs()
    jp = jax.tree.map(lambda w: w[0], _jax_params()["blocks"]["mamba"])
    tp = {k: _t(v) for k, v in jp.items()}
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    jo, (jss, jcs) = jax_m2.apply_mamba(jcfg, jp, jnp.asarray(x), SH,
                                        return_state=True)
    to, (tss, tcs) = mamba2.apply_mamba(cfg, tp, _t(x), return_state=True)
    _close(to, jo, "apply_mamba out")
    _close(tss, jss, "apply_mamba ssm state")
    _close(tcs, jcs, "apply_mamba conv state")
    xt = rng.normal(size=(B, cfg.d_model)).astype(np.float32)
    jo, jss2, jcs2 = jax_m2.mamba_decode(jcfg, jp, jnp.asarray(xt), jss, jcs,
                                         SH)
    to, tss2, tcs2 = mamba2.mamba_decode(cfg, tp, _t(xt), tss, tcs)
    _close(to, jo, "mamba_decode out")
    _close(tss2, jss2, "mamba_decode ssm state")
    _close(tcs2, jcs2, "mamba_decode conv state")


def test_prefill_and_decode_match_jax():
    jcfg, cfg = _cfgs()
    jp = _jax_params()
    tp = params_from_jax(cfg, jp, device="cpu")
    toks = _tokens(cfg)
    jl, jst = jax.jit(lambda p, t: jax_m2.prefill(jcfg, p, t, SH))(
        jp, jnp.asarray(toks))
    model = build(cfg)
    tl, tst = model.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (B, 1, cfg.vocab_padded)
    di, n = cfg.d_inner, cfg.ssm_state
    assert tst[0].shape == (cfg.n_layers, B, cfg.ssm_heads, cfg.ssm_headdim,
                            n) and tst[0].dtype == torch.float32
    assert tst[1].shape == (cfg.n_layers, B, cfg.ssm_conv - 1, di + 2 * n)
    _close(tl, jl, "prefill logits")
    for got, want, name in zip(tst, jst, ("ssm", "conv")):
        _close(got, want, f"prefill {name} states")
    jdec = jax.jit(lambda p, t, st: jax_m2.decode_step(jcfg, p, t, st, SH))
    nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for step in range(3):
        jl, jst = jdec(jp, jnp.asarray(nxt), jst)
        tl, tst = model.decode(tp, {"token": torch.from_numpy(nxt),
                                    "cache": tst})
        _close(tl, jl, f"decode {step} logits")
        for got, want, name in zip(tst, jst, ("ssm", "conv")):
            _close(got, want, f"decode {step} {name} states")
        nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def test_prefill_then_decode_matches_full_prefill():
    _, cfg = _cfgs()
    tp = params_from_jax(cfg, _jax_params(), device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 33, seed=1))
    full, _ = mamba2.prefill(cfg, tp, toks)
    _, st = mamba2.prefill(cfg, tp, toks[:, :-1])
    dec, _ = mamba2.decode_step(cfg, tp, toks[:, -1:], st)
    torch.testing.assert_close(dec, full, rtol=TOL, atol=TOL)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(s, chunk):
    jcfg, cfg = _cfgs(ssm_chunk=chunk)
    toks = jnp.asarray(_tokens(cfg, s))
    return jax.tree.map(np.asarray, jax.jit(jax.value_and_grad(
        lambda p: jax_m2.train_loss(jcfg, p, {"tokens": toks}, SH, "none")))(
        _jax_params(ssm_chunk=chunk)))


def test_train_loss_and_grads_match_jax():
    _, cfg = _cfgs()
    jl, jg = _jax_loss_and_grads(24, cfg.ssm_chunk)
    loss, grads = loss_and_grads(
        build(cfg), params_from_jax(cfg, _jax_params(), device="cpu"),
        {"tokens": torch.from_numpy(_tokens(cfg, 24))})
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(flat) == len(tree_leaves(grads))
    for path, want in flat:
        got = grads
        for key in path:
            got = got[key.key]
        name = "/".join(str(key.key) for key in path)
        assert np.isfinite(want).all(), name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def _ssd_recurrence(cfg, x, dt, a_log, b_, c_, init_state=None):
    """The SSD as its definition, one step at a time in float64:
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t (the D x_t
    term is added by the caller, as ``apply_mamba`` adds it)."""
    bsz, s, h, p = x.shape
    a = -torch.exp(a_log.double())
    st = (torch.zeros(bsz, h, p, b_.shape[-1], dtype=torch.float64)
          if init_state is None else init_state.double())
    ys = []
    for t in range(s):
        dtt = dt[:, t].double()                                  # [B,H]
        st = st * torch.exp(dtt * a)[:, :, None, None] + \
            (dtt[:, :, None] * x[:, t].double())[..., None] \
            * b_[:, t].double()[:, None, None, :]
        ys.append(torch.einsum("bn,bhpn->bhp", c_[:, t].double(), st))
    return torch.stack(ys, 1).to(x.dtype), st.float()


def test_reference_fault_r1_chunk_128_gradient():
    """R1: at chunk 128 and Sq 64 the JAX gradient below the final norm is
    non-finite; the port's is finite and equals the gradient through the
    float64 recurrence."""
    _, cfg = _cfgs(ssm_chunk=128)
    _, jg = _jax_loss_and_grads(64, 128)
    bad = [p for p, g in jax.tree_util.tree_flatten_with_path(jg)[0]
           if not np.isfinite(g).all()]
    assert bad  # the reference's fault, pinned
    model = build(cfg)
    tp = params_from_jax(cfg, _jax_params(ssm_chunk=128), device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 64))}
    loss, grads = loss_and_grads(model, tp, batch, "none")
    real = mamba2._ssd_chunked
    mamba2._ssd_chunked = _ssd_recurrence
    try:
        rloss, rgrads = loss_and_grads(model, tp, batch, "none")
    finally:
        mamba2._ssd_chunked = real
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    for got, want in zip(tree_leaves(grads), tree_leaves(rgrads)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-7)
    assert float(grads["embed"]["embedding"].norm()) > 0


def test_ssd_gradient_is_finite_where_the_decay_overflows():
    """The scan alone at chunk 128 with a decay whose exponent above the
    diagonal passes float32's range: gradients finite and equal to the
    recurrence's."""
    _, cfg = _cfgs(ssm_chunk=128)
    g = torch.Generator().manual_seed(0)
    h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    x, b_, c_ = (torch.randn(shape, generator=g) for shape in
                 ((1, 128, h, p), (1, 128, n), (1, 128, n)))
    dt = torch.full((1, 128, h), 0.7)
    a_log = torch.ones(h)  # 127 x 0.7 x e > 88: exp overflows above
    outs = []
    for fn in (mamba2._ssd_chunked, _ssd_recurrence):
        ins = [t.clone().requires_grad_() for t in (x, dt, b_, c_)]
        y, st = fn(cfg, ins[0], ins[1], a_log, ins[2], ins[3])
        grads = torch.autograd.grad((y.sum() + st.sum()), ins)
        outs.append((y, grads))
    (y, grads), (ry, rgrads) = outs
    # y and the gradients are sums of ~128 x 16 terms of size ~1: float32
    # keeps them to ~1e-5 of their scale
    torch.testing.assert_close(y, ry, rtol=1e-4, atol=1e-4)
    for got, want in zip(grads, rgrads):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
