"""The port's VLM family (internvl2-26b reduced: 3 layers, 4 heads over 2
KV heads at hd 16, 8 image tokens) against the JAX package on the CPU, in
float32, weights from the JAX init carried by ``params_from_jax``, image
embeddings and tokens from a numpy seed: prefill logits and the KV cache
over the image prefix and the prompt (shapes and values), three decode
steps continuing from it at ``pos = n_img + S + step``, and ``train_loss``
with every leaf's gradient, within 1e-4 (gradients rtol 1e-4, atol 1e-6);
a bf16 prefill within 2e-2; the input specs."""
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
from repro.models import vlm as jax_vlm
from repro_torch.configs import get_reduced
from repro_torch.models import build, params_from_jax, transformer, vlm
from repro_torch.models.spec import tree_leaves
from repro_torch.train.train_step import loss_and_grads

SH = lambda x, *a: x  # noqa: E731  (the JAX identity sharder)
ARCH = "internvl2-26b"
B, S, STEPS = 2, 6, 3
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jax_reduced(ARCH), param_dtype=dtype),
            dataclasses.replace(get_reduced(ARCH), param_dtype=dtype))


@functools.lru_cache(maxsize=None)
def _jax_params(dtype):
    jcfg, _ = _cfgs(dtype)
    return jax.tree.map(np.asarray, jax_init(jax_build(jcfg).param_specs,
                                             jax.random.key(0)))


def _close(got, want, what, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _inputs(cfg, s, seed=3):
    rng = np.random.default_rng(seed)
    img = (rng.normal(size=(B, cfg.n_img_tokens, cfg.d_model)) * 0.02
           ).astype(np.float32)
    return img, rng.integers(1, cfg.vocab, (B, s)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_prefill_and_decode_match_jax(dtype):
    """float32: prefill and three decode steps within 1e-4; bf16 (the
    served dtype, the image embeddings given in float32 and cast by the
    model): the prefill within 2e-2."""
    jcfg, cfg = _cfgs(dtype)
    jp = _jax_params(dtype)
    tp = params_from_jax(cfg, jp, device="cpu")
    tol = TOL[dtype]
    n_img = cfg.n_img_tokens
    max_len = n_img + S + STEPS
    img, toks = _inputs(cfg, S)
    jl, jcache = jax.jit(lambda p, i, t: jax_vlm.prefill(
        jcfg, p, i, t, SH, max_len))(jp, jnp.asarray(img), jnp.asarray(toks))
    model = build(cfg)
    tl, cache = model.prefill(tp, {"img_embeds": torch.from_numpy(img),
                                   "tokens": torch.from_numpy(toks),
                                   "max_len": max_len})
    assert tl.shape == (B, 1, cfg.vocab_padded)
    _close(tl, jl, "prefill logits", tol)
    for side, g, w in zip("kv", cache, jcache):
        assert tuple(g.shape) == (cfg.n_layers, B, max_len, cfg.n_kv_heads,
                                  cfg.hd) == w.shape
        assert g.dtype == cfg.dtype
        _close(g, w, f"prefill cache {side}", tol)
    if dtype != "float32":
        return
    jdec = jax.jit(lambda p, t, c, pos: jax_vlm.decode_step(jcfg, p, t, c,
                                                            pos, SH))
    nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for step in range(STEPS):
        pos = n_img + S + step
        jl, jcache = jdec(jp, jnp.asarray(nxt), jcache,
                          jnp.asarray(pos, jnp.int32))
        tl, cache = model.decode(tp, {"token": torch.from_numpy(nxt),
                                      "cache": cache, "pos": pos})
        _close(tl, jl, f"decode {step} logits", tol)
        for side, g, w in zip("kv", cache, jcache):
            _close(g, w, f"decode {step} cache {side}", tol)
        nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def test_vlm_prefill_then_decode_matches_full_prefill():
    _, cfg = _cfgs()
    tp = params_from_jax(cfg, _jax_params("float32"), device="cpu")
    img, toks = (torch.from_numpy(x) for x in _inputs(cfg, 10, seed=1))
    full, _ = vlm.prefill(cfg, tp, img, toks)
    n = cfg.n_img_tokens + 9
    _, cache = vlm.prefill(cfg, tp, img, toks[:, :-1], max_len=n + 1)
    dec, _ = vlm.decode_step(cfg, tp, toks[:, -1:], cache, n)
    torch.testing.assert_close(dec, full, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("remat", ["none", "dots_no_batch"])
def test_vlm_train_loss_and_grads_match_jax(remat):
    jcfg, cfg = _cfgs()
    jp = _jax_params("float32")
    img, toks = _inputs(cfg, 9, seed=5)
    jbatch = {"img_embeds": jnp.asarray(img), "tokens": jnp.asarray(toks)}
    jl, jg = jax.tree.map(np.asarray, jax.jit(jax.value_and_grad(
        lambda p: jax_vlm.train_loss(jcfg, p, jbatch, SH, remat)))(jp))
    loss, grads = loss_and_grads(
        build(cfg), params_from_jax(cfg, jp, device="cpu"),
        {"img_embeds": torch.from_numpy(img),
         "tokens": torch.from_numpy(toks)}, remat)
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
    assert float(grads["blocks"]["attn"]["wq"].norm()) > 0


def test_vlm_specs_follow_the_jax_package():
    """The input and decode-state specs of ``build`` (the JAX ``api.py``'s
    shapes: VLM training tokens are s - n_img), and the backbone's
    parameter tree is the transformer's."""
    jcfg, cfg = _cfgs("bfloat16")
    model, jmodel = build(cfg), jax_build(jcfg)
    for fn in ("train_input_specs", "prefill_input_specs",
               "decode_input_specs"):
        got = getattr(model, fn)(2, 40)
        want = getattr(jmodel, fn)(2, 40)
        assert set(got) == set(want), fn
        for k in got:
            g, w = tree_leaves(got[k]), jax.tree.leaves(
                want[k], is_leaf=lambda x: hasattr(x, "shape"))
            assert [tuple(x.shape) for x in g] == [tuple(x.shape) for x in w]
    assert model.train_input_specs(2, 40)["tokens"].shape == (
        2, 40 - cfg.n_img_tokens)
    assert model.train_input_specs(2, 40)["img_embeds"].dtype == \
        torch.bfloat16
    assert model.param_specs == transformer.param_specs(cfg)


@pytest.mark.parametrize("arch", ["internvl2-26b", "whisper-large-v3"])
def test_engine_refuses_vlm_and_encdec(arch):
    """As in the JAX package, ``Engine`` serves the decoder-only LMs only;
    these families serve through ``build(cfg).prefill`` / ``.decode``."""
    from repro_torch.models import init_params
    from repro_torch.serve import Engine
    cfg = get_reduced(arch)
    model = build(cfg)
    params = init_params(model.param_specs, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="decoder-only"):
        Engine(model, params, device="cpu")
