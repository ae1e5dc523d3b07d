"""The port's LM serving path against the JAX package on the reduced
configs of the four dense architectures, weights carried by
``params_from_jax`` from ``repro.models.init_params(key 0)``:

- the carried weights are bit-equal;
- prefill logits and KV caches, then three decode steps, agree at float32
  (``param_dtype="float32"``: atol/rtol 1e-4, summation order) and at
  bf16 (atol/rtol 2e-2: the JAX ``_sdpa`` rounds scores and weights to
  bf16 where the port's attention keeps float32, and the frameworks round
  the bf16 products at other places); also in float32 for qwen2.5-3b at
  its published head layout (16 heads over 2 KV heads at hd 128: GQA rep
  8, QKV biases, the tied table; 2 layers, narrow ``d_ff`` and
  vocabulary);
- the two ``Engine``s give the same greedy tokens in float32;
- the port's prefill-then-decode equals its full prefill.
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
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tf
from repro.serve import Engine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch.configs import get_reduced
from repro_torch.models import build, layers, params_from_jax, transformer
from repro_torch.models.convert import tensor_from_numpy
from repro_torch.serve import Engine, Request

DENSE = ["smollm-135m", "qwen2.5-3b", "yi-34b", "command-r-plus-104b"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# a reduced config at a published head layout: name -> (arch, changes)
LAYOUTS = {"qwen2.5-3b-published-heads": (
    "qwen2.5-3b", dict(n_layers=2, d_model=2048, n_heads=16, n_kv_heads=2,
                       d_ff=256, vocab=1000))}
SH = lambda x, *a: x  # noqa: E731  (the JAX identity sharder)
B, S, STEPS = 2, 9, 3


def _cfgs(arch, dtype):
    arch, kw = LAYOUTS.get(arch, (arch, {}))
    return (dataclasses.replace(jax_reduced(arch), param_dtype=dtype, **kw),
            dataclasses.replace(get_reduced(arch), param_dtype=dtype, **kw))


def _jax_params(jcfg, seed=0):
    params = jax_init(jax_build(jcfg).param_specs, jax.random.key(seed))
    return jax.tree.map(np.asarray, params)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("arch", DENSE + ["olmoe-1b-7b", "mamba2-2.7b",
                                         "zamba2-2.7b", "whisper-large-v3",
                                         "internvl2-26b"])
def test_params_from_jax_bit_equal(arch):
    jcfg, cfg = _cfgs(arch, "bfloat16")
    jp = _jax_params(jcfg)
    tp = params_from_jax(cfg, jp, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert flat
    for path, arr in flat:
        leaf = tp
        for key in path:
            leaf = leaf[key.key]
        assert tuple(leaf.shape) == arr.shape
        if leaf.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                leaf.view(torch.int16).numpy(), arr.view(np.int16))
        else:
            np.testing.assert_array_equal(leaf.numpy(), arr)
    if jcfg.qkv_bias:
        assert tp["blocks"]["attn"]["bq"].dtype == torch.float32
    with pytest.raises(ValueError, match="shape"):
        bad = jax.tree.map(lambda x: x, jp)
        bad["final_norm"]["scale"] = np.ones(3, np.float32)
        params_from_jax(cfg, bad, device="cpu")


@pytest.mark.parametrize("arch,dtype", [(a, d) for a in DENSE for d in TOL]
                         + [("qwen2.5-3b-published-heads", "float32")])
def test_prefill_and_decode_match_jax(arch, dtype):
    jcfg, cfg = _cfgs(arch, dtype)
    if arch in LAYOUTS:  # the published layout, not the reduced one
        assert (cfg.n_heads, cfg.n_kv_heads, cfg.hd) == (16, 2, 128)
        assert cfg.qkv_bias and cfg.tie_embeddings
    jp = _jax_params(jcfg)
    tp = params_from_jax(cfg, jp, device="cpu")
    tol = TOL[dtype]
    max_len = S + STEPS
    toks = np.random.default_rng(3).integers(1, cfg.vocab, (B, S)).astype(
        np.int32)
    jl, jc = jax.jit(lambda p, t: jax_tf.prefill(jcfg, p, t, SH, max_len))(
        jp, jnp.asarray(toks))
    tl, tc = transformer.prefill(cfg, tp, torch.from_numpy(toks), max_len)
    assert tl.dtype == torch.float32 and tl.shape == (B, 1, cfg.vocab_padded)
    assert tc[0].shape == (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.hd)
    _close(tl, jl, tol, "prefill logits")
    for got, want, name in zip(tc, jc, "kv"):
        _close(got, want, tol, f"prefill cache {name}")
    jdec = jax.jit(lambda p, t, c, pos: jax_tf.decode_step(jcfg, p, t, c, pos,
                                                           SH))
    nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for step in range(STEPS):
        pos = S + step
        jl, jc = jdec(jp, jnp.asarray(nxt), jc, jnp.asarray(pos, jnp.int32))
        tl, tc = transformer.decode_step(cfg, tp, torch.from_numpy(nxt), tc,
                                         pos)
        _close(tl, jl, tol, f"decode {step} logits")
        for got, want, name in zip(tc, jc, "kv"):
            _close(got, want, tol, f"decode {step} cache {name}")
        # both packages continue from the JAX tokens, so one near-tie in
        # bf16 cannot send them down different paths
        nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2.5-3b"])
def test_engine_greedy_tokens_match_jax(arch):
    jcfg, cfg = _cfgs(arch, "float32")
    jp = _jax_params(jcfg)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(3, 11, 5)]
    jreqs = [JaxRequest(prompt=p, max_new=6) for p in prompts]
    treqs = [Request(prompt=p, max_new=6) for p in prompts]
    jstats = JaxEngine(jax_build(jcfg), jax.tree.map(jnp.asarray, jp),
                       batch_slots=3, max_len=24).run(jreqs)
    tstats = Engine(build(cfg), params_from_jax(cfg, jp, device="cpu"),
                    batch_slots=3, max_len=24, device="cpu").run(treqs)
    assert tstats["tokens_out"] == jstats["tokens_out"] == 30
    assert tstats["batches"] == 2
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tr.out, jr.out)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_matches_full_prefill(arch):
    """logits(prefill t[:n]) then decode(t[n]) equal prefill(t[:n+1]) (the
    check of tests/test_arch_smoke.py, on the port, in float32)."""
    _, cfg = _cfgs(arch, "float32")
    tp = params_from_jax(cfg, _jax_params(dataclasses.replace(
        jax_reduced(arch), param_dtype="float32"), seed=1), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, (B, 32)).astype(np.int32))
    full, _ = transformer.prefill(cfg, tp, toks)
    _, cache = transformer.prefill(cfg, tp, toks[:, :-1], max_len=32)
    dec, _ = transformer.decode_step(cfg, tp, toks[:, -1:], cache, 31)
    torch.testing.assert_close(dec, full, rtol=1e-4, atol=1e-4)


def test_layernorm_and_gelu_match_jax():
    """The layer branches the dense configs do not take (enc-dec's
    LayerNorm and tanh-GELU MLP), against the JAX layers."""
    jcfg = dataclasses.replace(jax_reduced("smollm-135m"), norm="layernorm",
                               mlp="gelu", param_dtype="float32")
    cfg = dataclasses.replace(get_reduced("smollm-135m"), norm="layernorm",
                              mlp="gelu", param_dtype="float32")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    pn = {"scale": rng.normal(size=cfg.d_model).astype(np.float32),
          "bias": rng.normal(size=cfg.d_model).astype(np.float32)}
    pm = {"w_in": rng.normal(size=(cfg.d_model, cfg.d_ff)).astype(np.float32),
          "w_out": rng.normal(size=(cfg.d_ff, cfg.d_model)).astype(np.float32)}
    tn = {k: torch.from_numpy(v) for k, v in pn.items()}
    tm = {k: torch.from_numpy(v) for k, v in pm.items()}
    _close(layers.apply_norm(cfg, tn, torch.from_numpy(x)),
           jax_layers.apply_norm(jcfg, pn, jnp.asarray(x)), 1e-5, "layernorm")
    _close(layers.apply_mlp(cfg, tm, torch.from_numpy(x)),
           jax_layers.apply_mlp(jcfg, pm, jnp.asarray(x), SH), 1e-4, "gelu")


def test_build_serves_dense_only_and_refuses_training():
    """``build`` takes every family of the registry (dense, MoE, Mamba2,
    hybrid, enc-dec, VLM); each trains: ``train_loss`` of a small batch
    is a finite 0-d float32 tensor, and its parameter count is the JAX
    package's at reduced and full size. (The name is kept for the record:
    the port once took the dense family only, and refused training.)"""
    from repro.configs import get_config as jax_config
    from repro.models import param_count as jax_param_count
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import init_params, param_count
    built = set()
    for arch in ARCH_IDS:
        cfg = get_reduced(arch)
        model = build(cfg)
        built.add(cfg.family)
        for port, ref in ((cfg, jax_reduced(arch)),
                          (get_config(arch), jax_config(arch))):
            assert param_count(build(port).param_specs) == \
                jax_param_count(jax_build(ref).param_specs)
        params = init_params(model.param_specs,
                             torch.Generator().manual_seed(0))
        toks = torch.randint(1, cfg.vocab, (2, 8), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(1))
        batch = {"tokens": toks}
        prefix = {"encdec": ("frames", cfg.n_frames),
                  "vlm": ("img_embeds", cfg.n_img_tokens)}.get(cfg.family)
        if prefix is not None:
            batch[prefix[0]] = 0.02 * torch.randn(
                2, prefix[1], cfg.d_model,
                generator=torch.Generator().manual_seed(2)).to(cfg.dtype)
        loss = model.train_loss(params, batch)
        assert loss.dtype == torch.float32 and loss.dim() == 0
        assert bool(torch.isfinite(loss))
        assert set(model.train_input_specs(2, 16)) == set(batch)
        want = {"token", "cache"} | ({"pos"} if cfg.family != "ssm" else set())
        if cfg.family == "encdec":
            want.add("cross")
        assert set(model.decode_input_specs(2, 16)) == want
    assert built == {"dense", "moe", "ssm", "hybrid", "encdec", "vlm"}
    full = get_config("smollm-135m")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd, full.vocab) == (30, 576, 9, 3, 64, 49152)


def test_init_params_draws_a_large_leaf_in_slices(monkeypatch):
    """A leaf past ``SLICE_ELEMENTS`` is drawn a slice over its leading
    axes at a time into a tensor of its own dtype: the right shape, dtype
    and std, the same draw for the same seed, and the leaves under the
    limit drawn exactly as before."""
    from repro_torch.models import spec
    specs = {"big": spec.PSpec((3, 4, 50, 64), torch.bfloat16),
             "small": spec.PSpec((40, 30), torch.float32)}
    whole = spec.init_params(specs, torch.Generator().manual_seed(7))
    monkeypatch.setattr(spec, "SLICE_ELEMENTS", 4 * 50 * 64)
    draws = [spec.init_params(specs, torch.Generator().manual_seed(s))
             for s in (7, 7, 8)]
    big = draws[0]["big"]
    assert big.shape == (3, 4, 50, 64) and big.dtype == torch.bfloat16
    std = min(0.02, 50 ** -0.5)
    assert abs(float(big.float().std()) / std - 1) < 0.05
    assert abs(float(big.float().mean())) < 0.05 * std
    assert torch.equal(draws[0]["big"], draws[1]["big"])
    assert not torch.equal(draws[0]["big"], draws[2]["big"])
    # three slices of [4, 50, 64]: the first is the first draw of its size
    first = torch.randn((4, 50, 64), generator=torch.Generator().manual_seed(
        7)) * std
    assert torch.equal(big[0], first.to(torch.bfloat16))
    monkeypatch.setattr(spec, "SLICE_ELEMENTS", 1 << 28)
    assert torch.equal(whole["small"], spec.init_params(
        specs, torch.Generator().manual_seed(7))["small"])


def test_tensor_from_numpy_keeps_bf16_bits():
    words = np.array([0x3F80, 0xC000, 0x7F7F, 0x0001], np.uint16)
    arr = jnp.asarray(words.view(np.int16)).view(jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(arr), torch.bfloat16, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  words.view(np.int16))
    assert t[:2].tolist() == [1.0, -2.0]
