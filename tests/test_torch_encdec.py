"""The port's enc-dec family (whisper-large-v3 reduced: 2 encoder and 2
decoder layers, d_model 64, 16 frames) against the JAX package on the CPU,
in float32, weights from the JAX init carried by ``params_from_jax``,
frames and tokens from a numpy seed: prefill logits, the self-attention
cache and the cross-attention keys and values (shapes and values), three
decode steps continuing from them, and ``train_loss`` with every leaf's
gradient, within 1e-4 (gradients rtol 1e-4, atol 1e-6). Also the layer
changes the family brought (``use_rope=False``, cross-attention, the
sinusoidal positions), a bf16 prefill within 2e-2, and the training
launcher's frames and image embeddings against the JAX launcher's."""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.launch import train as jax_launch_train
from repro.models import build as jax_build
from repro.models import encdec as jax_ed
from repro.models import init_params as jax_init
from repro.models import layers as jax_layers
from repro_torch.configs import get_reduced
from repro_torch.launch import train as launch_train
from repro_torch.models import build, encdec, layers, params_from_jax
from repro_torch.models.spec import tree_leaves
from repro_torch.train.train_step import loss_and_grads

SH = lambda x, *a: x  # noqa: E731  (the JAX identity sharder)
ARCH = "whisper-large-v3"
B, S, STEPS = 2, 7, 3
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jax_reduced(ARCH), param_dtype=dtype),
            dataclasses.replace(get_reduced(ARCH), param_dtype=dtype))


@functools.lru_cache(maxsize=None)
def _jax_params(dtype="float32"):
    jcfg, _ = _cfgs(dtype)
    return jax.tree.map(np.asarray, jax_init(jax_build(jcfg).param_specs,
                                             jax.random.key(0)))


def _close(got, want, what, tol=TOL["float32"]):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _inputs(cfg, s, seed=3):
    rng = np.random.default_rng(seed)
    frames = (rng.normal(size=(B, cfg.n_frames, cfg.d_model)) * 0.02
              ).astype(np.float32)
    return frames, rng.integers(1, cfg.vocab, (B, s)).astype(np.int32)


def _jax_dtype(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


def _torch_dtype(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def test_encdec_prefill_and_decode_match_jax():
    jcfg, cfg = _cfgs()
    jp = _jax_params()
    tp = params_from_jax(cfg, jp, device="cpu")
    max_len = S + STEPS
    frames, toks = _inputs(cfg, S)
    jl, jcache, jcross = jax.jit(lambda p, f, t: jax_ed.prefill(
        jcfg, p, f, t, SH, max_len))(jp, jnp.asarray(frames),
                                     jnp.asarray(toks))
    model = build(cfg)
    tl, cache, cross = model.prefill(tp, {
        "frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks),
        "max_len": max_len})
    shapes = {"cache": (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.hd),
              "cross": (cfg.n_layers, B, cfg.n_frames, cfg.n_kv_heads,
                        cfg.hd)}
    assert tl.shape == (B, 1, cfg.vocab_padded)
    _close(tl, jl, "prefill logits")
    for name, got, want in (("cache", cache, jcache),
                            ("cross", cross, jcross)):
        for side, g, w in zip("kv", got, want):
            assert tuple(g.shape) == shapes[name] == w.shape, name
            _close(g, w, f"prefill {name} {side}")
    jdec = jax.jit(lambda p, t, c, x, pos: jax_ed.decode_step(
        jcfg, p, t, c, x, pos, SH))
    nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for step in range(STEPS):
        pos = S + step
        jl, jcache = jdec(jp, jnp.asarray(nxt), jcache, jcross,
                          jnp.asarray(pos, jnp.int32))
        tl, cache = model.decode(tp, {"token": torch.from_numpy(nxt),
                                      "cache": cache, "cross": cross,
                                      "pos": pos})
        _close(tl, jl, f"decode {step} logits")
        for side, g, w in zip("kv", cache, jcache):
            _close(g, w, f"decode {step} cache {side}")
        nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def test_encdec_prefill_then_decode_matches_one_forward():
    _, cfg = _cfgs()
    tp = params_from_jax(cfg, _jax_params(), device="cpu")
    frames, toks = (torch.from_numpy(x) for x in _inputs(cfg, 12, seed=1))
    full = encdec.logits(cfg, tp, frames, toks)
    got, cache, cross = encdec.prefill(cfg, tp, frames, toks[:, :8],
                                       max_len=12)
    steps = [got]
    for pos in range(8, 11):
        got, cache = encdec.decode_step(cfg, tp, toks[:, pos:pos + 1],
                                        cache, cross, pos)
        steps.append(got)
    torch.testing.assert_close(torch.cat(steps, 1), full[:, 7:11],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("remat", ["none", "dots_no_batch"])
def test_encdec_train_loss_and_grads_match_jax(remat):
    jcfg, cfg = _cfgs()
    jp = _jax_params()
    frames, toks = _inputs(cfg, 10, seed=5)
    jbatch = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}
    jl, jg = jax.tree.map(np.asarray, jax.jit(jax.value_and_grad(
        lambda p: jax_ed.train_loss(jcfg, p, jbatch, SH, remat)))(jp))
    loss, grads = loss_and_grads(
        build(cfg), params_from_jax(cfg, jp, device="cpu"),
        {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks)},
        remat)
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
    for blocks in ("enc_blocks", "dec_blocks"):
        assert float(grads[blocks]["attn"]["wq"].norm()) > 0
    assert float(grads["dec_blocks"]["xattn"]["wk"].norm()) > 0


# --------------------------------------------------- the layer changes
def _attn_inputs(cfg, s=6, seed=4):
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.hd
    p = {name: (rng.normal(size=shape) * 0.1).astype(np.float32)
         for name, shape in (("wq", (d, cfg.n_heads * hd)),
                             ("wk", (d, cfg.n_kv_heads * hd)),
                             ("wv", (d, cfg.n_kv_heads * hd)),
                             ("wo", (cfg.n_heads * hd, d)))}
    x = rng.normal(size=(B, s, d)).astype(np.float32)
    return p, x


def _case_bf16_prefill():
    """The bf16 prefill (the served dtype) against the JAX package's bf16
    prefill on the same bf16 weights, frames and tokens, within 2e-2."""
    jcfg, cfg = _cfgs("bfloat16")
    jp = _jax_params("bfloat16")
    tp = params_from_jax(cfg, jp, device="cpu")
    frames, toks = _inputs(cfg, S)
    jl, jcache, jcross = jax.jit(lambda p, f, t: jax_ed.prefill(
        jcfg, p, f, t, SH))(jp, _jax_dtype(frames, "bfloat16"),
                            jnp.asarray(toks))
    tl, cache, cross = encdec.prefill(cfg, tp, _torch_dtype(frames,
                                                            "bfloat16"),
                                      torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and cache[0].dtype == torch.bfloat16
    tol = TOL["bfloat16"]
    _close(tl, jl, "bf16 prefill logits", tol)
    for got, want, name in ((cache, jcache, "cache"), (cross, jcross,
                                                       "cross")):
        for side, g, w in zip("kv", got, want):
            _close(g, w, f"bf16 {name} {side}", tol)


def _case_sinusoidal_pos():
    """The sines then the cosines (not interleaved) of float32 angles, as
    in JAX. Bit equality is out of reach: XLA's float32 ``exp``, ``sin``
    and ``cos`` round the last bit differently from PyTorch's, and a
    frequency one ulp apart moves the angle at position p by up to p x
    2^-23. So the frequencies must agree within one ulp, and each entry
    within that angle error (times 1.5, the product's own rounding) plus
    2^-22."""
    for dim, n in ((64, 16), (64, 448), (1280, 1500)):
        pos = np.arange(n)
        want = np.asarray(jax_ed.sinusoidal_pos(jnp.asarray(pos), dim))
        got = encdec.sinusoidal_pos(torch.from_numpy(pos), dim)
        assert got.dtype == torch.float32 and got.shape == (n, dim)
        torch.testing.assert_close(got, encdec.sinusoidal(n, dim), rtol=0,
                                   atol=0)
        assert torch.equal(got[0], torch.cat([torch.zeros(dim // 2),
                                              torch.ones(dim // 2)]))
        bound = pos[:, None] * 1.5 * 2.0 ** -23 + 2.0 ** -22
        err = np.abs(got.numpy() - want)
        assert np.all(err <= bound), (dim, n, float((err - bound).max()))
        jf = np.asarray(jnp.exp(-jnp.arange(0, dim, 2, dtype=jnp.float32)
                                / dim * jnp.log(10000.0)))
        tf = torch.exp(-torch.arange(0, dim, 2, dtype=torch.float32) / dim
                       * torch.log(torch.tensor(10000.0))).numpy()
        np.testing.assert_array_max_ulp(tf, jf, maxulp=1)


def _case_no_rope():
    """``use_rope=False``: the kernel sees q and k exactly as projected,
    and the output is the JAX ``attention(use_rope=False)``'s."""
    jcfg, cfg = _cfgs()
    p, x = _attn_inputs(cfg)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x)
    positions = torch.arange(x.shape[1], dtype=torch.int32) + 5
    seen = []
    real = layers.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q, k))
        return real(q, k, v, **kw)

    layers.flash_attention = spy
    try:
        for causal in (True, False):
            out, _ = layers.attention(cfg, tp, xt, positions, causal=causal,
                                      use_rope=False)
            want, _ = jax_layers.attention(
                jcfg, p, jnp.asarray(x), jnp.asarray(positions.numpy()), SH,
                causal=causal, use_rope=False)
            _close(out, want, f"attention use_rope=False causal={causal}")
        rotated, _ = layers.attention(cfg, tp, xt, positions)
    finally:
        layers.flash_attention = real
    q, k, _ = layers._project_qkv(cfg, tp, xt)
    for got_q, got_k in seen[:2]:
        assert torch.equal(got_q, q) and torch.equal(got_k, k)
    assert not torch.equal(seen[2][0], q)  # the default rotates


def _case_attention_unchanged():
    """The default path the dense, MoE, hybrid and VLM families take is
    bit-equal to rope -> flash attention -> ``@ wo`` (the function before
    the enc-dec slice) and within 1e-5 of the JAX attention; and the new
    cross-attention is the JAX ``cross_attention`` over the JAX
    ``cross_kv``."""
    jcfg = dataclasses.replace(jax_reduced("qwen2.5-3b"),
                               param_dtype="float32", qkv_bias=False)
    cfg = dataclasses.replace(get_reduced("qwen2.5-3b"),
                              param_dtype="float32", qkv_bias=False)
    p, x = _attn_inputs(cfg)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x)
    positions = torch.arange(x.shape[1], dtype=torch.int32)
    out, _ = layers.attention(cfg, tp, xt, positions)
    q, k, v = layers._project_qkv(cfg, tp, xt)
    att = layers.flash_attention(layers.rope(q, positions, cfg.rope_theta),
                                 layers.rope(k, positions, cfg.rope_theta), v,
                                 causal=True)
    assert torch.equal(out, att.reshape(out.shape[0], out.shape[1], -1)
                       @ tp["wo"])
    want, _ = jax_layers.attention(jcfg, p, jnp.asarray(x),
                                   jnp.asarray(positions.numpy()), SH)
    _close(out, want, "default attention", 1e-5)
    jcfg, cfg = _cfgs()
    p, x = _attn_inputs(cfg, s=3)
    _, enc = _attn_inputs(cfg, s=11, seed=9)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    kv = layers.cross_kv(cfg, tp, torch.from_numpy(enc))
    jkv = jax_layers.cross_kv(jcfg, p, jnp.asarray(enc))
    for g, w in zip(kv, jkv):
        _close(g, w, "cross_kv", 1e-5)
    _close(layers.cross_attention(cfg, tp, torch.from_numpy(x), kv),
           jax_layers.cross_attention(jcfg, p, jnp.asarray(x), jkv, SH),
           "cross_attention", 1e-5)


@pytest.mark.parametrize("case", [_case_bf16_prefill, _case_sinusoidal_pos,
                                  _case_no_rope, _case_attention_unchanged],
                         ids=lambda f: f.__name__[6:])
def test_encdec_layer_cases(case):
    case()


# ----------------------------------------------- the training launcher
def _jax_draws(argv, monkeypatch):
    """Each step's batch of the JAX launcher (``repro.launch.train.main``),
    its train step replaced by one that keeps the batch."""
    seen = []

    def fake_step(model, opt_cfg, microbatches=1):
        def step(params, opt, batch):
            seen.append({k: np.asarray(v) for k, v in batch.items()})
            return params, opt, jnp.zeros((), jnp.float32)
        return step

    monkeypatch.setattr(jax_launch_train, "make_train_step", fake_step)
    monkeypatch.setattr(jax_launch_train, "jax", types.SimpleNamespace(
        jit=lambda f: f, random=jax.random))
    jax_launch_train.main(argv)
    return seen


def _port_draws(argv, monkeypatch):
    seen = []
    real = launch_train.make_train_step

    def keeping(*a, **kw):
        step = real(*a, **kw)

        def run(params, opt, batch):
            seen.append(dict(batch))
            return step(params, opt, batch)
        return run

    monkeypatch.setattr(launch_train, "make_train_step", keeping)
    launch_train.main(argv)
    monkeypatch.setattr(launch_train, "make_train_step", real)
    return seen


def _as_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


@pytest.mark.parametrize("arch,key", [("whisper-large-v3", "frames"),
                                      ("internvl2-26b", "img_embeds")])
def test_train_launcher_draws_the_jax_launchers_batches(arch, key, tmp_path,
                                                    monkeypatch):
    """``launch/train.py --device cpu`` trains each step on the tokens and
    the frames (image embeddings) the JAX launcher draws for it, bit for
    bit in the parameter dtype (bf16); a run resumed from a checkpoint at
    step 2 draws the uninterrupted run's batches for steps 2-4."""
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--seq", "8",
            "--docs", "4", "--log-every", "10"]
    want = _jax_draws(argv + ["--steps", "5"], monkeypatch)
    ck = str(tmp_path / "ck")
    port = argv + ["--device", "cpu", "--ckpt-dir", ck]
    first = _port_draws(port + ["--steps", "2"], monkeypatch)
    resumed = _port_draws(port + ["--steps", "5", "--resume"], monkeypatch)
    assert len(want) == 5 and len(first) == 2 and len(resumed) == 3
    for step, got in enumerate(first + resumed):
        assert set(got) == {"tokens", key}, step
        cfg = get_reduced(arch)
        n = cfg.n_frames if key == "frames" else cfg.n_img_tokens
        assert got[key].shape == (2, n, cfg.d_model)
        assert got[key].dtype == cfg.dtype
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      want[step]["tokens"])
        np.testing.assert_array_equal(_as_numpy(got[key]),
                                      want[step][key].view(np.int16),
                                      err_msg=f"{key} at step {step}")
