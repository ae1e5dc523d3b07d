"""The port's training path against the JAX package, on the CPU:

- the attention backward by recompute (``flash_attention_bwd_ref``, the
  card route's backward) against autograd of the plain version and
  ``jax.grad`` of the JAX ``_sdpa`` (rtol 1e-5, atol 1e-6; query blocks of
  512 rows, so Sq 513 and 1,100 end in partial blocks), and the card
  route's autograd wiring on a CPU stand-in for the kernel;
- ``softmax_xent`` (rtol 1e-6, pad-vocab columns and a mask);
- ``train_loss`` (rtol 1e-5) and one step's gradient of every leaf
  (rtol 1e-4, atol 1e-6) on the reduced smollm-135m, qwen2.5-3b (qkv bias)
  and yi-34b (untied ``lm_head``) configs cut to 2 layers, in float32,
  weights carried by ``params_from_jax``;
- every remat policy gives bit-equal losses and gradients;
- ``launch.train.main`` on the CPU: trains, checkpoints, and a run that
  crashes after a checkpoint resumes to the uninterrupted run's losses.

The gpu-marked tests hold the card's attention gradients and one train
step to the CPU's.
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
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tf
from repro_torch.configs import get_reduced
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_ref)
from repro_torch.models import build, layers, params_from_jax
from repro_torch.models.spec import tree_leaves
from repro_torch.train.train_step import loss_and_grads

SH = lambda x, *a: x  # noqa: E731  (the JAX identity sharder)
ARCHS = ["smollm-135m", "qwen2.5-3b", "yi-34b"]
B, S = 2, 32


def _attn_inputs(seed, b, sq, sk, h, kvh, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, sq, h, hd), (b, sk, kvh, hd), (b, sk, kvh, hd),
                          (b, sq, h, hd))]


# (Sq, rep, causal, q_offset): Sk = Sq + q_offset
@pytest.mark.parametrize("sq,rep,causal,q_offset", [
    (1, 3, True, 37), (511, 3, True, 0), (513, 1, True, 5),
    (513, 3, False, 0), (1100, 3, True, 100), (1100, 1, False, 0)])
def test_attention_backward_matches_autograd_and_jax(sq, rep, causal,
                                                     q_offset):
    kvh, hd = 2, 8
    q, k, v, do = _attn_inputs(sq + rep, 1, sq, sq + q_offset, kvh * rep, kvh,
                               hd)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    got = flash_attention_bwd_ref(tq, tk, tv, tdo, causal=causal,
                                  q_offset=q_offset)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = flash_attention_ref(*leaves, causal=causal, q_offset=q_offset)
    want = torch.autograd.grad(out, leaves, tdo)

    def jax_out(q_, k_, v_):
        o = jax_layers._sdpa(q_, k_, v_, causal=causal,
                             q_offset=q_offset if causal else None)
        return jnp.sum(o * do)

    want_jax = jax.jit(jax.grad(jax_out, argnums=(0, 1, 2)))(
        *(jnp.asarray(x) for x in (q, k, v)))
    for g, w, wj, name in zip(got, want, want_jax, "qkv"):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"d{name} vs autograd")
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), rtol=1e-5,
                                   atol=1e-6, err_msg=f"d{name} vs jax")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_route_autograd_wiring(dtype):
    """The card route is the registered op ``repro_torch::flash_attention``,
    whose implementation autograd does not see into (on the card the
    ctypes launch; on the CPU, run here, the plain version computed inside
    the op): the gradients reach q, k and v through the op's registered
    backward and equal the plain version's; the launch alone, filling its
    output outside autograd (fault F1), gives none."""
    def fake_launch(q, k, v, causal, q_offset):
        with torch.no_grad():
            return flash_attention_ref(q, k, v, causal=causal,
                                       q_offset=q_offset)

    q, k, v, do = (torch.from_numpy(x).to(dtype)
                   for x in _attn_inputs(9, 2, 40, 45, 6, 2, 16))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, _ = torch.ops.repro_torch.flash_attention(*leaves, True, 5, False)
    got = torch.autograd.grad(out, leaves, do)
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*ref_leaves, causal=True,
                                                   q_offset=5), ref_leaves, do)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g, w, rtol=1e-5 if dtype == torch.float32
                                   else 1e-2, atol=1e-5)
    assert not fake_launch(*leaves, True, 5).requires_grad  # F1's route


def test_cpu_attention_never_launches_in_training():
    q, k, v, do = (torch.from_numpy(x) for x in _attn_inputs(3, 1, 8, 8, 2,
                                                              2, 16))
    q.requires_grad_()
    reset_launches()
    torch.autograd.grad(flash_attention(q, k, v), q, do)
    assert LAUNCHES["flash_attention"] == 0


def test_softmax_xent_matches_jax():
    jcfg, cfg = jax_reduced("smollm-135m"), get_reduced("smollm-135m")
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(3, 7, cfg.vocab_padded)) * 3).astype(
        np.float32)
    labels = rng.integers(0, cfg.vocab, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.7).astype(np.float32)
    for m in (mask, None, np.zeros_like(mask)):
        want = jax_layers.softmax_xent(
            jcfg, jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        got = layers.softmax_xent(
            cfg, torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # the pad-vocab columns take no part: a huge logit there changes nothing
    big = logits.copy()
    big[..., cfg.vocab:] = 1e4
    np.testing.assert_allclose(
        float(layers.softmax_xent(cfg, torch.from_numpy(big),
                                  torch.from_numpy(labels))),
        float(layers.softmax_xent(cfg, torch.from_numpy(logits),
                                  torch.from_numpy(labels))), rtol=1e-6)


def _cfgs(arch, layers_=2):
    return (dataclasses.replace(jax_reduced(arch), param_dtype="float32",
                                n_layers=layers_),
            dataclasses.replace(get_reduced(arch), param_dtype="float32",
                                n_layers=layers_))


@functools.lru_cache(maxsize=None)
def _jax_train_loss(arch):
    """JAX ``init_params`` (key 0) of ``_cfgs(arch)``, then ``train_loss``
    of ``_tokens`` and its gradients, in one jitted call; as numpy."""
    jcfg, cfg = _cfgs(arch)
    specs = jax_build(jcfg).param_specs
    toks = jnp.asarray(_tokens(cfg))

    def run(key):
        params = jax_init(specs, key)
        return params, jax.value_and_grad(lambda p: jax_tf.train_loss(
            jcfg, p, {"tokens": toks}, SH))(params)

    return jax.tree.map(np.asarray, jax.jit(run)(jax.random.key(0)))


def _tokens(cfg, seed=3):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(arch):
    _, cfg = _cfgs(arch)
    jp, (jl, jg) = _jax_train_loss(arch)
    toks = _tokens(cfg)
    loss, grads = loss_and_grads(build(cfg), params_from_jax(
        cfg, jp, device="cpu"), {"tokens": torch.from_numpy(toks)})
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(flat) == len(tree_leaves(grads))
    for path, want in flat:
        got = grads
        for key in path:
            got = got[key.key]
        name = "/".join(str(key.key) for key in path)
        assert got.shape == want.shape, name
        if name == "embed/embedding":  # pad rows take no gradient
            assert not np.asarray(want)[cfg.vocab:].any()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_remat_policies_agree_bit_for_bit():
    _, cfg = _cfgs("qwen2.5-3b")
    params = params_from_jax(cfg, _jax_train_loss("qwen2.5-3b")[0],
                             device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 5))}
    model = build(cfg)
    runs = {r: loss_and_grads(model, params, batch, r)
            for r in layers.REMAT_POLICIES}
    assert set(runs) == {"none", "nothing", "dots", "dots_no_batch"}
    loss0, g0 = runs["none"]
    for remat, (loss, g) in runs.items():
        assert torch.equal(loss, loss0), remat
        for a, b in zip(tree_leaves(g), tree_leaves(g0)):
            assert torch.equal(a, b), remat
    with pytest.raises(KeyError):
        model.train_loss(params, batch, "everything")


def test_train_main_checkpoints_and_resumes(tmp_path, monkeypatch):
    """``launch.train.main`` on the CPU: an uninterrupted run of 6 steps;
    a run that dies after its step-3 checkpoint, then resumes to step 6
    with the same losses (the skipped batches are drawn again); the
    checkpoints' steps and LATEST."""
    _train_main_crash_and_resume("smollm-135m", tmp_path, monkeypatch)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-2.7b",
                                  "zamba2-2.7b"])
def test_train_main_trains_each_family(arch, tmp_path, monkeypatch):
    """The same run, crash and resume through ``launch.train.main`` for
    the MoE, Mamba2 and hybrid families' reduced configs."""
    _train_main_crash_and_resume(arch, tmp_path, monkeypatch)


def _train_main_crash_and_resume(arch, tmp_path, monkeypatch):
    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint

    argv = ["--arch", arch, "--reduced", "--device", "cpu",
            "--steps", "6", "--batch", "2", "--seq", "16", "--docs", "8",
            "--log-every", "1", "--ckpt-every", "3"]
    whole = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    assert len(whole) == 6 and all(np.isfinite(whole))
    assert checkpoint.latest_step(str(tmp_path / "a")) == 6

    class Crash(Exception):
        pass

    save = checkpoint.save

    def save_then_die(ckpt_dir, step, tree, **kw):
        save(ckpt_dir, step, tree, **kw)
        raise Crash(step)

    monkeypatch.setattr(checkpoint, "save", save_then_die)
    with pytest.raises(Crash):
        launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    monkeypatch.setattr(checkpoint, "save", save)
    assert checkpoint.latest_step(str(tmp_path / "b")) == 3
    resumed = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "b"),
                                        "--resume"])
    assert resumed == whole[3:]
    assert checkpoint.latest_step(str(tmp_path / "b")) == 6


def test_train_main_needs_the_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--reduced", "--steps", "1"])
    losses = main(["--arch", "whisper-large-v3", "--reduced", "--steps", "1",
                   "--batch", "2", "--seq", "8", "--docs", "4",
                   "--device", "cpu"])
    assert len(losses) == 1 and np.isfinite(losses[0])


# ------------------------------------------------------------------ card
@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 16, 513, 2048])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
def test_card_attention_gradients_match_cpu(hd, dtype, causal, sq):
    """dq, dk and dv through ``flash_attention`` on the card (the kernel
    forward, the plain recompute backward) against the same function's on
    the CPU: float32 within rtol 1e-4; bf16 with an error norm within 1e-2
    of the gradient's. One forward launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kvh, rep = 2, 3
    off = 7 if causal else 0
    q, k, v, do = (torch.from_numpy(x).to(getattr(torch, dtype))
                   for x in _attn_inputs(sq + hd, 2, sq, sq + off, kvh * rep,
                                         kvh, hd))
    cpu = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(flash_attention(*cpu, causal=causal,
                                               q_offset=off), cpu, do)
    card = [x.cuda().requires_grad_() for x in (q, k, v)]
    reset_launches()
    out = flash_attention(*card, causal=causal, q_offset=off)
    got = torch.autograd.grad(out, card, do.cuda())
    assert LAUNCHES["flash_attention"] == 1
    for g, w, name in zip(got, want, "qkv"):
        g = g.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if dtype == "float32":
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
        else:
            rel = float((g.float() - w.float()).norm()
                        / w.float().norm().clamp_min(1e-30))
            assert rel <= 1e-2, (name, rel)


@pytest.mark.gpu
def test_card_attention_refuses_other_head_dims_in_training():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # hd 32: the kernel is built for 8, 16, 64, 80, 112 and 128
    q = torch.zeros(1, 4, 2, 32, device="cuda", requires_grad=True)
    with pytest.raises(ValueError, match="hd"):
        flash_attention(q, q.detach(), q.detach())


@pytest.mark.gpu
def test_card_train_step_matches_cpu():
    """One ``make_train_step`` step on the card against the CPU at a
    2-layer hd-64 float32 config: every leaf's gradient norm > 0, the
    loss within 1e-4 and the gradients within rtol 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(get_reduced("smollm-135m"), d_model=192,
                              n_heads=3, n_kv_heads=1, head_dim=64,
                              n_layers=2, param_dtype="float32")
    from repro_torch.models import init_params
    from repro_torch.models.spec import tree_map
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    model = build(cfg)
    params = init_params(model.param_specs, torch.Generator().manual_seed(0))
    batch = {"tokens": torch.from_numpy(_tokens(cfg))}
    card_params = tree_map(lambda p: p.cuda(), params)
    card_batch = {"tokens": batch["tokens"].cuda()}
    loss, grads = loss_and_grads(model, params, batch)
    reset_launches()
    closs, cgrads = loss_and_grads(model, card_params, card_batch)
    assert LAUNCHES["flash_attention"] == 2 * cfg.n_layers  # remat: twice
    torch.testing.assert_close(closs.cpu(), loss, rtol=1e-4, atol=1e-4)
    for a, b in zip(tree_leaves(cgrads), tree_leaves(grads)):
        assert float(a.norm()) > 0
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-5)
    opt_cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    step = make_train_step(model, opt_cfg)
    p1, _, l1 = step(params, adamw_init(params, opt_cfg), batch)
    cp1, _, cl1 = step(card_params, adamw_init(card_params, opt_cfg),
                       card_batch)
    torch.testing.assert_close(cl1.cpu(), l1, rtol=1e-4, atol=1e-4)
    for a, b in zip(tree_leaves(cp1), tree_leaves(p1)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-4)
