"""A DTensor train step on real ranks whose head counts the model axis does
not divide, against the JAX package's gradients on the same weights.

Four gloo ranks (spawned, ``file://`` rendezvous, joined under a timeout)
on a (1, 4) ("data", "model") mesh (and a (2, 2) one) with the dry run's
production rules
(``dryrun.rules_for``): the parameters and the batch are DTensors placed
by ``sharding_tree``, and ``train_step.loss_and_grads`` runs as a user
calls it, with no ``ReshardOnRefusal``. The projections shard q, k and v
on their flattened heads dim; ``sharded_attention.split_heads`` takes them
to DTensor's uneven split of the heads dim (ceil(H / 4) a rank, the last
ranks none) and the attention's "heads" case brings each rank the KV
heads its queries use. Cases (float32, reduced widths, 2 layers):

* smollm-135m: 3 heads over 3 KV heads (hd 16); rank 3 holds no head;
* qwen2.5-3b with 6 heads over its 2 KV heads: ranks 0-2 hold two query
  heads each, rank 1's use both KV heads, which ranks 0 and 1 hold;
* qwen2.5-3b at its published ratio, 16 heads over 2 KV heads (GQA rep 8,
  hd 16): each rank holds 4 query heads, the KV heads split [1, 1, 0, 0],
  so rank 1 holds KV head 1 while its queries use KV head 0, and ranks 2
  and 3 hold none;
* whisper-large-v3 with 6 heads (as its 20 heads on a 16-wide axis: the
  last ranks none): the encoder's non-causal attention, the decoder's
  self and cross attention;
* smollm-135m on a (2, 2) mesh: 2 heads and 1 on the model axis, the
  batch and the embedding table's embed dim split on the data axis (the
  table gathered for the train step's 256 tokens a rank, the tokens for
  a decode step's few).

Then, for the dense cases, a prefill into a cache sequence-sharded on
the model axis (``sharded_attention.write_cache`` takes each rank's rows
from the heads placement by one all-to-all) and two decode steps, held to
the plain path on the same weights.

The weights and the batch are numpy draws from a seed (each normal leaf
at std 0.02); the JAX side is ``jax.value_and_grad`` of its
``train_loss`` on them in this process, while the ranks run. Held:
the loss and every gradient leaf within rtol 1e-5 (atol 1e-5 of the
leaf's largest entry), the same on every rank; no attention fallback; a
rank with no heads makes no #7 call.
"""
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_reduced as jax_reduced
from repro.models import build as jax_build

N_RANKS, B, S, LAYERS = 4, 4, 24, 2
JOIN_S = 120
# case -> (arch, config changes, mesh shape ("data", "model"), batch, seq)
CASES = {"smollm": ("smollm-135m", {}, (1, 4), B, S),
         "gqa": ("qwen2.5-3b", {"n_heads": 6}, (1, 4), B, S),
         "gqa_rep8": ("qwen2.5-3b", {"n_heads": 16, "head_dim": 16},
                      (1, 4), B, S),
         "whisper": ("whisper-large-v3", {"n_heads": 6, "n_kv_heads": 6},
                     (1, 4), B, S),
         "smollm_2x2": ("smollm-135m", {}, (2, 2), 8, 64)}


def _cfg(case, jax_side):
    from repro_torch.configs import get_reduced
    arch, kw = CASES[case][:2]
    base = (jax_reduced if jax_side else get_reduced)(arch)
    return dataclasses.replace(base, param_dtype="float32", n_layers=LAYERS,
                               **kw)


def _params(specs, seed):
    """A numpy draw of every leaf of the JAX spec tree ``specs``."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree.flatten(specs, is_leaf=lambda x: hasattr(
        x, "init"))
    out = []
    for s in leaves:
        if s.init in ("zeros", "ones"):
            x = np.full(s.shape, 1.0 if s.init == "ones" else 0.0)
        else:
            x = rng.normal(size=s.shape) * 0.02
        out.append(x.astype(np.float32))
    return jax.tree.unflatten(tree, out)


def _batch(case):
    cfg = _cfg(case, True)
    b, s = CASES[case][3:]
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(1, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = (rng.normal(size=(b, cfg.n_frames, cfg.d_model))
                         * 0.02).astype(np.float32)
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _nest(flat):
    out = {}
    for name, x in flat.items():
        *path, last = name.split("/")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[last] = x
    return out


# ------------------------------------------------------------ the ranks
def _rank_main(rank, rdv, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=N_RANKS, rank=rank)
    try:
        _rank_body(rank, d)
    finally:
        dist.destroy_process_group()


def _rank_body(rank, d):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch import dryrun
    from repro_torch.models import (build, make_sharder, params_from_jax,
                                    sharded_attention, sharding_tree)
    from repro_torch.models.spec import flatten_up_to, tree_map
    from repro_torch.train.train_step import loss_and_grads
    meshes = {shape: init_device_mesh("cpu", shape,
                                      mesh_dim_names=("data", "model"))
              for shape in sorted({c[2] for c in CASES.values()})}
    rules = dryrun.rules_for(False)
    calls = []
    kernel = sharded_attention.flash_attention
    sharded_attention.flash_attention = \
        lambda *a, **kw: calls.append(1) or kernel(*a, **kw)
    mine = {}
    for case, (_, _, shape, b, s) in CASES.items():
        mesh = meshes[shape]
        cfg = _cfg(case, False)
        model = build(cfg)
        sh = make_sharder(rules, mesh)
        arrays = dict(np.load(os.path.join(d, f"{case}_params.npz")))
        params = params_from_jax(cfg, _nest(arrays), device="cpu")
        pls = flatten_up_to(model.param_specs, sharding_tree(
            model.param_specs, rules, mesh))
        leaves = iter(distribute_tensor(p, mesh, list(pl)) for p, pl in zip(
            flatten_up_to(model.param_specs, params), pls))
        dparams = tree_map(lambda _: next(leaves), model.param_specs)
        batch_np = dict(np.load(os.path.join(d, f"{case}_batch.npz")))
        specs = model.train_input_specs(b, s)
        bpl = sharding_tree(specs, rules, mesh)
        batch = {k: distribute_tensor(torch.from_numpy(x), mesh,
                                      list(bpl[k]))
                 for k, x in batch_np.items()}
        calls.clear()
        loss, grads = loss_and_grads(model, dparams, batch, "dots_no_batch",
                                     sh)
        mine[f"{case}/loss"] = loss.full_tensor().numpy()
        for name, g in _flat(grads).items():
            mine[f"{case}/grad/{name}"] = g.full_tensor().numpy()
        mine[f"{case}/calls"] = np.array(len(calls))
        mine[f"{case}/fallbacks"] = np.array(sum(sh.fallbacks.values()))
        if cfg.family == "dense":  # serving: the cache written by rows
            for tag, hook, p, toks in (
                    ("dtensor", sh, dparams, batch["tokens"]),
                    ("plain", None, params,
                     torch.from_numpy(batch_np["tokens"]))):
                logits, cache = model.prefill(
                    p, {"tokens": toks[:, :s - 2], "max_len": s + 8},
                    hook)
                out = [logits]
                for t in range(s - 2, s):
                    logits, cache = model.decode(p, {
                        "token": toks[:, t:t + 1], "cache": cache,
                        "pos": t}, hook)
                    out.append(logits)
                mine[f"{case}/serve/{tag}"] = torch.cat(
                    [_whole(x) for x in out], 1).numpy()
                mine[f"{case}/cache/{tag}"] = np.stack(
                    [_whole(x).float().numpy() for x in cache])
    np.savez(os.path.join(d, f"rank{rank}.npz"), **mine)


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _spawn(fn, args, n_ranks, timeout=JOIN_S):
    import torch.multiprocessing as tmp
    ctx = tmp.start_processes(fn, args=args, nprocs=n_ranks, join=False,
                              start_method="spawn")
    return ctx, time.monotonic() + timeout


def _join(ctx, deadline, timeout=JOIN_S):
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
    d = tmp_path_factory.mktemp("mesh_heads")
    jax_side = {}
    for i, case in enumerate(CASES):
        model = jax_build(_cfg(case, True))
        params = _params(model.param_specs, i)
        batch = _batch(case)
        np.savez(d / f"{case}_params.npz",
                 **_flat(params))
        np.savez(d / f"{case}_batch.npz", **batch)
        jax_side[case] = (model, params, batch)
    ctx, deadline = _spawn(_rank_main, (str(d / "rdv"), str(d)), N_RANKS)
    want = {}
    try:  # the JAX side while the ranks run
        for case, (model, params, batch) in jax_side.items():
            jb = {k: jnp.asarray(x) for k, x in batch.items()}
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: model.train_loss(p, jb, lambda x, *a: x)))(params)
            want[f"{case}/loss"] = np.asarray(loss)
            for name, g in _flat(grads).items():
                want[f"{case}/grad/{name}"] = np.asarray(g)
    finally:
        _join(ctx, deadline)
    got = [dict(np.load(d / f"rank{r}.npz")) for r in range(N_RANKS)]
    return want, got


# ----------------------------------------------------------------- tests
@pytest.mark.parametrize("case", list(CASES))
def test_dtensor_step_matches_jax(runs, case):
    want, got = runs
    names = [k for k in want if k.startswith(case + "/")]
    assert names and all(k in got[0] for k in names)
    for name in names:
        w = want[name]
        atol = 1e-5 * float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(got[0][name], w, rtol=1e-5, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["smollm", "gqa", "gqa_rep8", "smollm_2x2"])
def test_dtensor_prefill_and_decode_match_the_plain_path(runs, case):
    """A prefill of all but 2 tokens into a cache sequence-sharded over the
    model axis (written from the heads placement by one all-to-all a
    tensor), then 2 decode steps: logits and cache equal the plain
    path's."""
    _, got = runs
    for what in ("serve", "cache"):
        np.testing.assert_allclose(got[0][f"{case}/{what}/dtensor"],
                                   got[0][f"{case}/{what}/plain"],
                                   rtol=1e-5, atol=1e-6, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_holds_the_same_values(runs, case):
    _, got = runs
    for r in range(1, N_RANKS):
        for name in got[0]:
            if name.startswith(case + "/") and not name.endswith("calls"):
                np.testing.assert_array_equal(got[r][name], got[0][name],
                                              err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_heads_case_no_fallback_and_no_launch_without_heads(runs, case):
    """No attention ran replicated; #7 calls a rank: its attentions
    (forward and the remat's recompute) where it holds heads, none on
    rank 3 of the 4-wide axis, which holds none of 3 or 6 heads (ceil(H /
    4) a rank)."""
    from repro_torch.models.sharded_attention import head_chunks
    _, got = runs
    cfg = _cfg(case, False)
    n_model = CASES[case][2][1]
    per_layer = 3 if cfg.family == "encdec" else 1  # enc, dec self, cross
    for r in range(N_RANKS):
        assert int(got[r][f"{case}/fallbacks"]) == 0, r
        lo, hi = head_chunks(cfg.n_heads, n_model)[r % n_model]
        want = 2 * per_layer * LAYERS if hi > lo else 0
        assert int(got[r][f"{case}/calls"]) == want, (r, lo, hi)


@pytest.mark.parametrize("h,kvh,n,want", [
    (9, 3, 16, [[0]] * 3 + [[1]] * 3 + [[2]] * 3 + [[]] * 7),
    (16, 2, 16, [[0]] * 8 + [[1]] * 8),
    (6, 2, 4, [[0], [0, 1], [1], []]),
    (20, 20, 16, [[2 * r, 2 * r + 1] for r in range(10)] + [[]] * 6),
    (8, 2, 4, [[0], [0], [1], [1]]),
    (12, 4, 8, [[0], [0, 1], [1], [2], [2, 3], [3], [], []]),
    (9, 3, 2, [[0, 0, 0, 1, 1], [1, 2, 2, 2]]),
    (4, 2, 1, [[0, 1]]),
])
def test_kv_heads_follow_the_query_heads(h, kvh, n, want):
    """The KV heads a rank's query heads use, in #7's GQA order: each once
    where the rank's heads map onto them as #7 maps groups, else one per
    query head (9 over 3 on 2 ranks: heads 0-4 use KV 0, 0, 0, 1, 1)."""
    from repro_torch.models.sharded_attention import (_kv_heads_needed,
                                                      head_chunks)
    got = [_kv_heads_needed(h, kvh, lo, hi) for lo, hi in head_chunks(h, n)]
    assert got == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gold_logit_is_the_gather_bit_for_bit(dtype):
    """On plain tensors the loss's gold logit, now a masked sum over the
    vocab, and its gradient equal the gather it replaced bit for bit (the
    other terms are exact zeros), pad columns and a mask among the
    inputs."""
    from repro_torch.models import layers
    cfg = _cfg("smollm", False)
    g = torch.Generator().manual_seed(11)
    logits = (torch.randn(3, 10, cfg.vocab_padded, generator=g) * 4).to(
        dtype)
    labels = torch.randint(0, cfg.vocab, (3, 10), generator=g)
    mask = (torch.rand(3, 10, generator=g) > 0.3).float()

    def gathered(x):
        x = x.float()
        keep = torch.arange(x.shape[-1])[None, None, :] < cfg.vocab
        x = torch.where(keep, x, torch.full((), -1e30))
        nll = torch.logsumexp(x, -1) - torch.gather(
            x, -1, labels[..., None])[..., 0]
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    a = logits.clone().requires_grad_()
    b = logits.clone().requires_grad_()
    got = layers.softmax_xent(cfg, a, labels, mask)
    want = gathered(b)
    got.backward()
    want.backward()
    assert torch.equal(got, want)
    assert torch.equal(a.grad, b.grad)
