"""#7's log-sum-exp, #7 as a registered op, and the port's attention on a
device mesh (``models.sharded_attention``) against the JAX package's
``_blocked_sdpa`` (its ``attn_q`` context parallelism) and ``_sdpa`` over
a sequence-sharded cache, on the same numpy inputs.

* The plain version's lse equals a float64 ``logsumexp``; the merge of key
  shards' ``(o, lse)`` equals the whole within 1e-6 in float32, an empty
  shard and a row that keeps no key among the cases.
* The op: its fake implementation allocates o and lse only; ``OpCost``
  counts it by the causal-triangle formula; a plain CPU tensor's result
  is bit-equal to the plain version's; a DTensor never reaches the
  launch.
* The JAX side runs once, in a subprocess with 4 fake XLA host devices on
  a (1, 4) ("data", "model") mesh with JAX's ``make_sharder``: the reduced
  smollm-135m width (3 heads, hd 16) at Sq 4,096, causal, forward and the
  gradients of q, k and v; and decode rows over a 256-slot cache sharded
  on ``kv_seq``. The port runs on 4 gloo ranks (spawned, ``file://``
  rendezvous, joined under a timeout), on DTensors and on full values;
  within 1e-4 in float32 (``test_torch_lm.py``'s attention tolerance: the
  blocked scan and the merge add in other orders).
* A dry run on a fake 2 x 4 world at the reduced width and Sq 4,096 holds
  no scores (its peak temporaries stay below one layer's plain scores)
  and falls back nowhere (3 heads on the 4-wide axis).
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.kernels.flash_attention import (attention_cost,
                                                 flash_attention,
                                                 flash_attention_ref,
                                                 merge_shards_ref)
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import sharded_attention

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 120
TOL = dict(rtol=1e-4, atol=1e-4)
B, SQ, H, KV, HD = 1, 4096, 3, 3, 16  # the reduced smollm-135m's heads
SMAX = 256  # the decode cache's slots: 64 a rank
# decode cases: (rows, position of row 0); rank r holds slots 64r..64r+63
DECODES = ((1, 255), (1, 150), (3, 126), (2, 5))

JAX_SCRIPT = r'''
import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import numpy as np

from repro.compat import make_mesh_auto
from repro.models import layers
from repro.models.spec import ShardingRules, make_sharder

inp = dict(np.load(sys.argv[1]))
mesh = make_mesh_auto((1, 4), ("data", "model"), devices=jax.devices())
rules = ShardingRules(batch=("data",), model="model", kv_seq="model")
sh = make_sharder(rules, mesh)
q, k, v, g = (jnp.asarray(inp[n]) for n in ("q", "k", "v", "g"))


def loss(q, k, v):
    o = layers._blocked_sdpa(q, k, v, sh, causal=True)
    return jnp.sum(o * g), o


out = {}
with mesh:
    (_, o), (dq, dk, dv) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    for name, x in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        out["context/" + name] = np.asarray(x)
    ck, cv = jnp.asarray(inp["ck"]), jnp.asarray(inp["cv"])
    for key in [k for k in inp if k.startswith("dq_")]:
        pos = int(key.split("_")[2])
        fn = jax.jit(lambda q, ck, cv: layers._sdpa(
            q, sh(ck, "batch", "kv_seq", None, None),
            sh(cv, "batch", "kv_seq", None, None), causal=True,
            q_offset=pos))
        out["decode/" + key] = np.asarray(fn(jnp.asarray(inp[key]), ck, cv))
np.savez(sys.argv[2], **out)
'''


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(size=s).astype(np.float32) for n, s in (
        ("q", (B, SQ, H, HD)), ("k", (B, SQ, KV, HD)), ("v", (B, SQ, KV, HD)),
        ("g", (B, SQ, H, HD)), ("ck", (2, SMAX, KV, HD)),
        ("cv", (2, SMAX, KV, HD)), ("new", (2, 3, KV, HD)))}
    for rows, pos in DECODES:
        out[f"dq_{rows}_{pos}"] = rng.normal(size=(2, rows, H, HD)).astype(
            np.float32)
    return out


# ------------------------------------------------------------ the ranks
def _rank_main(rank, rdv, inputs, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=4, rank=rank)
    try:
        _rank_body(rank, dict(np.load(inputs)), out_path)
    finally:
        dist.destroy_process_group()


def _rank_body(rank, inp, out_path):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import ShardingRules, make_sharder, placements
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    rules = ShardingRules(batch=("data",), model="model", kv_seq="model")
    sh = make_sharder(rules, mesh)
    t = {n: torch.from_numpy(x) for n, x in inp.items()}
    mine = {}
    # context parallelism on DTensors: q whole on the model axis, or its
    # 3 heads unevenly sharded over the 4 ranks (gathered first)
    for tag, q_pl in (("dtensor", [Replicate(), Replicate()]),
                      ("dtensor_heads", [Replicate(), Shard(2)])):
        q = distribute_tensor(t["q"], mesh, q_pl).requires_grad_()
        k, v = (distribute_tensor(t[n], mesh, [Replicate()] * 2)
                .requires_grad_() for n in ("k", "v"))
        o = sharded_attention.attend(q, k, v, sh, causal=True, blocked=True)
        g = distribute_tensor(t["g"], mesh, [Replicate()] * 2)
        (o * g).sum().backward()
        mine[f"{tag}/context/o"] = o.detach().full_tensor()
        for n, x in (("dq", q), ("dk", k), ("dv", v)):
            mine[f"{tag}/context/{n}"] = x.grad.full_tensor()
    # the same on full values: every rank holds the whole result and grads
    q, k, v = (t[n].clone().requires_grad_() for n in ("q", "k", "v"))
    o = sharded_attention.attend(q, k, v, sh, causal=True, blocked=True)
    (o * t["g"]).sum().backward()
    mine["full/context/o"] = o.detach()
    for n, x in (("dq", q), ("dk", k), ("dv", v)):
        mine[f"full/context/{n}"] = x.grad
    # decode over the kv_seq-sharded cache, counted by OpCost
    pk = placements(rules.pspec_for_shape(t["ck"].shape, (
        "batch", "kv_seq", None, None), mesh), mesh)
    ck, cv = (distribute_tensor(t[n], mesh, pk) for n in ("ck", "cv"))
    colls, launches = {}, {}
    calls = []  # this rank's #7 calls (on the CPU: its plain version)
    kernel = sharded_attention.flash_attention
    sharded_attention.flash_attention = \
        lambda *a, **kw: calls.append(1) or kernel(*a, **kw)
    for rows, pos in DECODES:
        key = f"dq_{rows}_{pos}"
        qd = distribute_tensor(t[key], mesh, [Replicate()] * 2)
        calls.clear()
        with OpCost() as c:
            o = sharded_attention.attend(qd, ck, cv, sh, causal=True,
                                         q_offset=pos, kv_sharded=True)
        colls[key] = c.cost.coll_counts
        launches[key] = len(calls)
        mine[f"dtensor/decode/{key}"] = o.full_tensor()
        mine[f"full/decode/{key}"] = sharded_attention.attend(
            t[key], t["ck"], t["cv"], sh, causal=True, q_offset=pos,
            kv_sharded=True)
    # a write of 3 rows across the boundary of ranks 1 and 2, each rank
    # into its own slots
    ckw = distribute_tensor(t["ck"].clone(), mesh, pk)
    assert sharded_attention.write_cache(ckw, distribute_tensor(
        t["new"], mesh, [Replicate()] * 2), 126)
    mine["write"] = ckw.full_tensor()
    mine = {k: v.numpy() for k, v in mine.items()}
    got = [None] * 4 if rank == 0 else None
    dist.gather_object((mine, colls, launches), got, dst=0)
    if rank == 0:
        flat = {}
        for r, (arrs, cl, ln) in enumerate(got):
            flat.update({f"{r}/{k}": v for k, v in arrs.items()})
            for key in cl:
                flat[f"{r}/colls/{key}"] = np.array(sorted(cl[key].items()),
                                                    dtype=object)
                flat[f"{r}/launches/{key}"] = np.array(ln[key])
        np.savez(out_path, **flat)


def _spawn(fn, args, n_ranks, timeout=JOIN_S):
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_attention")
    inputs = d / "inputs.npz"
    np.savez(inputs, **_inputs())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    jax_out = d / "jax.npz"
    jax = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(inputs),
                            str(jax_out)], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    port_out = d / "port.npz"
    try:
        _spawn(_rank_main, (str(d / "rdv"), str(inputs), str(port_out)), 4)
        _, err = jax.communicate(timeout=300)
    finally:
        if jax.poll() is None:
            jax.kill()
            jax.wait()
    assert jax.returncode == 0, err[-3000:]
    return (dict(np.load(inputs)), dict(np.load(jax_out)),
            dict(np.load(port_out, allow_pickle=True)))


# -------------------------------------------------- against JAX, 4 ranks
@pytest.mark.parametrize("what", ["o", "dq", "dk", "dv"])
@pytest.mark.parametrize("mode", ["dtensor", "dtensor_heads", "full"])
def test_context_parallel_matches_jax_blocked_sdpa(runs, mode, what):
    _, jx, port = runs
    for r in range(4):
        np.testing.assert_allclose(port[f"{r}/{mode}/context/{what}"],
                                   jx[f"context/{what}"], **TOL,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("rows,pos", DECODES)
@pytest.mark.parametrize("mode", ["dtensor", "full"])
def test_kv_seq_decode_matches_jax_sdpa(runs, mode, rows, pos):
    _, jx, port = runs
    key = f"dq_{rows}_{pos}"
    for r in range(4):
        np.testing.assert_allclose(port[f"{r}/{mode}/decode/{key}"],
                                   jx[f"decode/{key}"], **TOL,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("rows,pos", DECODES)
def test_kv_seq_decode_gathers_no_cache(runs, rows, pos):
    """OpCost over the DTensor decode: two all-reduces (the lse max, then
    the weighted sums), no all-gather; a rank launches #7 only where some
    row reaches its slots."""
    _, _, port = runs
    key = f"dq_{rows}_{pos}"
    for r in range(4):
        colls = dict(port[f"{r}/colls/{key}"])
        assert colls == {"all-reduce": 2}, (r, colls)
        reaches = pos + rows - 1 >= 64 * r
        assert int(port[f"{r}/launches/{key}"]) == int(reaches), r


def test_write_cache_writes_each_ranks_slots(runs):
    inp, _, port = runs
    want = inp["ck"].copy()
    want[:, 126:129] = inp["new"]
    for r in range(4):
        np.testing.assert_array_equal(port[f"{r}/write"], want)


# ------------------------------------------------------ lse and the merge
def _qkv(seed, b, sq, sk, h, kvh, hd, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dtype) for s in
            ((b, sq, h, hd), (b, sk, kvh, hd), (b, sk, kvh, hd))]


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 37),
                                             (False, 0), (True, -3)])
def test_plain_lse_is_float64_logsumexp(causal, q_offset):
    q, k, v = _qkv(1, 2, 24, 40, 6, 2, 16)
    _, lse = flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                 return_lse=True)
    qg = q.double().reshape(2, 24, 2, 3, 16)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.double()) * 16 ** -0.5
    if causal:
        keep = (q_offset + torch.arange(24))[:, None] >= torch.arange(40)
        s = s.masked_fill(~keep, float("-inf"))
    want = torch.logsumexp(s, -1).reshape(2, 6, 24)
    assert lse.shape == (2, 6, 24) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.double().numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("cuts,q_offset", [
    ((0, 13, 30, 40), 20),   # three shards, every one seen
    ((0, 10, 20, 40), 5),    # the last shard past every row: empty
    ((0, 25, 40), -4),       # rows 0..3 keep no key of the whole
    ((0, 40), 0),            # one shard
])
def test_merge_of_key_shards_equals_the_whole(cuts, q_offset):
    q, k, v = _qkv(2, 2, 12, 40, 4, 2, 16)
    whole = flash_attention_ref(q, k, v, causal=True, q_offset=q_offset,
                                return_lse=True)
    parts = [sharded_attention._on_shard(q, k[:, a:b], v[:, a:b], True,
                                         q_offset - a)
             for a, b in zip(cuts, cuts[1:])]
    for (o_r, lse_r), (a, b) in zip(parts, zip(cuts, cuts[1:])):
        plain = flash_attention_ref(q, k[:, a:b], v[:, a:b], causal=True,
                                    q_offset=q_offset - a, return_lse=True)
        torch.testing.assert_close(o_r, plain[0], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(lse_r, plain[1], rtol=1e-6, atol=1e-6)
    o, lse = merge_shards_ref(parts)
    torch.testing.assert_close(o, whole[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, whole[1], rtol=1e-6, atol=1e-6)
    if q_offset < 0:
        assert (o[:, :-q_offset] == 0).all()
        assert torch.isneginf(lse[:, :, :-q_offset]).all()


def test_empty_shard_launches_nothing():
    from repro_torch.kernels import LAUNCHES, reset_launches
    q, k, v = _qkv(3, 1, 2, 8, 3, 3, 16)
    reset_launches()
    o, lse = sharded_attention._on_shard(q, k, v, True, -5)
    assert (o == 0).all() and torch.isneginf(lse).all()
    assert LAUNCHES["flash_attention"] == 0


# ---------------------------------------------------------------- the op
def test_op_fake_allocates_outputs_only():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q = torch.empty(2, 4096, 9, 64, dtype=torch.bfloat16)
        k = torch.empty(2, 8192, 3, 64, dtype=torch.bfloat16)
        o, lse = flash_attention(q, k, k, q_offset=100, return_lse=True)
        o2 = flash_attention(q, k, k)
        raw = torch.ops.repro_torch.flash_attention(q, k, k, True, 0, False)
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    assert lse.shape == (2, 9, 4096) and lse.dtype == torch.float32
    assert o2.shape == q.shape and raw[1].shape == (0,)


@pytest.mark.parametrize("causal,q_offset,return_lse", [
    (True, 0, False), (True, 300, True), (False, 0, False), (True, 900, False)])
def test_op_cost_counts_the_causal_triangle(causal, q_offset, return_lse):
    from torch._subclasses.fake_tensor import FakeTensorMode
    b, sq, sk, h, kvh, hd = 2, 512, 1024, 9, 3, 64
    with FakeTensorMode():
        q = torch.empty(b, sq, h, hd, dtype=torch.bfloat16)
        k = torch.empty(b, sk, kvh, hd, dtype=torch.bfloat16)
        with OpCost() as c:
            flash_attention(q, k, k, causal=causal, q_offset=q_offset,
                            return_lse=return_lse)
    rows = np.arange(sq)
    seen = np.minimum(sk, q_offset + rows + 1) if causal else \
        np.full(sq, sk)
    keys = int(seen.max())
    want_flops = 4 * b * h * hd * int(seen.sum())
    want_bytes = 2 * (2 * b * sq * h * hd + 2 * b * keys * kvh * hd) + (
        4 * b * h * sq if return_lse else 0)
    assert c.cost.flops == want_flops
    assert c.cost.bytes == want_bytes == c.cost.bytes_ideal
    assert c.by_op["repro_torch.flash_attention"][:2] == [1, want_flops]
    assert attention_cost((b, sq, h, hd), (b, sk, kvh, hd), causal,
                          q_offset, 2, return_lse) == (want_bytes,
                                                       want_flops)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_cpu_tensor_takes_the_plain_route_bit_equal(dtype):
    q, k, v = _qkv(4, 2, 40, 56, 6, 3, 16, dtype)
    want = flash_attention_ref(q, k, v, causal=True, q_offset=16)
    assert torch.equal(flash_attention(q, k, v, q_offset=16), want)
    o, lse = flash_attention(q, k, v, q_offset=16, return_lse=True)
    assert torch.equal(o, want)
    # the op's CPU implementation is the same plain version, and its
    # gradient (the blocked recompute) the plain version's
    o2, lse2 = torch.ops.repro_torch.flash_attention(q, k, v, True, 16, True)
    assert torch.equal(o2, want) and torch.equal(lse2, lse)
    qs = [x.float().clone().requires_grad_() for x in (q, k, v)]
    qp = [x.float().clone().requires_grad_() for x in (q, k, v)]
    go = torch.randn(q.shape, generator=torch.Generator().manual_seed(5))
    gl = torch.randn(lse.shape, generator=torch.Generator().manual_seed(6))
    oo, ll = torch.ops.repro_torch.flash_attention(*qs, True, 16, True)
    torch.autograd.backward((oo, ll), (go, gl))
    po, pl = flash_attention_ref(*qp, causal=True, q_offset=16,
                                 return_lse=True)
    torch.autograd.backward((po, pl), (go, gl))
    for a, b in zip(qs, qp):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)


@pytest.fixture
def fake_world():
    from repro_torch.launch.mesh import start_fake_world
    start_fake_world(8)
    yield
    dist.destroy_process_group()


def test_dtensor_never_reaches_the_launch(fake_world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    ops = sys.modules["repro_torch.kernels.flash_attention.ops"]
    mesh = init_device_mesh("cpu", (8,))
    x = DTensor.from_local(torch.zeros(1, 16, 3, 16), mesh, [Replicate()],
                           run_check=False)
    with pytest.raises(TypeError, match="plain CUDA tensors"):
        ops._launch(x, x, x, True, 0)


def test_dtensors_go_through_the_op(fake_world):
    """A DTensor call runs the op on each rank's shards, by the placements
    the op registers with DTensor: replicated, or batch-sharded (rank 0
    of a fake 8-rank world holds batch row 0 of 8)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = init_device_mesh("cpu", (8,))
    q, k, v = _qkv(8, 8, 24, 40, 6, 2, 16)
    want = flash_attention_ref(q, k, v, causal=True, q_offset=9,
                               return_lse=True)
    for pl, rows in (([Replicate()], slice(None)), ([Shard(0)], slice(0, 1))):
        args = [DTensor.from_local(x[rows], mesh, pl, run_check=False,
                                   shape=x.shape, stride=x.stride())
                for x in (q, k, v)]
        o, lse = flash_attention(*args, q_offset=9, return_lse=True)
        assert tuple(o.placements) == tuple(pl) == tuple(lse.placements)
        assert torch.equal(o.to_local(), want[0][rows])
        assert torch.equal(lse.to_local(), want[1][rows])


def test_dryrun_context_parallel_holds_no_scores(fake_world):
    """Reduced smollm-135m prefill of 2 x 4,096 tokens on a fake 2 x 4
    ("data", "model") world: every layer takes the context-parallel route
    (8 blocks of 128 rows a rank: 8 #7 calls a layer), counted by OpCost,
    and the peak temporaries stay below one layer's plain float32 scores
    [1, 3, 4096, 4096] (201 MB)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_reduced
    from repro_torch.launch import dryrun
    from repro_torch.models import build, make_sharder
    cfg = get_reduced("smollm-135m")
    model = build(cfg)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    rules = dryrun.rules_for(False)
    sh = make_sharder(rules, mesh)
    step, specs = dryrun.build_step(model, mesh, rules, "prefill", 4096, 2,
                                    sh=sh)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    args = tuple(dryrun.place(s, rules, mesh, fake) for s in specs)
    mem = MemTracker()
    with fake, OpCost() as counter, mem, dryrun.ReshardOnRefusal() as \
            reshard, dryrun.strided_index_math_on_host():
        step(*args)
    peak = max(v["Total"] for v in mem.get_tracker_snapshot("peak").values())
    scores = 1 * cfg.n_heads * 4096 * 4096 * 4
    assert peak < scores, (peak, scores)
    calls, flops = counter.by_op["repro_torch.flash_attention"][:2]
    assert calls == 8 * cfg.n_layers
    # rank 0 holds rows 0..127 of each block: the triangle of its rows
    pairs = sum(min(4096, i * 512 + r + 1) for i in range(8)
                for r in range(128))
    assert flops == 4 * cfg.n_heads * cfg.hd * pairs * cfg.n_layers
    assert sh.fallbacks == {}
    # the 3 heads on the 4-wide axis go to the heads placement and back by
    # all-to-alls: DTensor refuses no view
    assert reshard.fallbacks == {}


# ---------------------------------------------------------------- the card
@pytest.mark.gpu
@pytest.mark.parametrize("hd", [8, 16, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,sk,q_offset,causal", [
    (1, 300, 299, True), (5, 700, 100, True), (64, 64, 0, True),
    (300, 520, 220, True), (40, 130, 0, False)])
def test_kernel_lse_on_card_matches_plain(hd, dtype, sq, sk, q_offset,
                                          causal):
    """o and lse of every body (split-K decode with and without splits,
    the tensor cores at hd 64, the CUDA cores at hd 8 and 16 and in
    float32) against the plain version: o within one bf16 ulp (float32
    2e-5), lse within 1e-2 in bf16 and 1e-5 in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (x.cuda() for x in _qkv(7, 2, sq, sk, 6, 2, hd, dtype))
    o, lse = flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                             return_lse=True)
    po, pl = flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                 return_lse=True)
    tol = 8e-3 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(o.float(), po.float(), rtol=tol, atol=tol)
    lt = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(lse, pl, rtol=lt, atol=lt)
    assert torch.equal(flash_attention(q, k, v, causal=causal,
                                       q_offset=q_offset), o)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_config_serves_on_card(dtype):
    """The reduced smollm-135m (hd 16) prefills and decodes on the card
    through #7 (which took only hd >= 64 before), equal to the CPU's
    plain route within the LM tests' tolerances."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build, init_params
    from repro_torch.models.spec import tree_map
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(get_reduced("smollm-135m"), param_dtype=dtype)
    model = build(cfg)
    params = init_params(model.param_specs, torch.Generator().manual_seed(0))
    toks = torch.randint(1, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    got, want = [], []
    for dev, out in (("cuda", got), ("cpu", want)):
        p = tree_map(lambda w: w.to(dev), params)
        logits, cache = model.prefill(p, {"tokens": toks.to(dev),
                                          "max_len": 48})
        out.append(logits.cpu())
        reset_launches()
        for step in range(4):
            logits, cache = model.decode(p, {"token": toks[:, step:step + 1]
                                             .to(dev), "cache": cache,
                                             "pos": 40 + step})
            out.append(logits.cpu())
        if dev == "cuda":
            assert LAUNCHES["flash_attention"] == 4 * cfg.n_layers
    tol = 1e-4 if dtype == "float32" else 2e-2
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)
