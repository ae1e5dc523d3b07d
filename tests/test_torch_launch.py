"""The port's launch and mesh tools (``repro_torch.launch`` and the
sharding half of ``repro_torch.models.spec``) against the JAX package's.

* Parameter counts, model flops and the logical-axis rules are integer or
  shape-only arithmetic: equal to JAX's exactly, for all ten configs.
* ``pspec_for_shape`` and the local shard shapes on the two production
  meshes: the port on a real ``DeviceMesh`` of a fake 256- or 512-rank
  world, the JAX side with no devices (it reads only ``mesh.shape``).
* ``op_cost`` passes the three checks ``tests/test_hlo_cost.py`` holds the
  JAX counter to, and the dry runs of one cell and of the ingest step
  give coherent records with the JAX package's argument bytes.

The fake world is process-global; the module fixture takes it down.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.launch import analysis as jax_analysis
from repro.models import build as jax_build
from repro.models import spec as jax_spec
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import opt_state_specs as jax_opt_specs
from repro_torch.configs import ARCH_IDS, SHAPES, all_cells, get_config, get_reduced
from repro_torch.launch import analysis, dryrun
from repro_torch.launch.mesh import (batch_axes, make_production_mesh,
                                     start_fake_world)
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import (ShardingRules, build, make_sharder,
                                placements, pspec_tree, sds_tree,
                                sharding_tree)
from repro_torch.models.spec import flatten_up_to, local_shape, tree_leaves
from repro_torch.train.optimizer import AdamWConfig, opt_state_specs

RULES = {"single": {}, "multi": {},
         "no_tp": {"tp_enabled": False, "seq": "model"}}


@pytest.fixture(scope="module", autouse=True)
def _take_down_fake_world():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _rules(name, jax_side=False):
    if name == "no_tp":
        cls = jax_spec.ShardingRules if jax_side else ShardingRules
        return cls(**RULES[name])
    if jax_side:  # the JAX rules_for's module sets XLA_FLAGS on import
        return jax_spec.ShardingRules(
            batch=batch_axes(name == "multi"), model="model", fsdp="data",
            seq=None, kv_seq="model", expert="model")
    return dryrun.rules_for(name == "multi")


# ------------------------------------------------------------ arithmetic
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_jax(arch):
    for mine, theirs in ((get_config(arch), jax_config(arch)),
                         (get_reduced(arch), jax_reduced(arch))):
        assert mine.n_params_analytic() == theirs.n_params_analytic()
        assert mine.n_params_active() == theirs.n_params_active()
        assert mine._mamba_params() == theirs._mamba_params()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_jax(arch):
    cells = [(a, s) for a, s, _ in all_cells() if a == arch]
    assert len(cells) == len(SHAPES)
    for a, shape in cells:
        seq, gb, kind = SHAPES[shape]
        assert analysis.model_flops_for(get_config(a), kind, seq, gb) == \
            jax_analysis.model_flops_for(jax_config(a), kind, seq, gb)


def _spec_trees(model, opt_quant: bool, jax_side: bool):
    """Every spec tree of a model: parameters, optimizer state and the
    three input kinds at a small shape."""
    if jax_side:
        ospecs = jax_opt_specs(model.param_specs,
                               JaxAdamWConfig(quantized_state=opt_quant))
    else:
        ospecs = opt_state_specs(model.param_specs,
                                 AdamWConfig(quantized_state=opt_quant))
    gb, s = 32, 4096
    if model.cfg.family == "vlm":
        s += model.cfg.n_img_tokens
    return [model.param_specs, ospecs, model.train_input_specs(gb, s),
            model.prefill_input_specs(gb, s), model.decode_input_specs(gb, s)]


def _jax_leaves(tree):
    import jax
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, jax_spec.PSpec))


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pspec_tree_matches_jax(arch, rules):
    mine_r, jax_r = _rules(rules), _rules(rules, jax_side=True)
    mine_m, jax_m = build(get_config(arch)), jax_build(jax_config(arch))
    for quant in (False, True):
        for mine, theirs in zip(_spec_trees(mine_m, quant, False),
                                _spec_trees(jax_m, quant, True)):
            got = flatten_up_to(mine, pspec_tree(mine, mine_r))
            want = [tuple(p) for p in _jax_leaves(
                jax_spec.pspec_tree(theirs, jax_r))]
            assert got == want
            assert [s.shape for s in tree_leaves(mine)] == \
                [tuple(s.shape) for s in _jax_leaves(theirs)]


# ------------------------------------------------------- the fake meshes
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_pspec_for_shape_and_local_shapes_match_jax(multi):
    mesh = make_production_mesh(multi, fake=True)
    assert mesh.size() == (512 if multi else 256)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    jax_mesh = SimpleNamespace(shape=sizes)
    name = "multi" if multi else "single"
    mine_r, jax_r = _rules(name), _rules(name, jax_side=True)
    for arch in ARCH_IDS:
        mine_m, jax_m = build(get_config(arch)), jax_build(jax_config(arch))
        for mine, theirs in zip(_spec_trees(mine_m, True, False),
                                _spec_trees(jax_m, True, True)):
            pls = flatten_up_to(mine, sharding_tree(mine, mine_r, mesh))
            for s, js, pl in zip(tree_leaves(mine), _jax_leaves(theirs), pls):
                spec = mine_r.pspec_for_shape(s.shape, s.axes, mesh)
                want = tuple(jax_r.pspec_for_shape(js.shape, js.axes,
                                                   jax_mesh))
                assert spec == want, (arch, s)
                assert tuple(pl) == placements(spec, mesh)
                local = []
                for dim, entry in zip(js.shape, want):
                    names = () if entry is None else (
                        (entry,) if isinstance(entry, str) else entry)
                    local.append(dim // int(np.prod([sizes[n]
                                                     for n in names])))
                assert local_shape(s.shape, pl, mesh) == \
                    tuple(local)


def test_placements_follow_mesh_order_and_refuse_another():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_production_mesh(True, fake=True)
    assert placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements((None,), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        placements((("data", "pod"),), mesh)


def test_sharder_hook_and_fake_specs():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = torch.arange(6.0)
    assert make_sharder(None)(x, "batch") is x
    start_fake_world(8)
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    sh = make_sharder(ShardingRules(), mesh)
    assert sh.rules == ShardingRules() and sh.mesh is mesh
    assert sh(x, "batch") is x  # a plain tensor is left alone
    d = DTensor.from_local(torch.zeros(8, 6), mesh, [Replicate()] * 2,
                           run_check=False)
    out = sh(d, "batch", "ff")  # batch -> data, ff -> model (6 % 2 == 0)
    assert out.placements == (Shard(0), Shard(1))
    assert out.to_local().shape == (2, 3)
    fake = sds_tree(build(get_reduced("smollm-135m")).param_specs)
    leaf = fake["embed"]["embedding"]
    assert leaf.shape == (2048, 48) and leaf.dtype == torch.bfloat16
    assert type(leaf).__name__ == "FakeTensor"


# ------------------------------------------------------------- op_cost
def test_op_cost_counts_chained_matmuls_and_their_gradient():
    from torch._subclasses.fake_tensor import FakeTensorMode
    want = 10 * 2 * 512 ** 3
    with FakeTensorMode():
        x = torch.empty(512, 512, dtype=torch.bfloat16)
        with OpCost() as c:
            y = x
            for _ in range(10):
                y = (y @ y) * 0.999
        assert c.cost.flops == want
        x = x.requires_grad_()
        with OpCost() as c:
            y = x
            for _ in range(10):
                y = torch.tanh(y @ y)
            (y.float() ** 2).sum().backward()
        assert c.cost.flops == 3 * want


def test_op_cost_sharded_matmul_counts_one_device_and_its_all_reduce():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    start_fake_world(8)
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))

    def placed(shape, spec):
        pl = placements(spec, mesh)
        return DTensor.from_local(
            torch.empty(local_shape(shape, pl, mesh)), mesh, pl,
            run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())

    with FakeTensorMode():
        x = placed((64, 256), ("data", None))
        a = placed((256, 512), (None, "model"))
        b = placed((512, 256), ("model", None))
        with OpCost() as c:
            y = (x @ a) @ b
            y.redistribute(mesh, placements(("data", None), mesh))
    assert c.cost.flops == 2 * (2 * 64 * 256 * 512) / 8
    assert c.cost.coll_counts == {"all-reduce": 1}
    s_bytes = 16 * 256 * 4
    assert c.cost.link_bytes == 2.0 * s_bytes * (2 - 1) / 2


# ------------------------------------------------------------ dry runs
def _jax_shard_bytes(specs, rules, sizes):
    total = 0
    mesh = SimpleNamespace(shape=sizes)
    for s in _jax_leaves(specs):
        spec = rules.pspec_for_shape(s.shape, s.axes, mesh)
        n = 1
        for dim, entry in zip(s.shape, spec):
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            n *= dim // int(np.prod([sizes[k] for k in names]))
        total += n * np.dtype(s.dtype).itemsize
    return total


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_dryrun_decode_cell(multi):
    rec = dryrun.run_cell("smollm-135m", "decode_32k", multi, verbose=False)
    assert rec["chips"] == (512 if multi else 256)
    assert rec["flops_per_device"] > 0
    assert rec["collective_s"] >= 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["hbm_bytes_per_device"] < 80e9, "decode must fit one H100"
    # each rank attends its own slots of the sequence-sharded cache and
    # the ranks merge (o, lse): no all-gather of the cache (5.97 GB)
    assert rec["link_bytes_per_device"] < 0.6e9
    seq, gb, _ = SHAPES["decode_32k"]
    model = jax_build(jax_config("smollm-135m"))
    sizes = {"pod": 2, "data": 16, "model": 16} if multi else \
        {"data": 16, "model": 16}
    rules = _rules("multi" if multi else "single", jax_side=True)
    want = (_jax_shard_bytes(model.param_specs, rules, sizes)
            + _jax_shard_bytes(model.decode_input_specs(gb, seq), rules,
                               sizes))
    assert rec["arg_bytes"] == want


def _cut(monkeypatch, n_layers=2):
    """The dry run's configs at ``n_layers`` of their layers (published
    widths)."""
    monkeypatch.setattr(dryrun, "get_config", lambda arch: (
        dataclasses.replace(get_config(arch), n_layers=n_layers)))


def test_dryrun_train_cell_refuses_no_heads_view_and_holds_no_vocab(
        monkeypatch):
    """smollm-135m at full width, 2 of its layers, train_4k on 16 x 16: its
    9 heads over 3 KV heads go to the heads placement by all-to-alls
    (DTensor refused the view: 6 a layer went to ``ReshardOnRefusal``),
    the gold logit and the log-sum-exp are reduced over the vocab shards
    (the gather replicated the vocab: 12.9 GB of float32 logits a device),
    so no fallback of any kind, the peak temporaries stay below one
    device's float32 logits over the whole vocab ([16, 4096, 49152]), and
    the argument bytes are JAX's."""
    seq, gb, _ = SHAPES["train_4k"]
    _cut(monkeypatch)
    rec = dryrun.run_cell("smollm-135m", "train_4k", False, verbose=False)
    assert rec["fallbacks"] == {}
    assert rec["collective_counts"]["all-to-all"] > 0
    whole_vocab = (gb // 16) * seq * get_config("smollm-135m").vocab * 4
    assert rec["temp_bytes"] < whole_vocab, (rec["temp_bytes"], whole_vocab)
    cfg = dataclasses.replace(jax_config("smollm-135m"), n_layers=2)
    model = jax_build(cfg)
    rules = _rules("single", jax_side=True)
    sizes = {"data": 16, "model": 16}
    want = sum(_jax_shard_bytes(s, rules, sizes) for s in (
        model.param_specs, jax_opt_specs(model.param_specs,
                                         JaxAdamWConfig()),
        model.train_input_specs(gb, seq)))
    assert rec["arg_bytes"] == want


def test_dryrun_context_parallel_output_moves_by_all_to_all(monkeypatch):
    """smollm-135m prefill_32k (2 layers, 16 x 16): q goes from the heads
    placement to its rows of every block and the output back by one
    all-to-all each (XLA's move; the output went to full rows by an
    all-gather), q, k and v from the projections' columns to the heads by
    one each, the output back to the columns by one, and the cache takes
    its rows from the heads by one a tensor: 8 a layer; no fallback."""
    from repro_torch.models import moe
    _cut(monkeypatch)
    moves = []
    exchange = moe.exchange
    monkeypatch.setattr(moe, "exchange",
                        lambda *a: moves.append(1) or exchange(*a))
    rec = dryrun.run_cell("smollm-135m", "prefill_32k", False, verbose=False)
    assert rec["fallbacks"] == {}
    assert len(moves) == 8 * 2
    assert rec["collective_counts"]["all-to-all"] >= len(moves)


def test_reshard_on_refusal_counts_a_write_into_a_plain_tensor():
    """A DTensor written into a slice of a plain tensor: real ranks refuse
    it (DTensor's dispatch asserts), even with the plain tensors that are
    read counted as replicated; the dry run runs it on the lifted tensor
    and counts it under the op, marked as a write into a plain tensor."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication
    start_fake_world(1)
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
    d = DTensor.from_local(torch.ones(4, 8), mesh, [Replicate()],
                           run_check=False)
    st = torch.zeros(2, 4, 8)
    with pytest.raises(AssertionError), implicit_replication():
        st[0] = d
    with dryrun.ReshardOnRefusal() as refusals:
        st[0] = d
        st[1] += d
    assert refusals.fallbacks == {"aten.copy_ into a plain tensor": 1,
                                  "aten.add_ into a plain tensor": 1}
    with dryrun.ReshardOnRefusal() as refusals:  # a DTensor target
        d[0] = torch.zeros(8)
        d.add_(torch.ones(4, 8))
    assert refusals.fallbacks == {}


@pytest.mark.parametrize("arch,shape", [("olmoe-1b-7b", "decode_32k"),
                                        ("mamba2-2.7b", "prefill_32k")])
def test_dryrun_serving_cell_has_no_fallback(monkeypatch, arch, shape):
    """Serving cells at 2 layers on 16 x 16 that real ranks refused: the
    MoE decode's routing (a sequence of 1 routes locally) ran
    ``searchsorted``, which DTensor has no rule for (2 fallbacks); the
    Mamba2 prefill wrote its DTensor states into plain tensors, which the
    dry run did not count. Now neither, and the argument bytes are JAX's."""
    seq, gb, kind = SHAPES[shape]
    _cut(monkeypatch)
    rec = dryrun.run_cell(arch, shape, False, verbose=False)
    assert rec["fallbacks"] == {}
    model = jax_build(dataclasses.replace(jax_config(arch), n_layers=2))
    specs = (model.prefill_input_specs if kind == "prefill"
             else model.decode_input_specs)(gb, seq)
    rules = _rules("single", jax_side=True)
    sizes = {"data": 16, "model": 16}
    assert rec["arg_bytes"] == sum(_jax_shard_bytes(s, rules, sizes)
                                   for s in (model.param_specs, specs))


def test_ingest_dryrun_single_mesh(capsys):
    from repro.db.spmd import stacked_empty as jax_stacked_empty
    from repro_torch.launch import ingest
    rec = ingest.dryrun(False)
    assert rec["colls"] == {"all-to-all": 1}
    one = jax_stacked_empty(1, 1 << 20)
    want = sum(np.asarray(getattr(one, f))[0].nbytes
               for f in ("rows", "cols", "vals", "n")) + 3 * (1 << 15) * 4
    assert rec["arg_bytes"] == want
    assert "ingest dry-run" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="only --dryrun"):
        ingest.main([])
