"""Multi-pod dry run: one step of every (arch × shape × mesh) cell, run by
rank 0 of a fake 256- or 512-rank world on fake tensors (nothing is
allocated), with its per-device flops, bytes, collectives and memory
counted and turned into roofline terms (the counterpart of the JAX
package's ``launch/dryrun.py``, with the same CLI and record keys).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
      --shape train_4k --mesh multi
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out experiments/dryrun_torch --jobs 6

A cell places the parameters, the optimizer state and the batch as
DTensors by ``sharding_tree`` (each rank's shard a fake tensor of the
local shape), runs the step (a train step with AdamW and remat, a
prefill, or a decode) with ``sh = make_sharder(rules, mesh)``: attention
goes to ``models.sharded_attention`` (#7's fake implementation on each
rank's shards, as JAX places ``_blocked_sdpa`` and the sequence-sharded
cache; no scores are held), and it reads:

  flops, bytes, collectives — ``op_cost.OpCost`` over this rank's ops;
  arg_bytes   — the exact sum of this rank's shard bytes of every input;
  temp_bytes  — the peak of what the step allocates (``MemTracker``);
  the roofline terms — ``analysis`` with the H100's peaks.

Where XLA reshards silently, DTensor refuses: a view that splits an
unevenly sharded dim, an op that mixes plain tensors and DTensors. The
dry run lifts plain tensors to replicated DTensors and, on a refusal,
replicates the operands' placements on the inner mesh dims (the model
axis first) and tries again; an op DTensor has no rule for at all
(``searchsorted``) runs on the replicated operands' local tensors, its
results replicated; a write into a plain tensor beside a DTensor, which
real ranks refuse, runs on the lifted tensor. The record's
``fallbacks`` counts these per op, and the attention that ran replicated
on an axis for want of a placement (``repro_torch.flash_attention``).
DTensor computes a strided
shard's indices with ``torch.arange(...).tolist()``, which a fake tensor
cannot answer: the dry run runs that host arithmetic outside the modes.
On a CPU mesh DTensor moves a shard between tensor dims by an all-gather
and a chunk; the dry run makes it the all-to-all it is on the cards.
Under a fake mode DTensor skips its caches (``planned_once`` restores
them for the dry run's concrete shapes), and a refusal is planned once
(``ReshardOnRefusal``). A cell that raises is recorded with its error and
the sweep goes on; ``--jobs N`` runs N cells at once, each in a process.
``compile_s`` of the JAX records is ``trace_s`` here: eager PyTorch
compiles nothing.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils._pytree import tree_map_only

from ..configs import SHAPES, all_cells, get_config
from ..models import build, make_sharder
from ..models.moe import exchange
from ..models.spec import (ShardingRules, local_shape, placements,
                           tree_leaves, tree_map)
from ..train.optimizer import AdamWConfig, opt_state_specs
from ..train.train_step import make_train_step
from . import analysis
from .mesh import batch_axes, make_production_mesh
from .op_cost import OpCost


def rules_for(multi_pod: bool, overrides: dict | None = None) -> ShardingRules:
    base = dict(batch=batch_axes(multi_pod), model="model", fsdp="data",
                seq=None, kv_seq="model", expert="model")
    base.update(overrides or {})
    return ShardingRules(**base)


class ReshardOnRefusal(TorchDispatchMode):
    """Runs a DTensor op as XLA would run it where DTensor refuses it:
    plain tensor operands become replicated DTensors; on a refusal the
    DTensor operands are replicated on mesh dims k.. (k from the last
    down) until the op runs; an op with no sharding rule runs on the
    fully replicated operands' local tensors. ``fallbacks`` counts the
    refused ops, and as ``"<op> into a plain tensor"`` an op that writes
    into a plain tensor (a mutable argument of its schema) beside a
    DTensor operand: real ranks refuse that write, even where plain
    tensors that are read count as replicated (``spec.mesh_scope``).

    Each refusal is planned once: the replication that let an op run is
    remembered for its (op, operand placements, shapes and arguments),
    and a later call of the same kind goes to it directly, with none of
    the refused attempts (each a full sharding propagation) before it."""

    WHOLE = -1  # a remembered plan: no sharding rule, the whole value

    def __init__(self):
        super().__init__()
        self.fallbacks: dict = {}
        self._plans: dict = {}  # refused call's key -> k, or WHOLE

    @staticmethod
    def _key(func, args, kwargs):
        from torch.distributed.tensor import DTensor

        def one(x):
            if isinstance(x, DTensor):
                return ("D", tuple(x.placements), tuple(x.shape), x.dtype)
            if isinstance(x, torch.Tensor):
                return ("T", tuple(x.shape), x.dtype)
            return x if isinstance(x, (int, float, bool, str, type(None),
                                       torch.dtype)) else repr(x)
        return (func, tuple(map(one, pytree_leaves((args, kwargs)))))

    @staticmethod
    def _writes_plain(func, args, kwargs) -> bool:
        """Whether ``func`` writes into a plain tensor: an argument that
        its schema marks as written holds a tensor that is no DTensor."""
        from torch.distributed.tensor import DTensor
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            v = args[i] if i < len(args) else kwargs.get(a.name)
            if any(isinstance(t, torch.Tensor) and not isinstance(t, DTensor)
                   for t in pytree_leaves(v)):
                return True
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        mesh = next(a.device_mesh for a in pytree_leaves((args, kwargs))
                    if isinstance(a, DTensor))
        if self._writes_plain(func, args, kwargs):
            what = f"{func.overloadpacket} into a plain tensor"
            self.fallbacks[what] = self.fallbacks.get(what, 0) + 1

        def lift(t):
            if isinstance(t, DTensor):
                return t
            return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)

        args, kwargs = tree_map_only(torch.Tensor, lift, (args, kwargs))
        key = self._key(func, args, kwargs)
        plan = self._plans.get(key)
        name = str(func.overloadpacket)
        err = None
        if plan is None:
            try:
                return func(*args, **kwargs)
            except (RuntimeError, NotImplementedError) as e:
                err = e
        if plan != self.WHOLE:
            for k in ([plan] if plan is not None
                      else reversed(range(mesh.ndim))):
                def replicate(t, k=k):
                    pl = list(t.placements)
                    pl[k:] = [Replicate()] * (mesh.ndim - k)
                    return t.redistribute(t.device_mesh, pl)
                try:
                    out = func(*tree_map_only(DTensor, replicate, args),
                               **tree_map_only(DTensor, replicate, kwargs))
                except (RuntimeError, NotImplementedError) as e:
                    err = e
                    continue
                self._plans[key] = k
                self.fallbacks[name] = self.fallbacks.get(name, 0) + 1
                return out
            if not isinstance(err, NotImplementedError):
                raise err
        # no sharding rule: every rank computes the op on the whole value

        def whole(t):
            return t.redistribute(t.device_mesh,
                                  [Replicate()] * mesh.ndim).to_local()

        out = func(*tree_map_only(DTensor, whole, args),
                   **tree_map_only(DTensor, whole, kwargs))
        self._plans[key] = self.WHOLE
        self.fallbacks[name] = self.fallbacks.get(name, 0) + 1
        return tree_map_only(torch.Tensor, lift, out)


@contextlib.contextmanager
def strided_index_math_on_host():
    """Runs ``_StridedShard.local_shard_size_and_offset`` (index arithmetic
    on a ``torch.arange`` of the dim, read back with ``.tolist()``) with
    the dispatch modes set aside, so that a fake mode does not make its
    tensors fake, and remembers each answer: DTensor asks again for every
    strategy it costs, and the arange can be a sequence long."""
    from torch.distributed.tensor import placement_types
    cls = getattr(placement_types, "_StridedShard", None)
    orig = cls.__dict__.get("local_shard_size_and_offset") if cls else None
    if orig is None:
        yield
        return
    seen = {}

    def on_host(self, *args, **kw):
        key = (repr(self), args, tuple(sorted(kw.items())))
        if key not in seen:
            with _disable_current_modes():
                seen[key] = orig(self, *args, **kw)
        return seen[key]

    cls.local_shard_size_and_offset = on_host
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


@contextlib.contextmanager
def shard_moves_as_all_to_all():
    """DTensor moves a shard from one tensor dim to another by an
    all-to-all, except on a CPU mesh, where it gathers the whole and keeps
    a chunk (its gloo path has no all-to-all). The fake world's mesh is a
    CPU one that stands for the cards', so the dry run makes the move one
    ``all_to_all_single`` as on a CUDA mesh (and as XLA moves it): its
    count, link bytes and temporaries are the card's. DTensor pads the
    tensor first, so the chunks are even."""
    from torch.distributed.tensor import placement_types
    orig = placement_types.shard_dim_alltoall

    def on_the_cards(local, gather_dim, shard_dim, mesh, mesh_dim):
        n = mesh.size(mesh_dim)
        pieces = list(local.chunk(n, shard_dim))
        return exchange(pieces, [tuple(pieces[0].shape)] * n,
                        mesh.get_group(mesh_dim), gather_dim)

    placement_types.shard_dim_alltoall = on_the_cards
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


@contextlib.contextmanager
def planned_once():
    """Each sharding propagation and each redistribution plan made once.
    Under a fake mode DTensor takes itself to be tracing, where shapes may
    be symbolic, and skips its caches: every op is propagated and every
    redistribution planned anew, which on the 3-D mesh (a graph search
    over placements) took most of a cell's time. The dry run's shapes are
    concrete, so each (op schema) and each (source, target) spec pair is
    remembered for the block, as DTensor remembers them outside tracing."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute
    prop = DTensor._op_dispatcher.sharding_propagator
    propagate = prop.propagate_op_sharding_non_cached
    plan = _redistribute._gen_transform_infos_non_cached
    shardings, plans = {}, {}

    def propagate_once(op_schema):
        if op_schema not in shardings:
            shardings[op_schema] = propagate(op_schema)
        return shardings[op_schema]

    def plan_once(src, dst, use_graph_based_transform=None):
        key = (src, dst, use_graph_based_transform)
        if key not in plans:
            plans[key] = plan(src, dst, use_graph_based_transform)
        return plans[key]

    prop.propagate_op_sharding_non_cached = propagate_once
    _redistribute._gen_transform_infos_non_cached = plan_once
    try:
        yield
    finally:
        del prop.propagate_op_sharding_non_cached
        _redistribute._gen_transform_infos_non_cached = plan


def shard_bytes(specs, rules: ShardingRules, mesh) -> int:
    """The exact bytes of one rank's shards of every leaf of ``specs``."""
    total = 0
    for s in tree_leaves(specs):
        pl = placements(rules.pspec_for_shape(s.shape, s.axes, mesh), mesh)
        n = int(np.prod(local_shape(s.shape, pl, mesh)))
        total += n * torch.empty((), dtype=s.dtype).element_size()
    return total


def place(specs, rules: ShardingRules, mesh, fake_mode, device="cpu",
          grad: bool = False):
    """DTensors of ``specs`` placed by the rules, each rank's shard a fake
    tensor of the local shape on ``device`` (``grad``: floating leaves
    require grad)."""
    from torch.distributed.tensor import DTensor

    def one(s):
        pl = placements(rules.pspec_for_shape(s.shape, s.axes, mesh), mesh)
        with fake_mode:
            local = torch.empty(local_shape(s.shape, pl, mesh),
                                dtype=s.dtype, device=device)
        stride = torch.empty(s.shape, device="meta").stride()
        t = DTensor.from_local(local, mesh, pl, run_check=False,
                               shape=torch.Size(s.shape), stride=stride)
        if grad and s.dtype.is_floating_point:
            t = t.detach().requires_grad_()
        return t

    return tree_map(one, specs)


def build_step(model, mesh, rules, shape_kind, seq, gb, remat="dots_no_batch",
               opt_cfg: AdamWConfig | None = None, microbatches: int = 1,
               sh=None):
    """Returns (step, arg specs): ``step(args)`` runs the cell's step on
    the placed ``args`` (a tuple of spec trees' DTensors) with the
    sharding hook ``sh`` (default ``make_sharder(rules, mesh)``)."""
    sh = sh or make_sharder(rules, mesh)
    opt_cfg = opt_cfg or AdamWConfig()

    if shape_kind == "train":
        train = make_train_step(model, opt_cfg, remat, microbatches, sh)
        specs = (model.param_specs, opt_state_specs(model.param_specs,
                                                    opt_cfg),
                 model.train_input_specs(gb, seq))
        return (lambda params, opt, batch: train(params, opt, batch)), specs

    if shape_kind == "prefill":
        specs = (model.param_specs, model.prefill_input_specs(gb, seq))
        return (lambda params, batch: model.prefill(params, batch, sh)), specs

    specs = (model.param_specs, model.decode_input_specs(gb, seq))

    def decode(params, batch):
        if "pos" in batch:  # the port's decode takes the position as an int
            batch = dict(batch, pos=seq - 1)
        return model.decode(params, batch, sh)

    return decode, specs


def _mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape: str, multi_pod: bool, remat: str = "dots_no_batch",
             rules_overrides: dict | None = None, verbose: bool = True,
             opt_cfg: AdamWConfig | None = None, microbatches: int = 1,
             device: str = "cpu"):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    cfg = get_config(arch)
    model = build(cfg)
    seq, gb, kind = SHAPES[shape]
    mesh = make_production_mesh(multi_pod, fake=True)
    n_chips = mesh.size()
    rules = rules_for(multi_pod, rules_overrides)
    sh = make_sharder(rules, mesh)
    step, specs = build_step(model, mesh, rules, kind, seq, gb, remat,
                             opt_cfg, microbatches, sh)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    args = tuple(place(s, rules, mesh, fake, device,
                       grad=(kind == "train" and i == 0))
                 for i, s in enumerate(specs))
    arg_bytes = sum(shard_bytes(s, rules, mesh) for s in specs)
    t0 = time.time()
    mem = MemTracker()
    with fake, OpCost() as counter, mem, ReshardOnRefusal() as reshard, \
            strided_index_math_on_host(), planned_once(), \
            shard_moves_as_all_to_all():
        step(*args)
    trace_s = time.time() - t0
    fallbacks = dict(reshard.fallbacks)
    for name, calls in sh.fallbacks.items():
        fallbacks[name] = fallbacks.get(name, 0) + calls
    peak = mem.get_tracker_snapshot("peak")
    temp_bytes = max((v["Total"] for v in peak.values()), default=0)
    mflops = analysis.model_flops_for(cfg, kind, seq, gb)
    roof = analysis.analyze(counter.cost, n_chips, mflops,
                            arg_bytes + temp_bytes)
    rec = {
        "arch": arch, "shape": shape, "kind": kind,
        "mesh": _mesh_tag(multi_pod), "chips": n_chips,
        "trace_s": round(trace_s, 1),
        "flops_per_device": roof.flops_per_device,
        "bytes_per_device": roof.bytes_per_device,
        "bytes_lower": roof.bytes_lower, "bytes_upper": roof.bytes_upper,
        "link_bytes_per_device": roof.collectives.link_bytes_total,
        "compute_s": roof.compute_s, "memory_s": roof.memory_s,
        "collective_s": roof.collective_s, "bottleneck": roof.bottleneck,
        "model_flops": mflops, "useful_ratio": roof.useful_ratio,
        "hbm_bytes_per_device": roof.per_device_hbm_bytes,
        "arg_bytes": arg_bytes,
        "temp_bytes": temp_bytes,
        "collective_counts": roof.collectives.counts,
        "collective_link_bytes": roof.collectives.bytes_by_kind,
        "fallbacks": fallbacks,
        # #7's forward: its causal triangle, where XLA's blocked scan
        # computes every block (static trip counts)
        "attention_flops": counter.by_op.get(
            "repro_torch.flash_attention", [0, 0])[1],
        "remat": remat, "rules": dataclasses.asdict(rules),
        "microbatches": microbatches,
        "quantized_opt": bool(opt_cfg and opt_cfg.quantized_state),
    }
    if verbose:
        print(f"[{arch} × {shape} × {rec['mesh']}] kind={kind} "
              f"trace={trace_s:.1f}s bottleneck={roof.bottleneck}")
        print(f"  memory: args={arg_bytes/1e9:.2f}GB "
              f"temps={temp_bytes/1e9:.2f}GB per device")
        print(f"  op_cost: {roof.flops_per_device/1e9:.1f} GFLOP, "
              f"{roof.bytes_per_device/1e9:.2f} GB accessed per device")
        print(f"  terms: compute={roof.compute_s*1e3:.2f}ms "
              f"memory={roof.memory_s*1e3:.2f}ms "
              f"collective={roof.collective_s*1e3:.2f}ms "
              f"useful={roof.useful_ratio:.2f} "
              f"colls={roof.collectives.counts} "
              f"fallbacks={sum(fallbacks.values())}")
    return rec


def _cell_record(cell):
    """The record of one (arch, shape, multi_pod, remat) cell, or its
    error: a sweep's unit of work (in a worker process with ``--jobs``)."""
    arch, shape, mp, remat = cell
    try:
        return run_cell(arch, shape, mp, remat=remat)
    except Exception as e:  # noqa: BLE001 — report, keep sweeping
        traceback.print_exc()
        return {"arch": arch, "shape": shape, "mesh": _mesh_tag(mp),
                "error": f"{type(e).__name__}: {e}"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="dots_no_batch")
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a worker process of "
                         "its own (a fake world is process-wide)")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.all:
        cells = list(all_cells())
    else:
        cells = [(args.arch, args.shape, None)]

    records, todo = [], []
    for arch, shape, skip in cells:
        for mp in meshes:
            if skip:
                records.append({"arch": arch, "shape": shape,
                                "mesh": _mesh_tag(mp), "skipped": skip})
                print(f"[{arch} × {shape}] SKIP: {skip}")
            else:
                records.append(None)  # filled in order below
                todo.append((arch, shape, mp, args.remat))
    if args.jobs > 1:
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(args.jobs, maxtasksperchild=1) as pool:
            done = pool.map(_cell_record, todo, chunksize=1)
    else:
        done = map(_cell_record, todo)
    done = iter(done)
    records = [r if r is not None else next(done) for r in records]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        tag = "all" if args.all else f"{args.arch}_{args.shape}"
        path = os.path.join(args.out, f"dryrun_{tag}_{args.mesh}.json")
        with open(path, "w") as f:
            json.dump(records, f, indent=1)
        print("wrote", path)
    n_err = sum(1 for r in records if "error" in r)
    print(f"cells: {len(records)}, errors: {n_err}")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
