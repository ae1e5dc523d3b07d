"""Which DTensor ops that the MoE decode and Mamba2's prefill and train
step once used run on this torch, and whether their replacements do: 4
gloo ranks on one card, mesh (1, 4) ("data", "model"), the tensors
placed from each rank's block (no collective outside the staged scope),
every op under ``spec.mesh_scope`` as a model step runs.

    python3 experiments/dtensor_rules_probe.py [OUT.json]

Cases, each against the same op on the full tensors:

* ``pad``: ``F.pad`` along the sequence of x [B, S, C], then a product
  with a per-channel weight column (Mamba2's causal conv), for x placed
  on the batch, on the channels or on both and the weight replicated or
  on its channels; ``cat``: the same with the zeros concatenated
  (``mamba2._pad_seq``);
* ``index_copy``: the MoE dispatch as it ran on DTensors, rows of x
  gathered by a replicated index and copied into a zero buffer by
  another (x on the batch axis, 1 wide here, as in a decode step);
  ``index_copy_whole``: the same on the full tensors of every rank
  (``moe._apply_moe_local``);
* ``ssd_einsum grad``: the gradient of Mamba2's intra-chunk einsum
  (``bcqkh,bckhp->bcqhp``) on operands placed on the batch and the heads,
  as a train step ran it on DTensors; ``ssd_on_ranks grad``: the
  gradients of the whole scan run on each rank's own sequences and heads
  (``mamba2._ssd_on_ranks``).

Writes {case: "ok" | "WRONG" | "RAISES ..."} with the torch and CUDA
versions to OUT.json (default ``build/dtensor_rules_probe.json``) and
prints it.
"""
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 4


def body(rank, rdv, out):
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=N_RANKS, rank=rank)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.models import make_sharder
    from repro_torch.models.spec import (contiguous_stride, local_block,
                                         mesh_scope)
    mesh = init_device_mesh("cuda", (1, N_RANKS),
                            mesh_dim_names=("data", "model"))
    sh = make_sharder(rules_for(False), mesh)
    res = {"torch": torch.__version__, "cuda": torch.version.cuda}

    def placed(t, pl):
        return DTensor.from_local(local_block(t, pl, mesh).contiguous(),
                                  mesh, pl, run_check=False, shape=t.shape,
                                  stride=contiguous_stride(t.shape))

    def case(name, fn, want, rtol=1e-5):
        try:
            with mesh_scope(sh):
                got = fn()
                if isinstance(got, DTensor):
                    got = got.full_tensor()
            atol = 1e-8 if rtol == 1e-5 else rtol * float(want.abs().max())
            res[name] = "ok" if torch.allclose(got, want, rtol=rtol,
                                               atol=atol) else "WRONG"
        except Exception as e:  # noqa: BLE001 — record, go on
            res[name] = f"RAISES {type(e).__name__}: {str(e)[:200]}"

    g = torch.Generator(device="cuda").manual_seed(0)
    b, s, c, k = 4, 8, 160, 4
    x = torch.randn(b, s, c, device="cuda", generator=g)
    w = torch.randn(c, k, device="cuda", generator=g)
    want = torch.nn.functional.pad(x, (0, 0, k - 1, 0))[:, :s] * w[:, 0]
    rep = [Replicate(), Replicate()]
    for xn, xp in (("batch", [Shard(0), Replicate()]),
                   ("channels", [Replicate(), Shard(2)]),
                   ("both", [Shard(0), Shard(2)])):
        for wn, wp in (("replicated", rep), ("channels",
                                             [Replicate(), Shard(0)])):
            dx, dw = placed(x, xp), placed(w, wp)
            case(f"pad x:{xn} w:{wn}", lambda: torch.nn.functional.pad(
                dx, (0, 0, k - 1, 0))[:, :s] * dw[:, 0], want)
            case(f"cat x:{xn} w:{wn}", lambda: torch.cat(
                [dx.new_zeros(b, k - 1, c), dx], 1)[:, :s] * dw[:, 0], want)
    xt = x[:, 0]  # [B, C]: a decode step's tokens
    tok = torch.arange(b, device="cuda").repeat_interleave(2)
    slot = torch.randperm(3 * b, device="cuda", generator=g)[:2 * b]
    want = xt.new_zeros(3 * b, c).index_copy(0, slot, xt[tok])
    dxt = placed(xt, [Shard(0), Replicate()])
    dtok, dslot = placed(tok, rep), placed(slot, rep)
    case("index_copy", lambda: dxt.new_zeros(3 * b, c).index_copy(
        0, dslot, dxt[dtok]), want)
    case("index_copy_whole", lambda: dxt.full_tensor().new_zeros(
        3 * b, c).index_copy(0, slot, dxt.full_tensor()[tok]), want)
    # Mamba2's SSD on x placed on the batch and the heads (a train step):
    # the intra-chunk einsum's gradient as it ran on DTensors, and the
    # scan on each rank's own sequences and heads (mamba2._ssd_on_ranks)
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.models import mamba2
    cfg = dataclasses.replace(get_reduced("mamba2-2.7b"), ssm_chunk=8)
    h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    nc, q = 2, 8

    def grads(fn, ts, pls):
        """The gradients of sum(fn(*ts) ** 2) against ``ts``, flat; with
        ``pls`` the inputs are DTensors placed so, the gradients whole."""
        args = [(placed(t, pl) if pls else t.clone()).requires_grad_()
                for t, pl in zip(ts, pls or ts)]
        fn(*args).square().sum().backward()
        return torch.cat([(a.grad.full_tensor() if pls else a.grad)
                          .flatten() for a in args])

    w = torch.randn(b, nc, q, q, h, device="cuda", generator=g)
    xc = torch.randn(b, nc, q, h, p, device="cuda", generator=g)

    def ssd_einsum(w, xc):
        return torch.einsum("bcqkh,bckhp->bcqhp", w, xc)

    bh = [Shard(0), Shard(4)], [Shard(0), Shard(3)]
    case("ssd_einsum grad", lambda: grads(ssd_einsum, (w, xc), bh),
         grads(ssd_einsum, (w, xc), None), rtol=1e-4)
    ins = (torch.randn(b, nc * q, h, p, device="cuda", generator=g),
           torch.rand(b, nc * q, h, device="cuda", generator=g),
           torch.rand(h, device="cuda", generator=g),
           torch.randn(b, nc * q, n, device="cuda", generator=g),
           torch.randn(b, nc * q, n, device="cuda", generator=g))
    on_rows = [Shard(0), Replicate()]
    pls = ([Shard(0), Shard(2)], [Shard(0), Shard(2)], rep, on_rows,
           on_rows)
    case("ssd_on_ranks grad", lambda: grads(
        lambda *a: mamba2._ssd_on_ranks(cfg, *a, None, sh)[0], ins, pls),
        grads(lambda *a: mamba2._ssd_chunked(cfg, *a)[0], ins, None),
        rtol=1e-4)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
    dist.destroy_process_group()


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "build", "dtensor_rules_probe.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(body, args=(os.path.join(d, "rdv"), out),
                           nprocs=N_RANKS, start_method="spawn")
    print(open(out).read())


if __name__ == "__main__":
    main()
