"""Which collectives gloo carries on CUDA tensors, with 4 ranks that share
one card (the layout of ``chip_smoke.py``'s mesh phases), and whether a
DTensor on a CUDA or a CPU device mesh over gloo redistributes.

    python3 experiments/gloo_cuda_probe.py [OUT.json]

Each op is logged on every rank before and after it runs; an op that
kills a rank (a segfault) is skipped in the next round, and the rounds go
on until one finishes. Writes {op: "ok ..." | "FAIL ..." | "SKIPPED ..."}
with the torch and CUDA versions to OUT.json (default
``build/gloo_cuda_probe.json``) and prints it.
"""
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N_RANKS = 4


def body(rank, rdv, out, log_dir, skip):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=N_RANKS, rank=rank)
    import torch.distributed._functional_collectives as fc
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    res = {"torch": torch.__version__, "cuda": torch.version.cuda}
    dev = torch.device("cuda", 0)
    log = open(os.path.join(log_dir, f"rank{rank}.txt"), "a")

    def t(name, fn):
        if name in skip:
            res[name] = "SKIPPED (killed a rank in an earlier round)"
            return
        log.write(f"start {name}\n")
        log.flush()
        try:
            r = fn()
            torch.cuda.synchronize()
            res[name] = "ok " + str(r)[:60]
        except Exception as e:  # noqa: BLE001 — record and go on
            res[name] = f"FAIL {type(e).__name__}: {str(e)[:160]}"
        log.write(f"done {name}\n")
        log.flush()

    x = torch.arange(8., device=dev) + rank
    world = dist.group.WORLD
    t("c10d all_reduce", lambda: dist.all_reduce(x.clone()))
    t("c10d all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
        torch.empty(8 * N_RANKS, device=dev), x))
    t("c10d reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
        torch.empty(8 // N_RANKS, device=dev), x))
    t("c10d all_to_all_single", lambda: dist.all_to_all_single(
        torch.empty(8, device=dev), x))
    t("c10d all_to_all_single, host, uneven", lambda: dist.all_to_all_single(
        torch.empty(N_RANKS * (rank + 1)), torch.ones(10),
        output_split_sizes=[rank + 1] * N_RANKS,
        input_split_sizes=[1, 2, 3, 4]))
    t("functional all_reduce", lambda: fc.all_reduce(x, "sum", world)
      .sum().item())
    t("functional all_gather_tensor", lambda: fc.all_gather_tensor(
        x, 0, world).sum().item())
    t("functional reduce_scatter_tensor", lambda: fc.reduce_scatter_tensor(
        x, "sum", 0, world).sum().item())
    t("functional all_to_all_single", lambda: fc.all_to_all_single(
        x, None, None, world).sum().item())
    for mtype in ("cuda", "cpu"):
        mesh = init_device_mesh(mtype, (1, N_RANKS),
                                mesh_dim_names=("data", "model"))
        full = torch.arange(64., device=dev).reshape(8, 8)
        t(f"{mtype} mesh: distribute_tensor's device", lambda: (
            distribute_tensor(full, mesh, [Replicate(), Shard(1)])
            .to_local().device))
        d = DTensor.from_local(full[:, 2 * rank:2 * rank + 2], mesh,
                               [Replicate(), Shard(1)], run_check=False)
        t(f"{mtype} mesh: Shard -> Replicate", lambda: d.redistribute(
            mesh, [Replicate(), Replicate()]).to_local().sum().item())
        t(f"{mtype} mesh: Shard(1) -> Shard(0)", lambda: d.redistribute(
            mesh, [Replicate(), Shard(0)]).to_local().sum().item())
        p = DTensor.from_local(full, mesh, [Replicate(), Partial()],
                               run_check=False)
        t(f"{mtype} mesh: Partial -> Replicate", lambda: p.redistribute(
            mesh, [Replicate(), Replicate()]).to_local().sum().item())
        t(f"{mtype} mesh: Partial -> Shard", lambda: p.redistribute(
            mesh, [Replicate(), Shard(0)]).to_local().sum().item())
        u = torch.arange(36., device=dev).reshape(9, 4)
        t(f"{mtype} mesh: uneven Shard -> Replicate", lambda: (
            distribute_tensor(u, mesh, [Replicate(), Shard(0)]).redistribute(
                mesh, [Replicate(), Replicate()]).to_local().sum().item()))
        t(f"{mtype} mesh: matmul to Partial, reduced", lambda: (
            d.T @ d).redistribute(mesh, [Replicate(), Replicate()])
          .to_local().sum().item())
    dist.barrier()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
    dist.destroy_process_group()


def main(argv):
    out = argv[1] if len(argv) > 1 else os.path.join(
        "build", "gloo_cuda_probe.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    log_dir = tempfile.mkdtemp()
    skip = []
    for _ in range(12):
        for r in range(N_RANKS):
            open(os.path.join(log_dir, f"rank{r}.txt"), "w").close()
        try:
            mp.start_processes(body, args=(
                os.path.join(tempfile.mkdtemp(), "rdv"), out, log_dir, skip),
                nprocs=N_RANKS, start_method="spawn")
            break
        except mp.ProcessExitedException as e:
            print("a round failed:", e, flush=True)
            for r in range(N_RANKS):
                lines = open(os.path.join(log_dir, f"rank{r}.txt")).read()
                started = [x[6:] for x in lines.split("\n")
                           if x.startswith("start ")]
                done = [x[5:] for x in lines.split("\n")
                        if x.startswith("done ")]
                skip += [x for x in started if x not in done
                         and x not in skip]
    print("skipped:", skip)
    print(open(out).read())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
