#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Drives the paper's Listing-1 database path through the connector a user
calls — ``dbsetup`` → bind the ``Tedge``/``TedgeT`` pair → ``put`` →
row, column and range reads → ``delete`` — on a Graph500 graph, then the
D4M 2.0 schema with its degree table and the Fig. 4 reads, the legacy
single-run engine, Graphulo's SpMV, the per-run read path, a crash and
recovery of the pair from its write-ahead log, dynamic tablets under a
Zipf stream (with a crash and a per-tablet recovery), the store-backed
token pipeline, the SPMD mesh path (4 rank processes and a single NCCL
rank), the LM serving path (``launch/serve.py`` → ``Engine`` → prefill /
decode), the LM training path (``launch/train.py`` → train step →
``train_loss`` with per-layer remat → AdamW, checkpoints and a resume),
the MoE, Mamba2 and hybrid families (serving and a train step), the
enc-dec and VLM families (serving, training with a resume, a train step),
qwen2.5-3b whole (served, trained with microbatches, int8 AdamW moments,
on the DTensor mesh), yi-34b served at all 60 layers
and the launch and mesh tools (MoE expert parallelism over 4 ranks, the
op-level cost counter, the dry runs); builds the hand-written CUDA
kernels from ``src/repro_torch/csrc``, shows that each path launched its
kernels, and holds each kernel against its plain PyTorch version at the
path's shapes.

    python3 chip_smoke.py [--seed N] [--scale S] [--profile DIR]

Phases (each raises on failure):
  1. device line (name and power limit, as nvidia-smi reports them);
  2. kernel build (one nvcc per source, in parallel);
  15. (run first, while the card holds nothing else) yi-34b whole: 60
     layers, d_model 7,168, 56 heads over 8 at hd 128 (GQA rep 7), bf16,
     68.82 GB of weights drawn on the card; 4 requests of 512 tokens, 16
     new each, through ``Engine`` (one batch, max_len 528): every request
     yields its tokens, every logit finite, self-attention only on #7 (60
     launches a forward, 960), the last decode step's logits within 5e-2
     of one prefill over every token it saw; the peak device memory
     logged beside the weights plus the cache (path ``yi``);
  14. qwen2.5-3b whole (36 layers, d_model 2,048, 16 heads over 2 at hd
     128: GQA rep 8, QKV biases, a tied table of 151,936 tokens padded to
     153,600), bf16, the seeded init drawn on the card (sizes in ``P14``):
     (a) ``repro_torch.launch.serve``'s defaults (path ``qwen_a``) and one
     batch of 4 x 1,920 tokens, 128 new, max_len 2,048 (``qwen_b``): every
     request yields its tokens, self-attention only on #7 (36 launches a
     forward), prefill-then-decode within 5e-2 of the full prefill, and at
     2 of 36 layers in float32 the card's prefill within 1e-3 of the CPU's;
     (b) ``repro_torch.launch.train.main`` at full depth, 3 steps of 4 x 512
     tokens in 2 microbatches, float32 AdamW moments (``qwen_train``):
     every loss finite, #7 2 launches a layer a microbatch a step, step ms,
     tokens/s and the peak device memory beside the reckoning of the state;
     (c) one step at 2 layers and full width on 2 x 256 tokens: every
     leaf's gradient on the card (bf16) within 5e-2 of the CPU's (float32)
     and non-zero, the QKV biases and the tied table among them; the same
     step in float32 with int8 moments (``AdamWConfig(quantized_state=
     True)``) against the CPU's: the dequantized moments within one int8
     level, each leaf's update within 1e-3; the full-depth state bytes with
     int8 and float32 moments logged; (d) in 13g (float32) and 13h below;
  3. Listing-1 at scale 16 with ``use_pallas=True`` (the hand kernels:
     the merge-path rank in every compaction, the two-sided fence search
     once per probed run stack, the row merge once per point-read
     combine); every read equals the host ``Assoc`` algebra's answer, and
     the route the row merge replaced (the row rank, then scatters) equals
     it on every one of its inputs;
  4. the same workload on the port's PyTorch-ops path
     (``use_pallas=False``); every read equals phase 3's. Both paths
     first run once untimed, then twice each in the order kernels,
     PyTorch ops, PyTorch ops, kernels, so that neither path takes every
     first use;
  4b. the D4M 2.0 schema (``EdgeSchema``: Tedge / TedgeT / TedgeDeg) on the
     raw triples of the same graph, on both paths: the degree vectors
     equal ``np.bincount`` of the raw key ids, and the Fig. 4 SV/MV row and
     column reads of vertices picked by degree equal the host ``Assoc``
     algebra and a ``NaiveTable`` fed the same triples;
  4c. the legacy single-run engine (``engine="single"``) on both paths:
     the phase-3 row-id read, row range and a column read (host scan +
     filter) equal phase 3's reads; on the kernel path the row-id read of
     each queried shard is ``tablet_read``, one two-sided ``rank`` launch
     and one ``tablet_gather`` launch (counted per read), and each result
     equals the padded read it replaced (``tablet_query_rows`` widened,
     then ``nonzero``) at the same inputs; the binary-search pair rank also
     ranks the flush's two runs both ways and equals the merge-path ranks;
  4d. Graphulo ``table_spmv`` on the schema's Tedge, both routes (the CSR
     kernel and the PyTorch product on the card), and the ELL kernel on the
     ELL of the same scan, against a float64 product on the host, for a
     one-hot x at the largest out-degree and a random x;
  4e. the per-run read path (``fused_reads=False``) on phase 3's server and
     graph: every read equals phase 3's; during the reads no fused
     dispatch runs, per-run dispatches do, and no hand kernel launches
     (the put's compactions launch the merge path, counted apart); timed
     interleaved with the fused read (fused, per-run, per-run, fused);
  7. a crash and recovery at full width: a child process (this script
     with ``--crash-child``) runs phase 3's server with ``wal_root`` and
     the hand kernels, binds the pair, puts half the graph, checkpoints
     the pair, puts the other half and dies with ``os._exit(1)``; on the
     card ``recover_connector`` rebuilds the pair (the WAL suffix replays
     through the merge path, the reads run the fence search and the row
     merge), and every Listing-1 read and ``nnz`` equal phase 3's; a copy
     whose log is cut inside its last frame recovers to exactly the
     batches before it, and a write after that recovery survives a second
     one. The WAL and snapshot sizes, the put with the WAL, the
     checkpoint and the recovery (load, then suffix replay) are timed;
  8. dynamic tablets and the token store on the card. 8a: a transpose pair
     on 4 shards with dynamic tablets (combiner ``last``, ids 2^16,
     memtable 2^16, capacity 2^20 a shard) takes 1,048,576 triples (rows
     Zipf(1.1) mod 2^16, columns uniform over 4,096) in 16 batches of
     65,536 with a rebalance round after every second batch, and a
     never-split twin on the plain path (no hand kernel, fed and read
     before the pair, so the pair's launches are its own) the same
     stream: the map split and moved tablets,
     the full scans, a point read of 1,024 ids >= 1,024, the hot row range
     [0, 1,024) and the whole id space (in order) and a column read
     through the sibling equal the twin's, the sibling is the exact
     transpose, and on a fresh window of 65,536 Zipf ids the balance from
     the map is <= 2.0 and below the static one. A writer process (this
     script with ``--tablet-child``) reruns the stream with a WAL: half,
     a checkpoint, the rest with rebalance rounds, a merge, then
     ``os._exit(1)``; the card recovers it to the writer's map and the
     twin's reads, and with ``tablet_filter`` for the suffix's hottest
     tablet and one minted after the checkpoint to a host replay of the
     snapshot plus that tablet's frames. 8b: ``TokenStore`` ingests 4,096
     documents of 512 tokens (vocabulary 49,152) and 16 seeded
     ``sample_batch(8, 512)`` draws equal the same draws over the host
     corpus. Splits, moves, migrations, balances and tokens per second
     are logged;
  9. the mesh path (``db.spmd`` on ``torch.distributed``) at phase 3's
     scale: 4 rank processes (this script with ``--rank-child``; gloo with
     every rank on ``cuda:0`` and the exchange staged through pinned host
     buffers, or NCCL with 4 or more cards) each ingest their contiguous
     quarter of phase 3's 955,111 id-space entries in 8 batches of 32,768:
     (a) the pair step into L0 stacks of 4 runs, both compacted at a full
     stack, the point reads (1,024 row ids, 256 column ids through the
     sibling, ``q_tile`` 512, ``max_return`` the largest host degree) and
     scans (the row range, and the column range with
     ``transpose_output``, widened while ``cnt_max`` exceeds the window)
     before and after the last compaction, each equal to phase 3's answer,
     and the level runs equal to what phase 3's store holds shard by shard
     (the triples routed and sorted on the host); (b) the legacy step into
     a tablet of phase 3's capacity, equal to the same shards; (c) the
     tablet step, built once, under a map that splits the hottest tablet
     and moves its right half after 4 steps: every row a
     rank receives is its own under the map in force, and none is lost.
     The ranks' merged registry snapshots count every rank's steps. (d) A
     single NCCL rank in this process ingests 4 batches, compacts and
     reads 256 rows against a host filter. Every step, compaction and read
     is timed on the card's clock;
  6. LM serving: smollm-135m at full width (30 layers, d_model 576, 9
     heads over 3 KV heads, hd 64, vocabulary 49,152, tied embeddings) in
     bf16 from the port's seeded init, on the card: run a is
     ``repro_torch.launch.serve``'s defaults (8 requests of 4-23 tokens,
     16 new tokens each, 4 slots, max_len 128), run b a long context (4
     requests of 1,920 tokens, 128 new tokens each, max_len 2,048). Every
     request yields its tokens, self-attention runs only on the
     flash-attention kernel (960 and 3,840 launches), the card's first
     prefill equals the same weights' prefill on the CPU within 2e-2, and
     prefill-then-decode equals the full prefill within 5e-2 (bf16);
  10. LM training: the same model and init, through
     ``repro_torch.launch.train.main`` (batch 8 x 512 tokens from a
     ``TokenStore`` on the card, remat ``dots_no_batch``): (a) 20 steps
     uninterrupted; 20 steps with a checkpoint every 10 that crash right
     after the first (an exception out of ``checkpoint.save``; its 34
     leaves byte-equal to the state in memory), resumed to step 20 with
     losses equal to the uninterrupted run's within ``RESUME_RTOL``; the
     loss falls; step ms, tokens/s and peak device memory logged, with the
     plain attention backward's ms beside the kernel forward's and one
     traced step; (b) one step's gradient of every leaf on the card (bf16)
     against the same weights' on the CPU (float32), relative error norm
     <= 5e-2 and a non-zero norm each, a check that a planted F1 (the
     attention output detached from q, k, v) must fail; (c) during (a)
     self-attention ran only on #7, 2 launches a layer a step (the remat
     recompute), 2,400 in all, and no other kernel;
  13. the launch and mesh tools (sizes in ``P13``): (a) olmoe-1b-7b at
     full width cut to 2 layers, 4 rank processes (this script with
     ``--rank-child``; gloo, every rank on ``cuda:0``), a prefill of 4 x
     512 tokens through ``build(cfg).prefill(..., sh=make_sharder(rules,
     mesh))`` on mesh (1, 4): at the no-drop capacity factor the float32
     logits within 1e-5 of rank 0's local path (the bf16 gaps logged), at
     the config's factor each rank's drops logged; on mesh (2, 2) with
     the int8 FSDP gather, ``gather_w_int8`` equal to its plain version
     and ``elastic_restore`` of a layer's checkpoint equal to each rank's
     block of the full arrays; #7's launches counted (path ``moe_ep``);
     (b) phase 10's train step once under ``launch.op_cost.OpCost`` (#7
     the registered op, counted by its causal triangle), then timed:
     counted flops and bytes, the roofline terms, the measured step and
     its model-FLOPs share (path ``cost_step``); (c) the smollm-135m
     decode_32k dry runs on both production meshes and the ingest dry
     run, each a process of its own on the host's CPU, started before
     (a); (d) smollm-135m at full width and 8 of 30 layers on 4 rank
     processes (mesh (1, 4), ``model`` / ``attn_q`` / ``kv_seq`` on the
     4-wide axis, the full values on every rank): a context-parallel
     prefill of 1 x 4,096 tokens (one #7 launch a 512-row block a rank)
     into 8,192 slots and 32 decode steps over each rank's 2,048 slots,
     merged by (o, lse), the logits within 1e-4 (float32) and 2e-2 (bf16)
     of rank 0's unsharded path, every rank's #7 launches counted (paths
     ``cp`` and the float32 ``cp_check``); (e) #7 at the reduced configs'
     head dims 8 and 16 on the card, the logits against the CPU's (path
     ``small``), and at the widest GQA groups, yi-34b (rep 7) and
     command-r-plus-104b (rep 12) at full width and 1 layer: a prefill of 2
     x 512 tokens and 8 decode steps, the last step against one prefill
     over every token (path ``gqa_wide``), and #7 with the rows' lse at the
     same head layouts (path ``gqa_wide_check``); (f)
     smollm-135m at full width and 2 layers on 4 rank processes, the
     parameters and the batch DTensors on the card under
     the production rules (its 9 heads on the 4-wide model axis: 3 a
     rank, rank 3 none; DTensor's collectives staged through pinned host
     buffers): one train step of 4 x 512 tokens and prefills with the
     cache sequence-sharded and whole, the loss, every gradient and the
     logits within 1e-5 (float32) and 2e-2 (bf16) of rank 0's unsharded
     path, no fallback, #7's launches a rank counted (none where a rank
     holds no heads; paths ``heads`` and the float32 ``heads_check``);
     (g) serving on the same mesh and rules, as a user calls the model
     (no ``ReshardOnRefusal``: an op DTensor refuses raises):
     olmoe-1b-7b (2 of 16 layers, no token dropped), zamba2-2.7b (one
     group: 6 Mamba2 layers and the shared attention) and
     whisper-large-v3 (2 encoder and 2 decoder layers, 1,500 frames), at
     full width, each a prefill of 4 x 512 tokens into 520 slots and 8
     decode steps, the logits and the final state within 1e-5 (float32)
     of rank 0's unsharded path, bf16 by its median row within 2e-2 or
     twice bf16's own distance from float32 where that is larger (the
     MoE's top 8 flip where the sharded matmuls round otherwise), no
     fallback, every rank's values equal, #7's launches a rank counted
     (paths ``mesh_serve`` and the float32 ``mesh_serve_check``), and
     qwen2.5-3b (2 of 36 layers; its 2 KV heads split [1, 1, 0, 0] over
     the 4-wide axis) in float32 only; (h) a
     train step on the same mesh and rules through ``train_step.
     loss_and_grads`` as a user calls it, olmoe-1b-7b, mamba2-2.7b (2 of
     64 layers), zamba2-2.7b, whisper-large-v3 and internvl2-26b (2 of 48
     layers, its 256 image embeddings among the 512 positions) and
     qwen2.5-3b (2 of 36 layers), as cut in (g), 4 x 512 positions,
     float32, then zamba2-2.7b in bf16: the loss
     and every gradient leaf within 1e-5 (float32) of the reference, rank
     0's unsharded step, for olmoe with the aux loss taken as the mean of
     the token shards' (a mesh step's MoE aux is that, as in JAX, so the
     unsharded step is no reference), or twice the reference's own
     distance from its float64 twin where that is larger (Mamba2's decay
     gradient); bf16 within 2e-2 or twice the bf16 reference's own
     distance from the float32 one where that is larger; no fallback,
     every rank's values equal, #7's launches a rank counted (paths
     ``mesh_train`` and the float32 ``mesh_train_check``);
  12. (run before 11, which leaves its recorded inputs on the card) the
     enc-dec and VLM families at full width (sizes and cuts in ``P12``), weights drawn on the card, frames and image embeddings
     seeded (the frontends are stubs), served greedily through
     ``build(cfg).prefill`` / ``.decode``: (a) whisper-large-v3 (32
     encoder + 32 decoder layers, 20 heads at hd 64, 1,500 frames), 4
     requests of a 4-token prompt, 128 new tokens: #7 96 times in the
     prefill (the encoder's and the cross-attention non-causal over 1,500
     keys) and 64 a step; (b) internvl2-26b (48 layers, 48 heads over 8
     at hd 128), 4 requests of 256 image embeddings and 512 tokens, 32
     new over an 800-slot cache: #7 48 times a forward; each at 2 layers
     a stack in float32, the card's prefill against the CPU's (and for
     whisper prefill-then-decode against one forward) within 1e-3, the
     bf16 drift logged; (c) whisper through ``launch.train.main`` at full
     width and 8 + 8 of its 32 + 32 layers (the script's time limit), 3 steps of 2 x 256 tokens and 1,500 frames, a crash after
     step 2 and a resume with losses equal to the uninterrupted run's; one
     train step per family at 2 layers a stack, every leaf's gradient
     (bf16) within 5e-2 of the CPU's (float32);
  11. the MoE, Mamba2 and hybrid families at full width (sizes in
     ``P11``): (a) olmoe-1b-7b (16 layers, 64 experts, top 8, hd 128)
     through ``launch.serve``'s defaults (512 attention launches) and one
     batch of 4 x 1,920 tokens, 32 new (512 launches), its first prefill at
     2 layers in float32 against the CPU's float32 (relative error norm
     <= 1e-3; the bf16 prefills of the card and the CPU logged against it
     with their routing differences); (b) kimi-k2 (d_model 7,168, 384
     experts, hd 112) cut to 1 layer, weights drawn on the card, 4
     requests of 512 tokens and 16 new through ``Engine``; (c)
     mamba2-2.7b (64 layers) and (d) zamba2-2.7b (54 layers, 9
     shared-attention applications at hd 80), each a prefill of 4 x 2,048
     tokens then 64 decode steps in bf16 and again on the weights cast to
     float32, each step's logits against one forward over the same tokens
     (float32 <= 1e-3; bf16 logged), #7 never launched in (c) and 9 times
     a forward in (d); (e) one ``make_train_step`` step per family at
     reduced depth (olmoe 2 layers in float32, mamba2 2, zamba2 one group
     of 6) on 2 x 256 tokens, every leaf's gradient finite, non-zero and
     against the CPU's (olmoe float32 on both within 1e-3; the others
     bf16 against float32 within 5e-2);
  5. each kernel against its plain version on the card at every input
     each path gave it (recorded in phases 15, 14, 3, 4b, 4c, 4d, 7, 8, 9 —
     by the ranks, per geometry — 6, 10, 13, 12 and 11: per
     geometry for the LSM kernels and flash attention, per call for the
     1-D rank, the tablet gather, segment sum and SpMVs), ranks, merged
     rows, read entries and degree sums exactly equal (the merge-path
     ranks also to the binary-search pair rank's, the row merge to the row
     rank + scatters, the segment sum to the one-atomic-per-entry kernel,
     the 1-D rank to the one-thread binary search, a launch per side, each
     timed beside them; every ``tablet_read`` of 4c whole, beside its plain
     version and the padded read on the binary search, CUDA events; an
     empty kernel timed as the launch floor),
     SpMV within rtol=1e-5, attention within about one bf16 ulp (rtol
     8e-3, atol 1e-3; float32 2e-5) and an error norm within 1e-2 of the
     output's, a limit that two planted faults at run b's inputs must
     fail, and at every input the rows' lse within 1e-5 (float32) or
     1e-2 (bf16), with kernel / plain / library-call times per launch (CUDA
     graphs and CUDA events; SDPA in the faster of its masked and
     mask-free forms), averaged over all the paths' launches.

The second-to-last line is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device
or without the repository's sources.
"""
import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks: the HBM rate and the float32 rate outside the tensor
# cores (NVIDIA data sheet), and the 32-bit integer rate for the rank
# kernels' compares and adds: 64 int32 add/compare results per clock per
# SM (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0) x 132 SMs x 1.98 GHz
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 64 * 132 * 1.98e9
PEAK_F32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12  # dense bf16 tensor-core rate

ROOT = Path(__file__).resolve().parent


def log(msg):
    print(msg, flush=True)


def sync():
    import torch
    torch.cuda.synchronize()


def clock():
    sync()
    return time.perf_counter()


def cuda_ms(fn, reps, warm=3):
    """Mean ms of ``fn()`` over ``reps`` eager calls, CUDA events, after
    warm-up. Host launch overhead counts when it exceeds the device time."""
    import torch
    for _ in range(warm):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """(``fn()``, its ms) for one eager call, timed with CUDA events."""
    import torch
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    return result, start.elapsed_time(end)


def graph_ms(fn, reps):
    """Mean device ms of ``fn()`` over ``reps`` calls captured in one CUDA
    graph and replayed: the host's launch overhead is out of the number."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled(label, fn, out_dir):
    """Run ``fn`` under torch.profiler: log wall time, the summed device
    time of the kernels and copies it ran and the busy share, and write
    the top ops by device time to ``out_dir/profile_<label>.txt``.
    Returns (result, wall seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = clock()
        result = fn()
        wall = clock() - t0
    ka = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(ka[0], "self_device_time_total") else
           "self_cuda_time_total")
    # device-side events only: a host op's self device time repeats that
    # of the kernels and copies it issued
    dev_ms = sum(getattr(e, key) for e in ka
                 if e.device_type != DeviceType.CPU) / 1e3
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"profile_{label}.txt").write_text(
        ka.table(sort_by=key, row_limit=25))
    log(f"profile {label}: wall {wall * 1e3:.3f} ms, device {dev_ms:.3f} ms, "
        f"busy {100 * dev_ms / (wall * 1e3):.1f}%")
    return result, wall


def bound_ms(n_bytes, n_ops, peak_ops=PEAK_OPS_PER_S):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def same_triples(a, b, what):
    """Two Assocs hold the same (row, col, value) triples."""
    same_arrays(a.triples(), b.triples(), what)


def same_arrays(got, want, what, ordered=False):
    """(rows, cols, vals) exactly equal: as sets of triples, or in order."""
    import numpy as np
    got = [np.asarray(x) for x in got]
    want = [np.asarray(x) for x in want]
    if len(got[0]) != len(want[0]):
        raise AssertionError(f"{what}: {len(got[0])} vs {len(want[0])} "
                             f"entries")
    if not ordered:
        og = np.lexsort((got[1], got[0]))
        ow = np.lexsort((want[1], want[0]))
        got = [x[og] for x in got]
        want = [x[ow] for x in want]
    for x, y, name in zip(got, want, ("rows", "cols", "vals")):
        if not np.array_equal(x, y):
            raise AssertionError(f"{what}: {name} differ")


# ------------------------------------------------------------------ phase 3/4
class Recorder:
    """Stands in for a kernel wrapper where a module of the path calls it:
    every call goes on to the wrapper (which launches and counts as
    before), and the recorder keeps a copy of the inputs and the number of
    calls for each distinct input geometry, or with ``every_call`` for each
    call."""

    def __init__(self, module, name, every_call=False):
        self.module, self.name, self.every_call = module, name, every_call
        self.fn = getattr(module, name)
        self.calls = {}  # key -> [calls, (args, kwargs) copy]

    def __call__(self, *args, **kw):
        geo = (tuple(tuple(a.shape) if hasattr(a, "shape") else a
                     for a in args), tuple(sorted(kw.items())),
               tuple(str(a.dtype)[6:] for a in args if hasattr(a, "dtype")))
        if self.every_call:
            geo += (len(self.calls),)
        if geo not in self.calls:
            self.calls[geo] = [0, ([a.detach().clone() if hasattr(a, "clone")
                                    else a for a in args], dict(kw))]
        self.calls[geo][0] += 1
        return self.fn(*args, **kw)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def listing1(graph, use_pallas, cap, stash=None, profile_dir=None, **conf):
    """Listing-1 through the connector. Returns (reads, stats, timings,
    kernel launches of the put and the reads); ``stats["reads"]`` holds the
    kernel launches and the engine counters of the reads alone. With
    ``stash`` set, the inputs of every kernel launch are recorded for phase
    5. With ``profile_dir`` set, the put and each read run under
    torch.profiler (their times then include its cost). ``conf`` overrides
    fields of the phase-3 configuration."""
    import numpy as np
    from repro_torch.db import delete, put
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.merge_rank import ops as merge_ops

    A, verts, sels = graph["A"], graph["verts"], graph["sels"]
    DB = server("smoke", cap, use_pallas, **conf)
    # the vertex names are interned in sorted order first (a sorted bulk
    # load), so string ranges map to contiguous ids and run as scans
    DB.encode_keys(np.asarray(verts, dtype=object))
    Tedge = DB["Tedge", "TedgeT"]
    # flush + compaction once on the empty store (no state changes): the
    # kernel build, CUDA context and allocator warm-up stay off the clock
    Tedge.table.store.warmup()

    timed = path_timer(profile_dir, "kernels" if use_pallas else "ops")
    with kernel_run(stash) as launches, \
            Calls(merge_ops, "row_merge", keep=stash is not None) as merges:
        _, t_put = timed("put", lambda: put(Tedge, A))
        reads, times = {}, {"put_s": t_put,
                            "ingest_entries_per_s": A.nnz() / t_put}
        store = Tedge.table.store
        put_launches = dict(LAUNCHES)
        before = engine_counters(store)
        for name, sel in sels.items():
            reads[name], times[name + "_s"] = timed(name, lambda: Tedge[sel])
        after = engine_counters(store)
        read_stats = {
            "launches": {k: v - put_launches[k] for k, v in LAUNCHES.items()},
            "engine": {k: after[k] - before[k] for k in after}}
        old_merge_route(merges.kept)
    stats = {"Tedge": store.engine_stats(),
             "TedgeT": store.t_store.engine_stats(), "reads": read_stats}
    delete(Tedge)
    if DB.ls():
        raise AssertionError(f"tables left after delete: {DB.ls()}")
    return reads, stats, times, launches


def engine_counters(store):
    """The read counters of a pair's two tables, summed."""
    keys = ("fused_dispatches", "perrun_dispatches", "scan_dispatches",
            "runs_probed", "runs_skipped")
    a, b = store.engine_stats(), store.t_store.engine_stats()
    return {k: a[k] + b[k] for k in keys}


def old_merge_route(kept):
    """The route the fused row merge replaced, on each of its calls' inputs:
    the row-rank kernel, then the rank applied by scatters, equals the
    merge. This keeps ``row_rank`` launched on a path."""
    import torch
    from repro_torch.kernels.merge_rank import apply_row_rank
    from repro_torch.kernels.merge_rank import ops as merge_ops
    for (keys, vals), got in kept:
        want = apply_row_rank(keys, vals, merge_ops.row_rank(keys))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"phase 3: row_rank + scatter differs from "
                                 f"row_merge at {list(keys.shape)}")


def make_graph(scale, seed):
    import numpy as np
    from repro_torch.core import Assoc
    from repro_torch.data.graph500 import graph500_triples
    from repro_torch.db.kvstore import shard_of

    t0 = time.perf_counter()
    r, c, v = graph500_triples(scale, 16, seed=seed)
    A = Assoc(r, c, v)
    verts = np.union1d(A.row, A.col)
    ids = {s: i for i, s in enumerate(verts)}
    ar, ac, _ = A.triples()
    rid = np.fromiter((ids[x] for x in ar), np.int64, len(ar))
    cid = np.fromiter((ids[x] for x in ac), np.int64, len(ac))
    # capacity from the actual shard skew (the ingest benchmark's sizing)
    counts = np.maximum(np.bincount(shard_of(rid, 4, 1 << 16), minlength=4),
                        np.bincount(shard_of(cid, 4, 1 << 16), minlength=4))
    cap = max(1 << 12, int(counts.max() * 1.3))
    rng = np.random.default_rng(seed)
    # 1,024 row vertices owned by one shard: two query tiles of 512
    row_v = np.unique(rid)
    owner = shard_of(row_v, 4, 1 << 16)
    own = row_v[owner == np.argmax(np.bincount(owner, minlength=4))]
    row_ids = verts[rng.choice(own, min(1024, len(own)), replace=False)]
    col_v = np.unique(cid)
    col_ids = verts[rng.choice(col_v, min(256, len(col_v)), replace=False)]
    lo, hi = len(verts) // 64, min(len(verts) // 64 + 999, len(verts) - 1)
    clo, chi = lo * 8, min(lo * 8 + 999, len(verts) - 1)
    sels = {
        "row_ids": (",".join(row_ids) + ",", ":"),
        "col_ids": (":", ",".join(col_ids) + ","),
        "row_range": (f"{verts[lo]},:,{verts[hi]},", ":"),
        "col_range": (":", f"{verts[clo]},:,{verts[chi]},"),
    }
    log(f"graph: scale {scale}, {len(r)} edges, {A.nnz()} distinct entries, "
        f"{len(verts)} vertices, capacity_per_shard {cap}, host build "
        f"{time.perf_counter() - t0:.3f} s")
    # the raw triples (duplicates included) for the schema phases, their
    # key ids (verts is sorted and interned first, so id = position), and
    # the last-wins Assoc the edge table must equal
    raw_ids = (np.searchsorted(verts, r), np.searchsorted(verts, c))
    return {"A": A, "verts": verts, "sels": sels, "raw": (r, c, v),
            "raw_ids": raw_ids, "ids": (rid, cid, A.triples()[2]),
            "last": Assoc(r, c, v, func="last")}, cap


def server(name, cap, use_pallas, **kw):
    """A server in the phase-3 configuration (``kw`` overrides fields)."""
    from repro_torch.db import dbsetup
    conf = dict(num_shards=4, id_capacity=1 << 16, batch_cap=1 << 15,
                memtable_cap=1 << 16, capacity_per_shard=cap,
                use_pallas=use_pallas)
    conf.update(kw)
    return dbsetup(name, **conf)


# the slice's new kernels are checked at each call's inputs (their calls
# are few, and the same geometry comes with different data: the one-hot
# and random x of the SpMV, the out- and in-degree ids of the segment sum)
EVERY_CALL = ("rank", "tablet_gather", "segment_sum", "spmv_ell", "spmv_csr")


def wrapper_sites():
    """Where the paths call each kernel's wrapper: (module, attribute)."""
    from repro_torch.db import graphulo, kvstore
    from repro_torch.kernels.merge_rank import ops as merge_ops
    from repro_torch.kernels.sorted_search import ops as search_ops
    from repro_torch.kernels.spmv import ops as spmv_ops
    from repro_torch.models import layers
    return {"rank_batched": (search_ops, "rank_batched"),
            "row_rank": (merge_ops, "row_rank"),
            "row_merge": (merge_ops, "row_merge"),
            "pair_rank": (merge_ops, "pair_rank"),
            "merge_path_rank": (merge_ops, "merge_ranks"),
            "rank": (search_ops, "rank"),
            "tablet_gather": (search_ops, "tablet_gather"),
            "segment_sum": (kvstore, "segment_sum"),
            "spmv_ell": (spmv_ops, "spmv_ell"),
            "spmv_csr": (graphulo, "spmv_csr"),
            "flash_attention": (layers, "flash_attention")}


class Calls:
    """Counts the calls of ``module.name`` while it stands there, and keeps
    each call's (args, result) with ``keep``."""

    def __init__(self, module, name, keep=False):
        self.module, self.name, self.keep = module, name, keep
        self.fn = getattr(module, name)
        self.n, self.kept = 0, []

    def __call__(self, *args, **kw):
        self.n += 1
        result = self.fn(*args, **kw)
        if self.keep:
            self.kept.append((args, result))
        return result

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


@contextlib.contextmanager
def kernel_run(stash=None):
    """Counts every kernel's launches from 0 over the block; the dict it
    yields is filled on exit. With ``stash`` a dict, a Recorder stands at
    each wrapper's call site for the block, under the kernel's name,
    ``stash["probe_stack"]`` counts the fused read's probed run stacks
    (each searches its fences with one ``rank_batched`` launch) and
    ``stash["combine_rows"]`` its ``merge_combine_rows`` calls (one
    ``row_merge`` launch each)."""
    from repro_torch.db.lsm import engine
    from repro_torch.kernels import LAUNCHES, reset_launches
    launches = {}
    with contextlib.ExitStack() as rec:
        if stash is not None:
            for name, (module, attr) in wrapper_sites().items():
                stash[name] = rec.enter_context(
                    Recorder(module, attr, every_call=name in EVERY_CALL))
            stash["probe_stack"] = rec.enter_context(
                Calls(engine, "_probe_stack"))
            stash["combine_rows"] = rec.enter_context(
                Calls(engine, "merge_combine_rows"))
        reset_launches()
        yield launches
        launches.update(LAUNCHES)


def timed_call(fn):
    t0 = clock()
    result = fn()
    return result, clock() - t0


def path_timer(profile_dir, tag):
    """``timed(label, fn)`` -> (result, seconds): host clock, or under
    torch.profiler (its cost included) when ``profile_dir`` is set."""
    def timed(label, fn):
        if profile_dir is not None:
            return profiled(f"{tag}_{label}", fn, profile_dir)
        return timed_call(fn)
    return timed


# ------------------------------------------------------------------ phase 4e
def perrun_reads(graph, cap, reads):
    """The per-run read path (``fused_reads=False``) on phase 3's server
    and graph, timed interleaved with the fused read (fused, per-run,
    per-run, fused: the A/B the port's benchmark will set). Every read
    equals phase 3's; during the per-run reads no fused dispatch runs,
    per-run dispatches do, and no hand kernel launches (the put's
    compactions launch the merge path, counted apart). Returns the four
    runs' timings and the per-run reads' counters."""
    runs, counters = [], []
    for fused in (True, False, False, True):
        got, stats, times, _ = listing1(graph, True, cap, fused_reads=fused)
        for key in reads:
            same_triples(got[key], reads[key],
                         f"phase 4e fused_reads={fused} {key} vs phase 3")
        rs = stats["reads"]
        if not fused:
            if rs["engine"]["fused_dispatches"] or any(
                    rs["launches"].values()):
                raise AssertionError(f"phase 4e: the per-run reads ran a "
                                     f"fused dispatch or a kernel: {rs}")
            if rs["engine"]["perrun_dispatches"] <= 0:
                raise AssertionError(f"phase 4e: no per-run dispatch: {rs}")
            counters.append(rs["engine"])
        runs.append({"fused_reads": fused, "times": times,
                     "read_engine": rs["engine"],
                     "read_launches": {k: v for k, v in
                                       rs["launches"].items() if v}})
    return runs, counters


# ------------------------------------------------------------------ phase 7
WAL_DIR = ROOT / "build" / "phase7"


def crash_child(wal_root, scale, seed):
    """Phase 7's writer, a process of its own: phase 3's server with
    ``wal_root`` and the hand kernels binds the pair, puts the first half
    of the graph's triples, checkpoints, puts the second half, prints its
    timings as one JSON line and dies with ``os._exit(1)``, closing
    nothing."""
    import os
    import numpy as np
    graph, cap = make_graph(scale, seed)
    DB = server("crash", cap, True, wal_root=str(wal_root))
    DB.encode_keys(np.asarray(graph["verts"], dtype=object))
    Tedge = DB["Tedge", "TedgeT"]
    Tedge.table.store.warmup()
    r, c, v = graph["A"].triples()
    h = len(r) // 2
    _, t1 = timed_call(lambda: Tedge.put_triple(r[:h], c[:h], v[:h]))
    _, t_ckpt = timed_call(Tedge.checkpoint)
    _, t2 = timed_call(lambda: Tedge.put_triple(r[h:], c[h:], v[h:]))
    print(json.dumps({"put_halves_s": [t1, t2], "put_s": t1 + t2,
                      "checkpoint_s": t_ckpt, "entries": len(r),
                      "first_half": h}), flush=True)
    os._exit(1)


@contextlib.contextmanager
def replay_clock():
    """Stamps the suffix replay of ``recover`` (synchronised host clock):
    when it starts (manifest, dictionaries and snapshot loaded onto the
    card, blooms and fences rebuilt) and when its last batch has gone
    through ``insert``; counts the frames and entries replayed."""
    from repro_torch.db.lsm import manifest
    from repro_torch.db.lsm.wal import WriteAheadLog

    seen = {"stamps": [], "frames": 0, "entries": 0}

    class Timed(WriteAheadLog):
        @staticmethod
        def replay_full(path, start=0):
            seen["stamps"].append(clock())
            for item in WriteAheadLog.replay_full(path, start=start):
                if item[0] == "data":
                    seen["frames"] += 1
                    seen["entries"] += len(item[2])
                yield item
            seen["stamps"].append(clock())

    manifest.WriteAheadLog = Timed
    try:
        yield seen
    finally:
        manifest.WriteAheadLog = WriteAheadLog


def crash_recovery(graph, cap, reads, put_s, args, smi, stash):
    """Phase 7: a real crash of the pair at full width and its recovery on
    the card. Returns the recovery's kernel launches (its inputs go into
    ``stash`` for phase 5)."""
    import os
    import shutil
    import numpy as np
    from repro_torch.db import batching, delete, recover_connector
    from repro_torch.db.lsm import WriteAheadLog

    shutil.rmtree(WAL_DIR, ignore_errors=True)
    WAL_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--crash-child",
         str(WAL_DIR), "--scale", str(args.scale), "--seed", str(args.seed)],
        capture_output=True, text=True, timeout=900)
    t_child = time.perf_counter() - t0
    lines = [x for x in child.stdout.splitlines() if x.startswith("{")]
    if child.returncode != 1 or not lines:
        raise AssertionError(
            f"phase 7: the writer exited {child.returncode}: "
            f"{child.stdout[-2000:]} {child.stderr[-4000:]}")
    wrote = json.loads(lines[-1])
    tdir = WAL_DIR / "Tedge"
    wal, snap = tdir / "wal.log", tdir / "snapshot.npz"
    man = json.loads((tdir / "MANIFEST.json").read_text())
    frames = list(WriteAheadLog.replay(str(wal), tagged=True))
    if not frames or not all(p for *_, p in frames):
        raise AssertionError("phase 7: the WAL holds no pair-tagged frame")
    log(f"phase 7 ({smi}): the writer crashed after {t_child:.3f} s; WAL "
        f"{wal.stat().st_size / 1e6:.6f} MB in {len(frames)} frames "
        f"({man['wal_offset'] / 1e6:.6f} MB covered by the snapshot), "
        f"snapshot {snap.stat().st_size / 1e6:.6f} MB, key dictionary "
        f"{(WAL_DIR / 'keydict.json').stat().st_size / 1e6:.6f} MB")
    log(f"phase 7 ({smi}): put with the WAL {wrote['put_s']:.6f} s "
        f"(halves {wrote['put_halves_s'][0]:.6f} + "
        f"{wrote['put_halves_s'][1]:.6f}) against phase 3's put without it "
        f"{put_s:.6f} s; checkpoint {wrote['checkpoint_s']:.6f} s")

    A, sels = graph["A"], graph["sels"]
    with kernel_run(stash) as launches, replay_clock() as seen:
        t0 = clock()
        DB, E = recover_connector(str(WAL_DIR), ("Tedge", "TedgeT"))
        t_end = clock()
        got = {name: E[sel] for name, sel in sels.items()}
    load_s = seen["stamps"][0] - t0
    replay_s = seen["stamps"][1] - seen["stamps"][0]
    store = E.table.store
    if store.device.type != "cuda" or not store.use_pallas:
        raise AssertionError(f"phase 7: recovered on {store.device}, "
                             f"use_pallas={store.use_pallas}")
    for key, want in reads.items():
        same_triples(got[key], want, f"phase 7 recovered {key} vs phase 3")
    nnz = (E.nnz(), store.t_store.nnz())
    if nnz != (A.nnz(), A.nnz()):
        raise AssertionError(f"phase 7: recovered nnz {nnz}, want {A.nnz()}")
    for k in ("merge_path_rank", "rank_batched", "row_merge"):
        if launches[k] <= 0:
            raise AssertionError(f"phase 7: kernel {k} never launched in "
                                 f"the recovery: {launches}")
    log(f"phase 7 ({smi}): recovery {t_end - t0:.6f} s: manifest, "
        f"dictionaries and snapshot load {load_s:.6f} s, suffix replay "
        f"{replay_s:.6f} s ({seen['frames']} frames, {seen['entries']} "
        f"entries, {seen['entries'] / replay_s:.1f} entries/s), the rest "
        f"{t_end - t0 - load_s - replay_s:.6f} s; reads equal phase 3's, "
        f"nnz {nnz[0]}; launches " + json.dumps(
            {k: v for k, v in launches.items() if v}))
    delete(E)

    # a copy cut inside its last frame: every batch but the last survives
    cut_dir = WAL_DIR.parent / "phase7_cut"
    shutil.rmtree(cut_dir, ignore_errors=True)
    shutil.copytree(WAL_DIR, cut_dir)
    cut_wal = cut_dir / "Tedge" / "wal.log"
    os.truncate(cut_wal, cut_wal.stat().st_size - 5)
    r, c, v = A.triples()
    h = wrote["first_half"]
    last = list(batching.batch_triples(r[h:], c[h:], v[h:],
                                       batching.DEFAULT_CHAR_BUDGET))[-1]
    keep = len(r) - len(last[0])
    verts = graph["verts"]
    want = (np.searchsorted(verts, r[:keep]).astype(np.int32),
            np.searchsorted(verts, c[:keep]).astype(np.int32),
            np.asarray(v[:keep], np.float32))

    DB, E = recover_connector(str(cut_dir), ("Tedge", "TedgeT"))
    same_arrays(E.table.store.scan(), want, "phase 7 torn tail")
    same_arrays(E.table.store.t_store.scan(), (want[1], want[0], want[2]),
                "phase 7 torn tail, sibling")
    E.put_triple(np.asarray(["after_the_cut"], object),
                 np.asarray([verts[0]], object), np.asarray([7.0]))
    delete(E)  # closes the WAL: the second crash
    DB, E = recover_connector(str(cut_dir), ("Tedge", "TedgeT"))
    r2, c2, v2 = E["after_the_cut,", :].triples()
    if (list(r2), list(c2), list(v2)) != (["after_the_cut"], [verts[0]],
                                          [7.0]):
        raise AssertionError(f"phase 7: the write after the first recovery "
                             f"did not survive the second: {r2} {c2} {v2}")
    if E.nnz() != keep + 1:
        raise AssertionError(f"phase 7: second recovery nnz {E.nnz()}, "
                             f"want {keep + 1}")
    log(f"phase 7: WAL cut inside its last frame ({len(last[0])} entries "
        f"lost): the recovery equals a store fed every batch but the last "
        f"({keep} entries, both sides); a write after it survived a second "
        f"recovery")
    delete(E)
    shutil.rmtree(cut_dir, ignore_errors=True)
    shutil.rmtree(WAL_DIR, ignore_errors=True)
    return launches


# ------------------------------------------------------------------ phase 4b
def fig4(graph, cap, use_pallas, naive, seed, stash=None, profile_dir=None):
    """The D4M 2.0 schema on the raw triples, then the Fig. 4 reads
    (``benchmarks/query_bench.py::fig4``): for degree targets {1, 10, 100,
    1000} x {out: row read, in: column read}, one vertex (SV) and five (MV)
    picked by ``vertices_with_degree``, seeded. Returns (schema, server,
    launches of the put and the reads, times)."""
    import numpy as np
    from repro_torch.db import EdgeSchema

    DB = server("fig4", cap, use_pallas)
    DB.encode_keys(np.asarray(graph["verts"], dtype=object))
    g = EdgeSchema(DB, "g")
    g.pair.table.store.warmup()
    timed = path_timer(profile_dir, "fig4_" + ("kernels" if use_pallas
                                               else "ops"))
    with kernel_run(stash) as launches:
        times = fig4_put_and_reads(g, graph, naive, seed, timed)
    if use_pallas and not (launches["segment_sum"] == 2
                           and launches["merge_path_rank"] > 0
                           and launches["rank_batched"] > 0
                           and launches["row_merge"] > 0):
        raise AssertionError(f"phase 4b: kernel launches {launches}")
    if not use_pallas and any(launches.values()):
        raise AssertionError(f"phase 4b launched a hand kernel: {launches}")
    return g, DB, launches, times


def fig4_put_and_reads(g, graph, naive, seed, timed):
    """Phase 4b's put, degree checks and Fig. 4 reads; returns the times."""
    import numpy as np
    verts, (r, c, v) = graph["verts"], graph["raw"]
    _, t_put = timed("put", lambda: g.put_triple(r, c, v))
    n = len(verts)
    for k, ids in (("out_deg", graph["raw_ids"][0]),
                   ("in_deg", graph["raw_ids"][1])):
        deg = getattr(g.deg, k).cpu().numpy()
        want = np.bincount(ids, minlength=n).astype(np.float32)
        if not (np.array_equal(deg[:n], want) and not deg[n:].any()):
            raise AssertionError(f"phase 4b: {k} differs from the bincount")
    times = {"put_s": t_put, "triples_per_s": len(r) / t_put}
    rng = np.random.default_rng(seed)
    last, summed = graph["last"], graph["A"]
    for target in (1, 10, 100, 1000):
        for kind, axis in (("out", "R"), ("in", "C")):
            vs = g.deg.vertices_with_degree(target, kind=kind)
            if len(vs) == 0:
                log(f"phase 4b: no vertex of {kind}-degree ~{target}")
                continue
            single = str(rng.choice(vs)) + ","
            multi = "".join(str(x) + "," for x in rng.choice(
                vs, size=min(5, len(vs)), replace=False))
            for qname, q in (("SV", single), ("MV", multi)):
                key = (q, ":") if axis == "R" else (":", q)
                label = f"deg{target}_{qname}{axis}"
                got, times[label + "_s"] = timed(label, lambda: g[key])
                if got.nnz() == 0:
                    raise AssertionError(f"phase 4b {label}: empty read")
                same_triples(got, last[key], f"phase 4b {label} vs Assoc")
                nv = naive[key]
                same_triples(nv, summed[key], f"phase 4b {label} naive")
                if not (np.array_equal(np.sort(nv.row), np.sort(got.row))
                        and np.array_equal(np.sort(nv.col),
                                           np.sort(got.col))):
                    raise AssertionError(f"phase 4b {label}: naive keys")
    return times


# ------------------------------------------------------------------ phase 4c
def padded_read(block, q, max_return=256):
    """The single engine's point read before the compacting gather, as the
    JAX engine reads: ``block(width)`` gives the padded ``[Q, width]``
    candidate block (cols, vals, valid, counts); it is widened to the
    longest queried row (a second pass), then ``nonzero`` compacts it.
    (r, c, v) on the device."""
    import torch
    cols, vals, ok, cnt = block(max_return)
    top = int(cnt.max())
    if top > max_return:  # widen (batch scanner)
        cols, vals, ok, cnt = block(top)
    qi, ki = torch.nonzero(ok, as_tuple=True)
    return q[qi], cols[qi, ki], vals[qi, ki]


def single_engine(graph, cap, use_pallas, lsm_reads, stash=None,
                  profile_dir=None):
    """The legacy single-run engine, bulk-load sized as in
    ``benchmarks/ingest_bench.py``: the phase-3 put, then the row-id read,
    the row range and a column read (host scan + filter on this engine).
    On the kernel path every point read of a shard is ``tablet_read``: one
    two-sided ``rank`` launch and one ``tablet_gather`` launch per queried
    shard (logged per read), and each result equals the route it replaced
    at the same inputs (``tablet_query_rows``, widened, then ``nonzero``);
    the binary-search pair rank then ranks the flush's two runs both ways,
    and its ranks must equal the merge-path ranks. With ``stash`` the
    inputs of every ``tablet_read`` go to ``stash["tablet_read"]``.
    Returns (times, launches)."""
    import numpy as np
    import torch
    from repro_torch.db import delete, kvstore, put
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.merge_rank import ops as merge_ops

    A, verts, sels = graph["A"], graph["verts"], graph["sels"]
    batch_cap = 1 << 15
    DB = server("single", cap, use_pallas, engine="single",
                memtable_cap=max(cap, 4 * batch_cap))
    DB.encode_keys(np.asarray(verts, dtype=object))
    T = DB["Tsingle"]
    T.store.warmup()
    timed = path_timer(profile_dir, "single_" + ("kernels" if use_pallas
                                                 else "ops"))
    per_read = {}
    with kernel_run(stash) as launches, \
            Calls(merge_ops, "merge_ranks", keep=True) as merges, \
            Calls(kvstore, "tablet_read", keep=True) as reads:
        _, t_put = timed("put", lambda: put(T, A))
        times = {"put_s": t_put, "ingest_entries_per_s": A.nnz() / t_put}
        for name in ("row_ids", "row_range", "col_ids"):
            sel = sels[name]
            before, n_reads = dict(LAUNCHES), reads.n
            got, times[name + "_s"] = timed(name, lambda: T[sel])
            per_read[name] = {k: v - before[k] for k, v in LAUNCHES.items()
                              if v != before[k]}
            per_read[name]["tablet_read_calls"] = reads.n - n_reads
            same_triples(got, lsm_reads[name], f"phase 4c {name} vs LSM")
            same_triples(got, A[sel], f"phase 4c {name} vs Assoc")
        if use_pallas:  # the binary search on the flush's runs, both ways
            for (ar, ac, br, bc), (rank_a, rank_b) in merges.kept:
                if not (torch.equal(merge_ops.pair_rank(
                        br, bc, ar, ac, strict=True), rank_a)
                        and torch.equal(merge_ops.pair_rank(
                            ar, ac, br, bc, strict=False), rank_b)):
                    raise AssertionError(f"phase 4c: pair_rank differs from "
                                         f"the merge ranks at {ar.shape} x "
                                         f"{br.shape}")
            log(f"phase 4c: pair_rank equals the merge ranks at "
                + ", ".join(f"{list(a[0].shape)} x {list(a[2].shape)}"
                            for a, _ in merges.kept))
    log(f"phase 4c (use_pallas={use_pallas}) launches per read: "
        + json.dumps(per_read))
    if use_pallas:
        for name, got in per_read.items():
            n = got["tablet_read_calls"]
            if not (got.get("rank", 0) == got.get("tablet_gather", 0) == n
                    and n == (1 if name == "row_ids" else 0)):
                raise AssertionError(f"phase 4c {name}: launches {got}, want "
                                     f"one rank and one tablet_gather per "
                                     f"queried shard")
        for (rows, cols, vals, q), got in reads.kept:  # the route replaced
            t = kvstore.Tablet(rows=rows, cols=cols, vals=vals, n=None)
            want = padded_read(lambda w: kvstore.tablet_query_rows(t, q, w),
                               q)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"phase 4c: tablet_read differs from "
                                     f"the padded read at {list(q.shape)}")
        log(f"phase 4c: tablet_read equals the padded read at "
            + ", ".join(f"Q={a[3].shape[0]} ({g[0].shape[0]} entries)"
                        for a, g in reads.kept))
        if stash is not None:
            stash["tablet_read"] = [([a.clone() for a in args], got)
                                    for args, got in reads.kept]
    st = T.store.engine_stats()
    if st["flushes"] < 1:
        raise AssertionError(f"phase 4c: no flush ({st})")
    if use_pallas and not all(launches[k] > 0 for k in (
            "rank", "tablet_gather", "merge_path_rank", "pair_rank")):
        raise AssertionError(f"phase 4c: rank / tablet_gather / "
                             f"merge_path_rank / pair_rank never launched "
                             f"({launches})")
    if not use_pallas and any(launches.values()):
        raise AssertionError(f"phase 4c launched a hand kernel: {launches}")
    delete(T)
    return times, launches


# ------------------------------------------------------------------ phase 4d
def graphulo_spmv(g, DB, seed, stash=None):
    """``table_spmv`` on the schema's Tedge, on both routes (the CSR kernel,
    and the PyTorch product on the card), and the ELL kernel on the ELL of
    the same scan (built and copied once, off the clock), against a float64
    product on the host from the table's scan: exactly for a one-hot x at
    the largest out-degree vertex, within rtol=1e-5 (kernels, float32) or
    1e-12 (the float64 PyTorch route) for a random x. Returns (times,
    launches)."""
    import numpy as np
    import torch
    from repro_torch.db import graphulo
    from repro_torch.kernels.spmv import ell_from_coo
    from repro_torch.kernels.spmv import ops as spmv_ops

    n = len(DB.keydict)
    r, c, v = DB["g_Tedge"].store.scan()
    order = np.lexsort((c, r))  # row-sorted, as the ELL build takes it
    r, c, v = r[order], c[order], v[order].astype(np.float64)
    counts = np.bincount(r, minlength=n)
    log(f"phase 4d: CSR {n} rows, {len(r)} entries, "
        f"{4 * (2 * n + 1) + 8 * len(r) + 4 * n} bytes of indptr, cols, "
        f"vals, x and y; the ELL of the same scan {n} x {int(counts.max())} "
        f"slots, {8 * n * int(counts.max())} bytes of cols + vals")
    dev = g.pair.table.store.device
    ell = [torch.as_tensor(a, device=dev) for a in ell_from_coo(r, c, v, n)]
    hub = int(np.argmax(g.deg.out_deg[:n].cpu().numpy()))
    one_hot = np.zeros(n)
    one_hot[hub] = 1.0
    x_rand = np.random.default_rng(seed).random(n)
    times = {}
    with kernel_run(stash) as launches:
        for label, x in (("one_hot", one_hot), ("random", x_rand)):
            want = np.zeros(n)
            np.add.at(want, r, v * x[c])
            yk, times[label + "_kernel_s"] = timed_call(
                lambda: graphulo.table_spmv(g.pair, x, use_pallas=True))
            yd, times[label + "_ops_s"] = timed_call(
                lambda: graphulo.table_spmv(g.pair, x, use_pallas=False))
            xd = torch.as_tensor(x.astype(np.float32), device=dev)
            ye, times[label + "_ell_kernel_s"] = timed_call(
                lambda: spmv_ops.spmv_ell(*ell, xd).cpu().numpy())
            m = int(r.max()) + 1
            if yk.shape != (n,) or ye.shape != (n,) or yd.shape != (m,) \
                    or want[m:].any():
                raise AssertionError(f"phase 4d {label}: shapes")
            if label == "one_hot":
                if not (np.array_equal(yk, want) and np.array_equal(ye, want)
                        and np.array_equal(yd, want[:m])):
                    raise AssertionError("phase 4d one_hot: not exact")
            else:
                np.testing.assert_allclose(yk, want, rtol=1e-5,
                                           err_msg="phase 4d random, CSR")
                np.testing.assert_allclose(ye, want, rtol=1e-5,
                                           err_msg="phase 4d random, ELL")
                np.testing.assert_allclose(yd, want[:m], rtol=1e-12,
                                           err_msg="phase 4d random, ops")
    if launches["spmv_csr"] != 2 or launches["spmv_ell"] != 2 \
            or sum(launches.values()) != 4:
        raise AssertionError(f"phase 4d: kernel launches {launches}")
    return times, launches


# ------------------------------------------------------------------ phase 6
SERVE_ARCH = "smollm-135m"


def serving(seed, stash, profile_dir=None):
    """The LM serving path at full width, in bf16, on the card: run a
    through ``repro_torch.launch.serve.main`` with its defaults, run b (a
    long context at SmolLM-135M's published 2,048-token window) through
    ``Engine``; then the card's first prefill of run a against the same
    weights' prefill on the CPU, and prefill-then-decode against the full
    prefill. With ``profile_dir`` set, both runs are then repeated under
    torch.profiler. Returns (stats, launches) of the two runs."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import build, init_params, transformer
    from repro_torch.serve import Engine, Request

    cfg = get_config(SERVE_ARCH)
    model = build(cfg)
    log(f"phase 6: {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads}, hd {cfg.hd}, vocab "
        f"{cfg.vocab} (padded {cfg.vocab_padded}), {cfg.param_dtype}")
    stats, launches = {}, {}
    torch.cuda.reset_peak_memory_stats()
    with kernel_run(stash["serve_a"]) as launches["serve_a"]:
        stats["serve_a"] = launch_serve.main(["--arch", SERVE_ARCH,
                                              "--seed", str(seed)])
    # the CLI's weights and prompts: its seeded CPU generator and numpy rng
    params = init_params(model.param_specs, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    prompts_a = [rng.integers(1, cfg.vocab, rng.integers(4, 24)).astype(
        np.int32) for _ in range(8)]
    rng = np.random.default_rng(seed)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, 1920).astype(np.int32),
                    max_new=128) for _ in range(4)]
    engine = Engine(model, params, batch_slots=4, max_len=2048)
    with kernel_run(stash["serve_b"]) as launches["serve_b"]:
        stats["serve_b"] = engine.run(reqs)
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # every request yields its tokens; self-attention is the kernel only:
    # batches x (1 prefill + max_new - 1 decode steps) x layers
    for run, n_tok, want in (("serve_a", 8 * 16, 2 * 16 * cfg.n_layers),
                             ("serve_b", 4 * 128, 1 * 128 * cfg.n_layers)):
        got = launches[run]
        if stats[run]["tokens_out"] != n_tok:
            raise AssertionError(f"phase 6 {run}: {stats[run]['tokens_out']} "
                                 f"tokens, want {n_tok}")
        if got["flash_attention"] != want or sum(got.values()) != want:
            raise AssertionError(f"phase 6 {run}: launches {got}, want "
                                 f"{want} of flash_attention only")
    for r in reqs:
        if len(r.out) != 128 or r.out.min() < 0 or \
                r.out.max() >= cfg.vocab_padded:
            raise AssertionError(f"phase 6 serve_b: tokens {r.out}")

    # the card's first prefill of run a against the CPU's (plain attention)
    plen = max(len(p) for p in prompts_a[:4])
    toks = np.zeros((4, plen), np.int32)
    for j, p in enumerate(prompts_a[:4]):
        toks[j, plen - len(p):] = p
    toks = torch.from_numpy(toks)
    card, _ = transformer.prefill(cfg, engine.params, toks.cuda(), 128)
    cpu, _ = transformer.prefill(cfg, params, toks, 128)
    card = card.cpu()
    if card.shape != (4, 1, cfg.vocab_padded) or \
            not torch.isfinite(card).all():
        raise AssertionError(f"phase 6: prefill logits {card.shape}")
    err_cpu = float((card - cpu).abs().max())
    torch.testing.assert_close(card, cpu, rtol=2e-2, atol=2e-2,
                               msg=lambda m: f"phase 6 card vs CPU: {m}")
    # prefill then one decode step equals the full prefill (bf16: the
    # tolerance of tests/test_arch_smoke.py)
    full, _ = transformer.prefill(cfg, engine.params, toks.cuda(), 128)
    _, cache = transformer.prefill(cfg, engine.params, toks[:, :-1].cuda(),
                                   128)
    dec, _ = transformer.decode_step(cfg, engine.params, toks[:, -1:].cuda(),
                                     cache, plen - 1)
    err_dec = float((dec - full).abs().max())
    torch.testing.assert_close(dec, full, rtol=5e-2, atol=5e-2,
                               msg=lambda m: f"phase 6 decode vs prefill: {m}")
    log(f"phase 6 checks: card vs CPU prefill max |diff| {err_cpu:.6f}, "
        f"prefill-then-decode vs prefill max |diff| {err_dec:.6f}")
    if profile_dir is not None:  # one more run of each, traced
        profiled("serve_a", lambda: launch_serve.main(
            ["--arch", SERVE_ARCH, "--seed", str(seed)]), profile_dir)
        rng = np.random.default_rng(seed)
        again = [Request(prompt=rng.integers(1, cfg.vocab, 1920).astype(
            np.int32), max_new=128) for _ in range(4)]
        profiled("serve_b", lambda: engine.run(again), profile_dir)
        for r, a in zip(reqs, again):
            if not np.array_equal(r.out, a.out):
                raise AssertionError("phase 6: traced run b's tokens differ")
    return stats, launches


# ------------------------------------------------------------------ phase 10
# LM training at full width: smollm-135m in bf16 through launch/train.py,
# batch 8 x 512 tokens; the F1 pin at batch 1 x 128 tokens
P10 = dict(arch="smollm-135m", reduced=False, steps=20, crash=10, batch=8,
           seq=512, docs=64, grad_batch=1, grad_seq=128)
TRAIN_DIR = ROOT / "build" / "phase10"
# resumed losses against the uninterrupted run's: bit-equal in every run on
# the H100 so far (the state is restored bit for bit and the step's ops
# ran deterministically); the limit leaves room for float noise only
RESUME_RTOL = 1e-6


class SimulatedCrash(Exception):
    pass


def train_argv(seed, device):
    argv = ["--arch", P10["arch"], "--steps", str(P10["steps"]),
            "--batch", str(P10["batch"]), "--seq", str(P10["seq"]),
            "--docs", str(P10["docs"]), "--ckpt-every", str(P10["crash"]),
            "--seed", str(seed), "--device", str(device)]
    return argv + (["--reduced"] if P10["reduced"] else [])


def crash_resume(argv, ckpt_dir, stash, keep_leaves=False):
    """Three runs of ``repro_torch.launch.train.main(argv)`` under one
    ``kernel_run(stash)``: uninterrupted; with ``--ckpt-dir ckpt_dir``,
    "crashing" right after its first checkpoint (an exception out of
    ``checkpoint.save``, once the files are down); and that run resumed.
    Every step is timed (host clock, synchronised by the loss). Returns
    (losses, resumed losses, step seconds by run, the crash's {"step"} and
    with ``keep_leaves`` its ``"leaves"`` as numpy, launches, wall seconds
    of the uninterrupted and the resumed run)."""
    import shutil
    from repro_torch.launch import train as launch_train
    from repro_torch.models.convert import leaf_to_numpy
    from repro_torch.models.spec import tree_leaves
    from repro_torch.train import checkpoint

    step_s, saved, walls = {}, {}, {}  # step_s: run -> seconds of each step
    make_step, save = launch_train.make_train_step, checkpoint.save

    def timed_steps(run):
        def make(*a, **kw):
            step = make_step(*a, **kw)

            def timed(*args):
                t0 = clock()
                out = step(*args)
                out[2].item()
                step_s[run].append(clock() - t0)
                return out
            return timed
        step_s[run] = []
        launch_train.make_train_step = make

    def save_then_crash(ckpt_dir, step, tree, **kw):
        saved["step"] = step
        if keep_leaves:
            saved["leaves"] = [leaf_to_numpy(x) for x in tree_leaves(tree)]
        save(ckpt_dir, step, tree, **kw)
        raise SimulatedCrash(step)

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt = ["--ckpt-dir", str(ckpt_dir)]
    try:
        with kernel_run(stash) as launches:
            timed_steps("whole")
            whole, walls["whole"] = timed_call(lambda: launch_train.main(
                argv))
            timed_steps("crashed")
            checkpoint.save = save_then_crash
            try:
                launch_train.main(argv + ckpt)
                raise AssertionError(f"{argv}: the run did not crash")
            except SimulatedCrash:
                pass
            finally:
                checkpoint.save = save
            timed_steps("resumed")
            resumed, walls["resumed"] = timed_call(lambda: launch_train.main(
                argv + ckpt + ["--resume"]))
    finally:
        launch_train.make_train_step = make_step
    return whole, resumed, step_s, saved, launches, walls


def leaf_grad_errors(got, want):
    """Per leaf (in flatten order): (relative error norm of ``got``
    against ``want``, ``got``'s norm), both in float32 on the host."""
    from repro_torch.models.spec import tree_leaves
    out = []
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        out.append((float((g - w).norm() / w.norm().clamp_min(1e-30)),
                    float(g.norm())))
    return out


def training(seed, smi, stash, device="cuda"):
    """Phase 10: LM training at full width on the card. (a) Through
    ``repro_torch.launch.train.main``: an uninterrupted run of
    ``P10["steps"]`` steps; a run with a checkpoint every ``P10["crash"]``
    steps that "crashes" right after its first checkpoint (an exception
    out of ``checkpoint.save``, once the files are down), whose leaves
    must be byte-equal to the state in memory at the save; and its resume
    to the last step, whose losses must equal the uninterrupted run's
    within ``RESUME_RTOL``; the loss must fall. Every step is timed (host
    clock, synchronised by the training loop's ``float(loss)``). (b) One step's
    gradient of every leaf on the card (bf16) against the same weights'
    on the CPU (float32): relative error norm <= 5e-2 and a non-zero norm
    for every leaf; the same check must fail a planted F1 (the attention
    output detached from q, k and v). (c) During (a), self-attention ran
    only on #7: 2 launches a layer a step (the remat recompute), and no
    other kernel. Returns (stats, launches of (a))."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref
    from repro_torch.models import build, init_params, layers
    from repro_torch.models.spec import tree_map
    from repro_torch.train import checkpoint
    from repro_torch.train.train_step import loss_and_grads

    cfg = (get_reduced if P10["reduced"] else get_config)(P10["arch"])
    model = build(cfg)
    n_steps, crash = P10["steps"], P10["crash"]
    tokens_step = P10["batch"] * P10["seq"]
    log(f"phase 10: {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, hd "
        f"{cfg.hd}, vocab {cfg.vocab}, {cfg.param_dtype}; {n_steps} steps "
        f"of {P10['batch']} x {P10['seq']} tokens, remat dots_no_batch")
    if device == "cuda":  # what earlier phases hold stays out of the peak
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    t_a = time.perf_counter()
    whole, resumed, step_s, saved, launches, walls = crash_resume(
        train_argv(seed, device), TRAIN_DIR, stash, keep_leaves=True)
    t_whole, t_resumed = walls["whole"], walls["resumed"]
    t_a = time.perf_counter() - t_a
    if device == "cuda":
        peak = torch.cuda.max_memory_allocated()
        peak_gb, own_gb = peak / 1e9, (peak - held) / 1e9
    else:
        peak_gb = own_gb = float("nan")
    if len(whole) != n_steps or not np.all(np.isfinite(whole)):
        raise AssertionError(f"phase 10: losses {whole}")
    if not whole[-1] < whole[0]:
        raise AssertionError(f"phase 10: the loss did not fall: {whole}")
    if saved.get("step") != crash or len(resumed) != n_steps - crash:
        raise AssertionError(f"phase 10: crashed at {saved.get('step')}, "
                             f"resumed {len(resumed)} steps")
    resume_err = max(abs(a - b) / abs(b) for a, b in zip(resumed,
                                                         whole[crash:]))
    if resume_err > RESUME_RTOL:
        raise AssertionError(f"phase 10: resumed losses {resumed} vs "
                             f"{whole[crash:]} (rel {resume_err:.3g})")
    d = TRAIN_DIR / f"step_{crash:08d}"
    for i, want in enumerate(saved["leaves"]):
        got = np.load(d / f"leaf_{i:05d}.npy")
        if got.shape != want.shape or got.tobytes() != want.tobytes():
            raise AssertionError(f"phase 10: checkpoint leaf {i} differs "
                                 f"from the state at the save")
    if checkpoint.latest_step(str(TRAIN_DIR)) != n_steps:
        raise AssertionError("phase 10: no final checkpoint")
    # (c) self-attention on the kernel only, twice a layer a step
    want_launches = 2 * cfg.n_layers * (n_steps + crash + n_steps - crash)
    if launches["flash_attention"] != want_launches or \
            sum(launches.values()) != want_launches:
        raise AssertionError(f"phase 10: launches {launches}, want "
                             f"{want_launches} of flash_attention only")
    steady = sorted(step_s["whole"][1:])
    med = steady[len(steady) // 2]
    stats = {"losses": whole, "resumed": resumed, "resume_rel_err": resume_err,
             "first_step_s": step_s["whole"][0], "median_step_s": med,
             "step_s": {k: v for k, v in step_s.items()},
             "tok_per_s": tokens_step / med, "wall_whole_s": t_whole,
             "wall_resumed_s": t_resumed, "wall_a_s": t_a,
             "peak_mem_gb": own_gb, "peak_mem_total_gb": peak_gb,
             "checkpoint_leaves": len(saved["leaves"]),
             "checkpoint_mb": sum(x.nbytes for x in saved["leaves"]) / 1e6}
    log(f"phase 10 (a) ({smi}): losses {whole[0]:.4f} -> {whole[-1]:.4f}; "
        f"resumed from step {crash} to {n_steps}, largest relative loss "
        f"difference {resume_err:.3g}; step {med * 1e3:.3f} ms median "
        f"(first {step_s['whole'][0] * 1e3:.3f} ms), "
        f"{tokens_step / med:.1f} tokens/s; training's peak device memory "
        f"{own_gb:.3f} GB ({peak_gb:.3f} GB with what earlier phases "
        f"hold); checkpoint of {len(saved['leaves'])} leaves, "
        f"{stats['checkpoint_mb']:.1f} MB, byte-equal to the state at the "
        f"save; launches {json.dumps({k: v for k, v in launches.items() if v})}")

    # the plain backward's time beside the kernel forward's, at (a)'s
    # attention inputs (the recorded geometry)
    args, kw = next(iter(stash["flash_attention"].calls.values()))[1]
    q, k, v = args
    dout = torch.randn_like(q)
    if device == "cuda":
        stats["attn_bwd_ms"] = cuda_ms(lambda: flash_attention_bwd_ref(
            q, k, v, dout, causal=True), 5, warm=1)
        stats["attn_fwd_ms"] = cuda_ms(lambda: layers.flash_attention(
            q, k, v, causal=True), 20)
        log(f"phase 10 ({smi}): attention at {list(q.shape)} "
            f"{str(q.dtype)[6:]}: kernel forward {stats['attn_fwd_ms']:.6g} "
            f"ms, plain backward (recompute) {stats['attn_bwd_ms']:.6g} ms "
            f"a layer, {cfg.n_layers * stats['attn_bwd_ms']:.6g} ms a step")

    # (b) F1's pin: every leaf's gradient on the card against the CPU's
    gen = torch.Generator().manual_seed(seed + 1)
    params = init_params(model.param_specs, torch.Generator().manual_seed(seed))
    if device == "cuda":
        stats["profile"] = step_profile(model, params, seed)
        log(f"phase 10 ({smi}) one traced step: " + json.dumps(
            stats["profile"]))
    toks = torch.randint(1, cfg.vocab, (P10["grad_batch"], P10["grad_seq"]),
                         dtype=torch.int32, generator=gen)
    cpu_params = tree_map(lambda p: p.float(), params)
    _, want = loss_and_grads(model, cpu_params, {"tokens": toks})
    card_params = tree_map(lambda p: p.to(device), params)
    batch = {"tokens": toks.to(device)}
    _, got = loss_and_grads(model, card_params, batch)
    errs = leaf_grad_errors(got, want)
    names = leaf_names(params)
    bad = [(n, e) for n, e in zip(names, errs) if e[0] > 5e-2 or e[1] <= 0]
    if bad:
        raise AssertionError(f"phase 10 (b): leaf gradients off: {bad}")
    real = layers.flash_attention

    def detached(q, k, v, **kw):  # F1: no edge back to q, k, v
        return real(q.detach(), k.detach(), v.detach(), **kw)

    layers.flash_attention = detached
    try:
        _, planted = loss_and_grads(model, card_params, batch)
    finally:
        layers.flash_attention = real
    perrs = leaf_grad_errors(planted, want)
    caught = [n for n, e in zip(names, perrs) if e[0] > 5e-2 or e[1] <= 0]
    if not caught:
        raise AssertionError("phase 10 (b): the check passes a planted F1")
    stats["grad_rel_err"] = dict(zip(names, (e[0] for e in errs)))
    stats["planted_f1_caught"] = caught
    log(f"phase 10 (b) ({smi}): every leaf's gradient on the card (bf16) "
        f"against the CPU's (float32) at {P10['grad_batch']} x "
        f"{P10['grad_seq']} tokens, relative error norm <= "
        f"{max(e[0] for e in errs):.4g} (limit 5e-2), norms > 0: "
        + json.dumps(stats["grad_rel_err"])
        + f"; a planted F1 fails on {caught}")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return stats, launches


def step_profile(model, params, seed):
    """One train step of (a)'s shape on fresh weights, after one untimed
    step, under torch.profiler: wall ms (the profiler's cost included),
    summed device ms of the kernels and copies, the busy share, and the
    top 12 device ops by self device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.spec import tree_map
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    params = tree_map(lambda p: p.cuda(), params)
    opt_cfg = AdamWConfig(peak_lr=3e-3, warmup_steps=2, total_steps=20)
    step = make_train_step(model, opt_cfg)
    toks = torch.randint(1, model.cfg.vocab, (P10["batch"], P10["seq"]),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed + 2))
    batch = {"tokens": toks.cuda()}
    state = step(params, adamw_init(params, opt_cfg), batch)
    state[2].item()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = clock()
        step(state[0], state[1], batch)[2].item()
        wall = (clock() - t0) * 1e3
    ka = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(ka[0], "self_device_time_total") else
           "self_cuda_time_total")
    dev = sorted(((getattr(e, key) / 1e3, e.key, e.count) for e in ka
                  if e.device_type != DeviceType.CPU and getattr(e, key) > 0),
                 reverse=True)
    total = sum(ms for ms, _, _ in dev)
    return {"wall_ms": wall, "device_ms": total, "busy": total / wall,
            "kernels": len(dev), "launches": sum(n for _, _, n in dev),
            "top": [[name[:60], round(ms, 3), n] for ms, name, n in dev[:12]]}


def leaf_names(tree, prefix=""):
    """Slash-joined key paths of a tree's leaves, in flatten order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


# ------------------------------------------------------------------ phase 11
# The MoE, Mamba2 and hybrid families on the card: (a) olmoe-1b-7b served
# at full width and depth, (b) kimi-k2 at full width and 1 layer, (c)
# mamba2-2.7b and (d) zamba2-2.7b at full width and depth, prefill then
# decode, (e) one training step per family at full width and reduced depth
P11 = dict(reduced=False, moe="olmoe-1b-7b", kimi="kimi-k2-1t-a32b",
           kimi_layers=1, ssm="mamba2-2.7b", hybrid="zamba2-2.7b",
           long_requests=4, long_prompt=1920, long_new=32, long_max_len=2048,
           cpu_layers=2, kimi_requests=4, kimi_prompt=512, kimi_new=16,
           ssm_batch=4, ssm_prompt=2048, ssm_decode=64, train_batch=2,
           train_seq=256, train_steps=2, trace_new=8, trace_decode=4,
           train_layers={"olmoe-1b-7b": 2, "mamba2-2.7b": 2,
                         "zamba2-2.7b": 6})
# where phase 11's traced runs write their per-op tables: olmoe's run b
# with trace_new new tokens, mamba2's and zamba2's bf16 prefill and
# trace_decode steps (the profiler's bookkeeping costs ~0.5 ms an event)
TRACE_DIR = ROOT / "build" / "phase11"


def p11_config(arch, **kw):
    import dataclasses
    from repro_torch.configs import get_config, get_reduced
    cfg = (get_reduced if P11["reduced"] else get_config)(arch)
    return dataclasses.replace(cfg, **kw) if kw else cfg


def describe(cfg):
    extra = ""
    if cfg.family == "moe":
        extra = (f", {cfg.n_experts} experts, top {cfg.experts_per_token}, "
                 f"{cfg.n_shared_experts} shared")
    if cfg.family in ("ssm", "hybrid"):
        extra = (f", d_inner {cfg.d_inner}, {cfg.ssm_heads} SSM heads of "
                 f"{cfg.ssm_headdim}, state {cfg.ssm_state}, chunk "
                 f"{cfg.ssm_chunk}")
    if cfg.family == "hybrid":
        extra += f", shared attention every {cfg.shared_attn_every}"
    if cfg.family == "encdec":
        extra = (f", {cfg.n_enc_layers} encoder layers over "
                 f"{cfg.n_frames} frames, d_ff {cfg.d_ff}, {cfg.mlp}, "
                 f"{cfg.norm}")
    if cfg.family == "vlm":
        extra = f", d_ff {cfg.d_ff}, {cfg.n_img_tokens} image tokens"
    attn = ("" if cfg.family == "ssm" else
            f", {cfg.n_heads} heads over {cfg.n_kv_heads}, hd {cfg.hd}")
    return (f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}"
            f"{attn}{extra}, vocab {cfg.vocab}, {cfg.param_dtype}")


def free_card():
    import gc
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def finite_logits(engine):
    """Wrap ``engine._greedy`` so that every logits tensor it sees is
    checked finite; returns the list of the checks' results."""
    import torch
    seen, greedy = [], engine._greedy

    def checked(logits):
        seen.append(bool(torch.isfinite(logits).all()))
        return greedy(logits)
    engine._greedy = checked
    return seen


def moe_serving(seed, smi, stash, device="cuda"):
    """11a: olmoe-1b-7b at full width and depth through
    ``launch.serve.main``'s defaults, then one long batch through
    ``Engine``; the first prefill of the defaults at full width and
    ``cpu_layers`` layers against the CPU's float32 prefill. Returns
    launches by path."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import moe, transformer
    from repro_torch.models.spec import tree_map
    from repro_torch.serve import Engine, Request

    arch = P11["moe"]
    cfg = p11_config(arch)
    log(f"phase 11a: {describe(cfg)}")
    launches, t0 = {}, time.perf_counter()
    argv = ["--arch", arch, "--seed", str(seed), "--device", str(device)]
    if P11["reduced"]:
        argv.append("--reduced")
    with Calls(launch_serve, "Engine", keep=True) as made, \
            kernel_run(stash["moe_a"]) as launches["moe_a"]:
        stats_a = launch_serve.main(argv)
    engine = made.kept[0][1]
    params = engine.params
    rng = np.random.default_rng(seed)
    prompts_a = [rng.integers(1, cfg.vocab, rng.integers(4, 24)).astype(
        np.int32) for _ in range(8)]
    rng = np.random.default_rng(seed)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, P11["long_prompt"])
                    .astype(np.int32), max_new=P11["long_new"])
            for _ in range(P11["long_requests"])]
    engine_b = Engine(engine.model, params, batch_slots=4,
                      max_len=P11["long_max_len"], device=device)
    finite = finite_logits(engine_b)
    with kernel_run(stash["moe_b"]) as launches["moe_b"]:
        stats_b = engine_b.run(reqs)
    for run, st, n_tok, forwards in (
            ("moe_a", stats_a, 8 * 16, 2 * 16),
            ("moe_b", stats_b, P11["long_requests"] * P11["long_new"],
             P11["long_new"])):
        want = forwards * cfg.n_layers
        got = launches[run]
        if st["tokens_out"] != n_tok:
            raise AssertionError(f"phase 11a {run}: {st['tokens_out']} "
                                 f"tokens, want {n_tok}")
        if got["flash_attention"] != want or sum(got.values()) != want:
            raise AssertionError(f"phase 11a {run}: launches {got}, want "
                                 f"{want} of flash_attention only")
        log(f"phase 11a ({smi}) {run}: " + json.dumps(
            {k: st[k] for k in ("tok_per_s", "wall_s", "prefill_s",
                                "decode_s", "decode_steps", "tokens_out",
                                "batches")}
            | {"flash_attention": got["flash_attention"]}))
    if not all(finite) or any(len(r.out) != P11["long_new"] for r in reqs):
        raise AssertionError("phase 11a moe_b: non-finite logits or short "
                             "outputs")
    if device == "cuda":  # run b once more, shorter, traced: busy share
        again = [Request(prompt=r.prompt, max_new=P11["trace_new"])
                 for r in reqs]
        profiled("moe_b", lambda: engine_b.run(again), TRACE_DIR)

    # the first prefill of the defaults at full width and cpu_layers
    # layers against the CPU's float32 prefill. The card runs it in float32
    # too (the same weights, cast), so that the routing cannot flip on bf16
    # rounding: within 1e-3. The card's bf16 prefill (the served dtype) is
    # held to the CPU's own bf16 prefill, each against the CPU's float32
    # one: its error at most 1.5x the CPU's, its routing choices that
    # differ at most 1.5x the CPU's + 8
    plen = max(len(p) for p in prompts_a[:4])
    toks = np.zeros((4, plen), np.int32)
    for j, p in enumerate(prompts_a[:4]):
        toks[j, plen - len(p):] = p
    toks = torch.from_numpy(toks)
    nl = P11["cpu_layers"]
    cut = dataclasses.replace(cfg, n_layers=nl)
    cut32 = dataclasses.replace(cut, param_dtype="float32")
    p_cut = dict(params, blocks=tree_map(lambda w: w[:nl], params["blocks"]))

    def prefill(c, prm, dev):
        with Calls(moe, "route", keep=True) as routes:
            out, _ = transformer.prefill(c, prm, toks.to(dev), 128)
        return out.float().cpu(), [r.eidx.cpu() for _, r in routes.kept]

    runs = {"card_f32": (cut32, tree_map(lambda w: w.float(), p_cut), device),
            "card_bf16": (cut, p_cut, device),
            "cpu_bf16": (cut, tree_map(lambda w: w.detach().cpu(), p_cut),
                         "cpu"),
            "cpu_f32": (cut32, tree_map(lambda w: w.detach().float().cpu(),
                                        p_cut), "cpu")}
    got = {}
    for name in runs:
        got[name] = prefill(*runs[name])
        runs[name] = None
    want, want_routes = got["cpu_f32"]
    cmp = {}
    for name in ("card_f32", "card_bf16", "cpu_bf16"):
        out, routes = got[name]
        if out.shape != want.shape or not torch.isfinite(out).all():
            raise AssertionError(f"phase 11a: {name} prefill {out.shape}")
        cmp[name] = {"rel_err": float((out - want).norm() / want.norm()),
                     "routing_differs": sum(int((a != b).sum()) for a, b
                                            in zip(routes, want_routes))}
    cmp["choices"] = sum(r.numel() for r in want_routes)
    bf16, cpu16 = cmp["card_bf16"], cmp["cpu_bf16"]
    if cmp["card_f32"]["rel_err"] > 1e-3 or \
            bf16["rel_err"] > 1.5 * cpu16["rel_err"] or \
            bf16["routing_differs"] > 1.5 * cpu16["routing_differs"] + 8:
        raise AssertionError(f"phase 11a: the card's prefill at {nl} layers "
                             f"vs the CPU's: {cmp}")
    log(f"phase 11a ({smi}): the first prefill at full width and {nl} "
        f"layers against the CPU's float32 prefill (relative error norm of "
        f"the logits, routing choices that differ): " + json.dumps(cmp)
        + f"; {time.perf_counter() - t0:.3f} s")
    del engine, engine_b, params, made
    free_card()
    return launches


def kimi_serving(seed, smi, stash, device="cuda"):
    """11b: kimi-k2 at full width and ``kimi_layers`` layers, weights
    drawn on the card, through ``api.build`` and ``Engine``."""
    import numpy as np
    import torch
    from repro_torch.models import build, init_params, param_count
    from repro_torch.serve import Engine, Request

    cfg = p11_config(P11["kimi"], n_layers=P11["kimi_layers"])
    model = build(cfg)
    log(f"phase 11b: {describe(cfg)} (depth cut to {cfg.n_layers} of "
        f"{p11_config(P11['kimi']).n_layers}); "
        f"{param_count(model.param_specs) / 1e9:.3f} B parameters")
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(model.param_specs, gen)
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, P11["kimi_prompt"])
                    .astype(np.int32), max_new=P11["kimi_new"])
            for _ in range(P11["kimi_requests"])]
    engine = Engine(model, params, batch_slots=4,
                    max_len=P11["kimi_prompt"] + P11["kimi_new"],
                    device=device)
    finite = finite_logits(engine)
    with kernel_run(stash["kimi"]) as launches:
        st = engine.run(reqs)
    want = P11["kimi_new"] * cfg.n_layers
    if st["tokens_out"] != len(reqs) * P11["kimi_new"] or not all(finite):
        raise AssertionError(f"phase 11b: {st['tokens_out']} tokens, "
                             f"finite logits {all(finite)}")
    if launches["flash_attention"] != want or sum(launches.values()) != want:
        raise AssertionError(f"phase 11b: launches {launches}, want {want} "
                             f"of flash_attention only")
    mem = (torch.cuda.max_memory_allocated() / 1e9
           if torch.cuda.is_available() else float("nan"))
    log(f"phase 11b ({smi}): " + json.dumps(
        {k: st[k] for k in ("tok_per_s", "wall_s", "prefill_s", "decode_s",
                            "decode_steps", "tokens_out")}
        | {"init_s": t_init, "flash_attention": launches["flash_attention"],
           "peak_mem_gb": mem}))
    del engine, params
    free_card()
    return launches


def full_logits(cfg, params, tokens, first):
    """The logits [B, S - first, vocab_padded] of positions first..S-1 from
    one causal forward over ``tokens`` (the train path's forward)."""
    import torch
    from repro_torch.models import hybrid, mamba2
    module = {"ssm": mamba2, "hybrid": hybrid}[cfg.family]
    with torch.no_grad():
        return module.logits(cfg, params, tokens)[:, first:]


def state_serving(arch, path, part, seed, smi, stash, device="cuda"):
    """11c / 11d: an SSM or hybrid model at full width and depth, weights
    drawn on the card: prefill of ``ssm_batch`` x ``ssm_prompt`` tokens,
    then ``ssm_decode`` teacher-forced decode steps, each step's logits
    against one forward over the same tokens. In bf16 (the serving
    numbers) the prefill and decode arithmetic round at different places
    (the chunked scan rounds ``x * dt`` and ``D * x`` to bf16, the decode
    step keeps them in float32), so the gate is the same run on the same
    weights cast to float32 (relative error norm <= 1e-3 at every step);
the bf16 run's own drift is held to <= 0.1 at every step. The float32
    twin's launches are recorded under ``stash[path + "_check"]``: phase 5
    checks them, and they do not count as the path's. Returns (stats,
    launches, the twin's launches)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.models import build, init_params, param_count
    from repro_torch.models.spec import tree_map

    cfg = p11_config(arch)
    log(f"phase 11{part}: {describe(cfg)}; "
        f"{param_count(build(cfg).param_specs) / 1e9:.3f} B parameters")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(build(cfg).param_specs, gen)
    b, s, n_dec = P11["ssm_batch"], P11["ssm_prompt"], P11["ssm_decode"]
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (b, s + n_dec))
                            .astype(np.int32)).to(device)

    def run(c, prm, steps=n_dec):
        """Prefill, then ``steps`` decode steps: (logits of positions
        s-1 .. s+steps-1, prefill s, decode step seconds)."""
        model = build(c)
        t0 = clock()
        logits, state = model.prefill(prm, {"tokens": toks[:, :s],
                                            "max_len": s + n_dec})
        out, dec_s = [logits], []
        t_pre = clock() - t0
        for i in range(steps):
            t1 = clock()
            logits, state = model.decode(prm, {
                "token": toks[:, s + i:s + i + 1], "cache": state,
                "pos": s + i})
            dec_s.append(clock() - t1)
            out.append(logits)
        return torch.cat(out, dim=1), t_pre, dec_s

    def errors(c, prm, got):
        want = full_logits(c, prm, toks, s - 1)
        return [float((got[:, i] - want[:, i]).float().norm()
                      / want[:, i].float().norm()) for i in range(n_dec + 1)]

    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    with kernel_run(stash[path]) as launches:
        got, t_pre, dec_s = run(cfg, params)
    params32 = tree_map(lambda w: w.float(), params)
    with kernel_run(stash[path + "_check"]) as twin:
        got32, t_pre32, dec_s32 = run(cfg32, params32)
    if device == "cuda":  # the prefill and a few steps, traced: busy share
        profiled(path, lambda: run(cfg, params, P11["trace_decode"]),
                 TRACE_DIR)
    t0 = clock()
    rels = errors(cfg, params, got)
    t_full = clock() - t0
    rels32 = errors(cfg32, params32, got32)
    if not torch.isfinite(got).all() or max(rels32) > 1e-3 or \
            max(rels) > 0.1:
        raise AssertionError(f"phase 11{part}: prefill-then-decode vs one "
                             f"forward, relative error norms: float32 "
                             f"{rels32}, bf16 {rels}")
    n_attn = 0 if cfg.family == "ssm" else cfg.n_layers // \
        cfg.shared_attn_every
    want_l = n_attn * (1 + n_dec)
    for run_l in (launches, twin):
        if run_l["flash_attention"] != want_l or \
                sum(run_l.values()) != want_l:
            raise AssertionError(f"phase 11{part}: launches {run_l}, want "
                                 f"{want_l} of flash_attention only")
    stats = {"prefill_s": t_pre, "prefill_tok_per_s": b * s / t_pre,
             "decode_step_ms_median": 1e3 * sorted(dec_s)[len(dec_s) // 2],
             "decode_tok_per_s": b * len(dec_s) / sum(dec_s),
             "one_forward_s": t_full, "f32_prefill_s": t_pre32,
             "f32_decode_step_ms_median":
                 1e3 * sorted(dec_s32)[len(dec_s32) // 2],
             "max_rel_err_f32": max(rels32), "max_rel_err_bf16": max(rels),
             "rel_err_bf16_first_last": [rels[1], rels[-1]],
             "flash_attention": launches["flash_attention"]}
    if n_attn:
        stats["decode_splits"] = attn_ops.decode_splits(
            b, 1, s + n_dec, cfg.n_heads, cfg.n_kv_heads, True, s)
        if device == "cuda" and stats["decode_splits"] < 2:
            raise AssertionError(f"phase 11{part}: decode ran unsplit")
    log(f"phase 11{part} ({smi}): prefill {b} x {s} tokens then "
        f"{n_dec} decode steps, bf16 then float32: " + json.dumps(stats))
    del params, params32, got, got32
    free_card()
    return stats, launches, twin


def family_training(seed, smi, stash, device="cuda"):
    """11e: one training step per family through ``make_train_step`` at
    full width and reduced depth (``train_layers``), then every leaf's
    gradient on the card against the same weights' on the CPU (computed
    after the card's counted block): mamba2 and zamba2 in bf16 against
    float32 (relative error norm <= 5e-2), olmoe in float32 on both
    (<= 1e-3, the routing compared). Self-attention runs only on #7,
    twice a layer a call (the remat recompute). The card's gradient run
    for the check is recorded under ``stash["train_families_check"]``:
    phase 5 checks its inputs, and they do not count as the path's.
    Returns (stats, launches, the check's launches)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import build, init_params, moe
    from repro_torch.models.spec import tree_leaves, tree_map
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.train_step import loss_and_grads

    runs, want_l = [], 0
    with kernel_run(stash["train_families"]) as launches:
        for arch in (P11["moe"], P11["ssm"], P11["hybrid"]):
            kw = {} if P11["reduced"] else {
                "n_layers": P11["train_layers"][arch]}
            if arch == P11["moe"]:  # routing cannot flip on bf16 rounding
                kw["param_dtype"] = "float32"
            cfg = p11_config(arch, **kw)
            model = build(cfg)
            n_attn = {"moe": cfg.n_layers, "ssm": 0}.get(
                cfg.family, cfg.n_layers // max(cfg.shared_attn_every, 1))
            want_l += 2 * n_attn * P11["train_steps"]
            params = init_params(model.param_specs,
                                 torch.Generator().manual_seed(seed))
            card = tree_map(lambda p: p.to(device), params)
            toks = torch.from_numpy(np.random.default_rng(seed).integers(
                1, cfg.vocab, (P11["train_batch"], P11["train_seq"]))
                .astype(np.int32))
            batch = {"tokens": toks.to(device)}
            opt_cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=1,
                                  total_steps=P11["train_steps"])
            step = make_train_step(model, opt_cfg)
            state, step_s, losses = (card, adamw_init(card, opt_cfg)), [], []
            for _ in range(P11["train_steps"]):  # the same batch each step
                t0 = clock()
                *state, loss = step(*state, batch)
                losses.append(float(loss))
                step_s.append(clock() - t0)
            del state
            runs.append(dict(cfg=cfg, params=params, toks=toks, card=card,
                             step_s=step_s, losses=losses))
    with kernel_run(stash["train_families_check"]) as check:
        for run in runs:  # each family's gradient on the card
            with Calls(moe, "route", keep=True) as routes:
                _, got = loss_and_grads(build(run["cfg"]), run.pop("card"),
                                        {"tokens": run["toks"].to(device)})
            run["got"] = tree_map(lambda g: g.detach().float().cpu(), got)
            run["card_routes"] = routes.kept
            del got
            free_card()

    out = {}
    for run in runs:
        cfg, params, toks, got, card_routes, step_s, losses = (
            run[k] for k in ("cfg", "params", "toks", "got", "card_routes",
                             "step_s", "losses"))
        cpu_model = build(dataclasses.replace(cfg, param_dtype="float32"))
        with Calls(moe, "route", keep=True) as cpu_routes:
            _, want = loss_and_grads(cpu_model,
                                     tree_map(lambda p: p.float(), params),
                                     {"tokens": toks})
        errs = leaf_grad_errors(got, want)
        limit = 1e-3 if cfg.family == "moe" else 5e-2
        bad = [(n, e) for n, e, g in zip(leaf_names(params), errs,
                                        tree_leaves(got))
               if e[0] > limit or e[1] <= 0
               or not bool(torch.isfinite(g).all())]
        if bad or not np.all(np.isfinite(losses)):
            raise AssertionError(f"phase 11e {cfg.name}: leaf gradients "
                                 f"off: {bad}, losses {losses}")
        rec = {"layers": cfg.n_layers, "dtype": cfg.param_dtype,
               "step_ms": 1e3 * step_s[-1], "first_step_ms": 1e3 * step_s[0],
               "tok_per_s": toks.numel() / step_s[-1], "losses": losses,
               "max_grad_rel_err": max(e[0] for e in errs), "limit": limit}
        if cfg.family == "moe":  # each layer's forward routing
            pairs = list(zip(card_routes, cpu_routes.kept))[:cfg.n_layers]
            rec["routing_differs"] = sum(
                int((a.eidx.cpu() != b.eidx).sum()
                    + (a.keep.cpu() != b.keep).sum())
                for (_, a), (_, b) in pairs)
        out[cfg.name] = rec
        log(f"phase 11e ({smi}) {describe(cfg)}: batch {P11['train_batch']} "
            f"x {P11['train_seq']}: " + json.dumps(rec))
    for run_l, want in ((launches, want_l),
                        (check, want_l // P11["train_steps"])):
        if run_l["flash_attention"] != want or sum(run_l.values()) != want:
            raise AssertionError(f"phase 11e: launches {run_l}, want "
                                 f"{want} of flash_attention only")
    return out, launches, check


def families(seed, smi, stash, device="cuda"):
    """Phase 11: (a)-(e). Returns (stats, launches by path; a
    ``*_check`` path's are a check's, not the path's)."""
    launches, stats, walls = {}, {}, {}
    t = time.perf_counter()
    launches.update(moe_serving(seed, smi, stash, device))
    walls["a"] = time.perf_counter() - t
    launches["kimi"] = kimi_serving(seed, smi, stash, device)
    walls["b"] = time.perf_counter() - t - sum(walls.values())
    for arch, path, part in ((P11["ssm"], "mamba2", "c"),
                             (P11["hybrid"], "zamba2", "d")):
        stats[path], launches[path], launches[path + "_check"] = \
            state_serving(arch, path, part, seed, smi, stash, device)
        walls[part] = time.perf_counter() - t - sum(walls.values())
    (stats["train"], launches["train_families"],
     launches["train_families_check"]) = family_training(seed, smi, stash,
                                                         device)
    walls["e"] = time.perf_counter() - t - sum(walls.values())
    log(f"phase 11: {time.perf_counter() - t:.3f} s; by part (s): "
        + json.dumps(walls))
    return stats, launches


# ------------------------------------------------------------------ phase 12
# The enc-dec and VLM families on the card: (a) whisper-large-v3 and (b)
# internvl2-26b served at full width and depth (greedy, through
# ``build(cfg).prefill`` / ``.decode``: ``Engine`` serves decoder-only LMs
# only, as in the JAX package), (c) whisper trained through launch/train.py
# at full width and 8 + 8 layers with a crash and a resume, and one train step per
# family at full width and reduced depth. Cut from the published sizes:
# weights seeded random and the frontends stubs (seeded frames and image
# embeddings, normal x 0.02); whisper decodes 128 of a segment's up to 448
# tokens; the float32 checks run 2 encoder + 2 decoder layers (whisper, 2
# requests) and 2 layers (internvl2, 1 request); training runs 3 steps of
# 2 x 256 tokens (a crash after step 2), the reduced-depth steps 2 + 2
# layers (whisper) and 2 layers (internvl2), the gradient check at 1 x 256
# text tokens
P12 = dict(reduced=False, encdec="whisper-large-v3", vlm="internvl2-26b",
           requests=4, prompt=4, new=128, vlm_prompt=512, vlm_new=32,
           vlm_max_len=800, check_layers=2, check_requests=2, check_steps=8,
           vlm_check_requests=1, train_steps=3, train_crash=2, train_batch=2,
           train_seq=256, train_docs=16, grad_layers=2, grad_batch=1,
           grad_seq=256,
           # 12c (i)'s depth, a stack (of 32 + 32; the script's time limit:
           # its checkpoints and their restore took ~45 s at full depth)
           train_layers=8)
TRAIN12_DIR = ROOT / "build" / "phase12"


def p12_config(arch, **kw):
    import dataclasses
    from repro_torch.configs import get_config, get_reduced
    cfg = (get_reduced if P12["reduced"] else get_config)(arch)
    return dataclasses.replace(cfg, **kw) if kw else cfg


def rel_err(got, want):
    """||got - want|| / ||want||, in float32 on the host."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def prefix_inputs(cfg, batch, seq, seed):
    """Seeded host inputs of an enc-dec or VLM request batch: (the frames
    or image embeddings [batch, n, d_model], ``normal * 0.02`` in float32
    (the frontends are stubs), the prompt tokens [batch, seq] int32)."""
    import numpy as np
    import torch
    from repro_torch.models.api import prefix_input
    n = prefix_input(cfg)[1]
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(batch, n, cfg.d_model)) * 0.02).astype(np.float32)
    toks = rng.integers(1, cfg.vocab, (batch, seq)).astype(np.int32)
    return torch.from_numpy(x), torch.from_numpy(toks)


def prefix_batch(cfg, x, toks, device, **kw):
    """The prefill batch of ``x`` (cast to the parameter dtype) and
    ``toks``, on ``device``."""
    from repro_torch.models.api import prefix_input
    return {prefix_input(cfg)[0]: x.to(cfg.dtype).to(device),
            "tokens": toks.to(device), **kw}


def greedy(model, params, batch, new):
    """Greedy decoding through ``model.prefill`` / ``model.decode``: the
    prefill of ``batch``, then ``new - 1`` decode steps, each token the
    argmax of the last logits. Returns (tokens [B, new], prefill seconds,
    each decode step's seconds, every logit finite, #7's launches in the
    prefill)."""
    import torch
    from repro_torch.kernels import LAUNCHES
    cfg = model.cfg
    t0 = clock()
    out = model.prefill(params, batch)
    logits, state = out[0], out[1]
    extra = {"cross": out[2]} if cfg.family == "encdec" else {}
    tok = logits[:, -1].argmax(-1, keepdim=True).int()
    t_pre = clock() - t0
    pre_launches = LAUNCHES["flash_attention"]
    finite = torch.isfinite(logits).all()
    pos = batch["tokens"].shape[1] + (cfg.n_img_tokens
                                      if cfg.family == "vlm" else 0)
    toks, steps = [tok], []
    for i in range(new - 1):
        t1 = clock()
        logits, state = model.decode(params, dict(extra, token=tok,
                                                  cache=state, pos=pos + i))
        tok = logits[:, -1].argmax(-1, keepdim=True).int()
        finite &= torch.isfinite(logits).all()
        steps.append(clock() - t1)
        toks.append(tok)
    return torch.cat(toks, 1), t_pre, steps, bool(finite), pre_launches


def peak_reset():
    """Resets the peak-memory counter; returns the bytes held now (what
    earlier phases hold stays out of the peak)."""
    import torch
    if not torch.cuda.is_available():
        return 0
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_gb(held):
    """(the peak device memory since ``peak_reset`` less ``held``, and
    ``held``), in GB."""
    import torch
    if not torch.cuda.is_available():
        return float("nan"), float("nan")
    return (torch.cuda.max_memory_allocated() - held) / 1e9, held / 1e9


def cut_params(cfg, params, nl):
    """The first ``nl`` layers of every stack of ``params`` (views)."""
    from repro_torch.models.spec import tree_map
    stacks = ("enc_blocks", "dec_blocks") if cfg.family == "encdec" else \
        ("blocks",)
    return dict(params, **{k: tree_map(lambda w: w[:nl], params[k])
                           for k in stacks})


def as_dtype(params, dtype, device=None):
    from repro_torch.models.spec import tree_map
    return tree_map(lambda w: w.detach().to(device=device, dtype=dtype),
                    params)


def prefix_serving(part, arch, path, seed, smi, stash, device="cuda"):
    """12a / 12b: an enc-dec or VLM model at full width and depth, weights
    drawn on the card, serving one batch greedily (sizes in ``P12``):
    every logit finite, #7 launched exactly as the family's layers say, in
    the prefill and in each step. Then at ``check_layers`` layers of every
    stack, on the same weights cast to float32, the card's prefill (logits
    and caches) against the CPU's, a relative error norm <= 1e-3 each;
    for the enc-dec also prefill-then-decode (``check_steps``
    teacher-forced steps after the prompt) against one forward over the
    same tokens and frames, <= 1e-3 at every step; the bf16 weights' error
    logged beside them. The checks' card runs are recorded under
    ``stash[path + "_check"]``: phase 5 holds their inputs to plain,
    neither counting nor timing them. Returns (stats, launches, the
    checks')."""
    import dataclasses
    import torch
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.models import build, encdec, init_params, param_count

    cfg = p12_config(arch)
    model = build(cfg)
    enc = cfg.family == "encdec"
    log(f"phase 12{part}: {describe(cfg)}; "
        f"{param_count(model.param_specs) / 1e9:.3f} B parameters")
    b = P12["requests"]
    s, new = (P12["prompt"], P12["new"]) if enc else \
        (P12["vlm_prompt"], P12["vlm_new"])
    max_len = s + new if enc else P12["vlm_max_len"]
    held = peak_reset()
    t0 = time.perf_counter()
    params = init_params(model.param_specs,
                         torch.Generator(device=device).manual_seed(seed))
    t_init = time.perf_counter() - t0
    x32, prompt = prefix_inputs(cfg, b, s, seed)
    with kernel_run(stash[path]) as launches:
        toks, t_pre, steps, finite, pre_l = greedy(
            model, params, prefix_batch(cfg, x32, prompt, device,
                                        max_len=max_len), new)
    stats = {"prefill_s": t_pre,
             "prefill_tok_per_s": b * (s + (0 if enc else cfg.n_img_tokens))
             / t_pre,
             "decode_step_ms_median": 1e3 * sorted(steps)[len(steps) // 2],
             "tok_per_s": b * new / (t_pre + sum(steps)),
             "decode_tok_per_s": b * len(steps) / sum(steps),
             "init_s": t_init}
    stats["peak_mem_gb"], stats["held_gb"] = peak_gb(held)
    # a forward: the decoder's self and cross attention a layer, and in the
    # prefill the encoder's too; the VLM one a layer
    per_fwd = 2 * cfg.n_layers if enc else cfg.n_layers
    want_pre = per_fwd + (cfg.n_enc_layers if enc else 0)
    want = want_pre + per_fwd * (new - 1)
    if pre_l != want_pre or launches["flash_attention"] != want or \
            sum(launches.values()) != want:
        raise AssertionError(f"phase 12{part}: prefill launches {pre_l}, "
                             f"all {launches}; want {want_pre}, then {want} "
                             f"of flash_attention only")
    if not finite or toks.shape != (b, new):
        raise AssertionError(f"phase 12{part}: finite logits {finite}, "
                             f"tokens {tuple(toks.shape)}")
    stats["flash_attention"] = launches["flash_attention"]
    last = s + (0 if enc else cfg.n_img_tokens) + new - 2  # last step's
    stats["decode_splits"] = attn_ops.decode_splits(
        b, 1, max_len, cfg.n_heads, cfg.n_kv_heads, True, last)
    if enc:
        stats["cross_decode_splits"] = attn_ops.decode_splits(
            b, 1, cfg.n_frames, cfg.n_heads, cfg.n_kv_heads, False, 0)

    nl = P12["check_layers"]
    r = P12["check_requests"] if enc else P12["vlm_check_requests"]
    n_chk = P12["check_steps"] if enc else 0
    chk_len = s + n_chk if enc else max_len
    cut = dataclasses.replace(cfg, n_layers=nl, **(
        {"n_enc_layers": nl} if enc else {}))
    cut32 = dataclasses.replace(cut, param_dtype="float32")
    seq = torch.cat([prompt[:r], toks[:r, :n_chk].cpu()], 1)

    def run(c, prm, dev):
        """On the host: the prefill's logits; for the enc-dec each
        teacher-forced step's logits and one forward's; the caches after
        the steps."""
        m = build(c)
        bt = prefix_batch(c, x32[:r], seq[:, :s], dev, max_len=chk_len)
        out = m.prefill(prm, bt)
        got = {"logits": out[0].float().cpu()}
        if enc:
            steps = [out[0]]
            for i in range(n_chk):  # the cache is updated in place
                logits, _ = m.decode(prm, {
                    "token": seq[:, s + i:s + i + 1].to(dev),
                    "cache": out[1], "cross": out[2], "pos": s + i})
                steps.append(logits)
            got["steps"] = torch.cat(steps, 1).float().cpu()
            with torch.no_grad():
                got["forward"] = encdec.logits(
                    c, prm, bt["frames"], seq.to(dev))[:, s - 1:].float().cpu()
        for name, kv in zip(("cache", "cross"), out[1:]):  # after the steps
            got.update({f"{name}_{side}": t.float().cpu()
                        for side, t in zip("kv", kv)})
        return got

    with kernel_run(stash[path + "_check"]) as check:
        card32 = run(cut32, as_dtype(cut_params(cfg, params, nl),
                                     torch.float32), device)
        card16 = run(cut, cut_params(cfg, params, nl), device)
    host32 = as_dtype(cut_params(cfg, params, nl), torch.float32, "cpu")
    del params
    free_card()
    cpu32 = run(cut32, host32, "cpu")
    del host32
    errs = {k: rel_err(card32[k], cpu32[k]) for k in cpu32
            if k not in ("steps", "forward")}
    drift = {k: rel_err(card16[k], cpu32[k]) for k in errs}
    if enc:
        errs["decode_vs_forward"] = max(
            rel_err(card32["steps"][:, i], card32["forward"][:, i])
            for i in range(n_chk + 1))
        drift["decode_vs_forward"] = [
            rel_err(card16["steps"][:, i], card16["forward"][:, i])
            for i in range(n_chk + 1)]
    if max(errs.values()) > 1e-3 or not all(
            torch.isfinite(t).all() for t in card16.values()):
        raise AssertionError(f"phase 12{part}: the card's float32 at {nl} "
                             f"layers vs the CPU's (relative error norms): "
                             f"{errs}")
    # each check run: the prefill, the steps and, enc-dec, one forward
    want = 2 * (3 * nl + 2 * nl * n_chk + 3 * nl if enc else nl)
    if check["flash_attention"] != want or sum(check.values()) != want:
        raise AssertionError(f"phase 12{part}: the checks' launches "
                             f"{check}, want {want} of flash_attention")
    stats["f32_rel_err"], stats["bf16_rel_err"] = errs, drift
    log(f"phase 12{part} ({smi}): {b} requests of {s} tokens"
        + (f" and {cfg.n_frames} frames" if enc else
           f" after {cfg.n_img_tokens} image embeddings")
        + f", {new} new: " + json.dumps(stats))
    return stats, launches, check


def prefix_training(seed, smi, stash, device="cuda"):
    """12c: (i) whisper-large-v3 at full width and ``train_layers``
    encoder and decoder layers (the launcher's config cut) through
    ``repro_torch.launch.train.main`` (``train_batch`` x ``train_seq``
    tokens and ``n_frames`` frames a step, remat ``dots_no_batch``):
    ``train_steps`` steps uninterrupted, then with a checkpoint every
    ``train_crash`` steps that crashes right after the first, resumed to
    the end: the resumed losses must equal the uninterrupted run's within
    ``RESUME_RTOL`` (the frames of the steps before the checkpoint are
    drawn and dropped on resume, as the tokens are). #7 runs twice a
    layer's attention a step (the remat recompute). (ii) One
    ``make_train_step`` step per family at full width and
    ``grad_layers`` layers of every stack, then every leaf's gradient on
    the card (bf16) against the same weights' on the CPU (float32),
    ``grad_batch`` x ``grad_seq`` tokens: finite, non-zero and within
    5e-2 (relative error norm); the card's gradient run is recorded under
    ``stash["train_prefix_check"]``. Returns (stats, launches of (i), of
    (ii)'s steps, of its check)."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    from repro_torch.models import build, init_params
    from repro_torch.models.spec import tree_leaves
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.train_step import loss_and_grads

    from repro_torch.launch import train as launch_train
    arch = P12["encdec"]
    full = p12_config(arch)
    cut = {"n_layers": min(P12["train_layers"], full.n_layers),
           "n_enc_layers": min(P12["train_layers"], full.n_enc_layers)}
    cfg = dataclasses.replace(full, **cut)
    n_steps, crash = P12["train_steps"], P12["train_crash"]
    argv = ["--arch", arch, "--steps", str(n_steps),
            "--batch", str(P12["train_batch"]), "--seq", str(P12["train_seq"]),
            "--docs", str(P12["train_docs"]), "--ckpt-every", str(crash),
            "--seed", str(seed), "--device", str(device)]
    argv += ["--reduced"] if P12["reduced"] else []
    held = peak_reset()
    t0 = time.perf_counter()
    which = "get_reduced" if P12["reduced"] else "get_config"
    get = getattr(launch_train, which)  # the launcher's config, cut
    setattr(launch_train, which,
            lambda a: dataclasses.replace(get(a), **cut))
    try:
        whole, resumed, step_s, saved, launches, walls = crash_resume(
            argv, TRAIN12_DIR, stash["train_whisper"])
    finally:
        setattr(launch_train, which, get)
    t_i = time.perf_counter() - t0
    if len(whole) != n_steps or not np.all(np.isfinite(whole)):
        raise AssertionError(f"phase 12c: losses {whole}")
    if saved.get("step") != crash or len(resumed) != n_steps - crash:
        raise AssertionError(f"phase 12c: crashed at {saved.get('step')}, "
                             f"resumed {len(resumed)} steps")
    resume_err = max(abs(a - b) / abs(b) for a, b in zip(resumed,
                                                         whole[crash:]))
    if resume_err > RESUME_RTOL:
        raise AssertionError(f"phase 12c: resumed losses {resumed} vs "
                             f"{whole[crash:]} (rel {resume_err:.3g})")
    shutil.rmtree(TRAIN12_DIR, ignore_errors=True)
    per_step = 2 * (cfg.n_enc_layers + 2 * cfg.n_layers)
    want = per_step * (n_steps + crash + n_steps - crash)
    if launches["flash_attention"] != want or \
            sum(launches.values()) != want:
        raise AssertionError(f"phase 12c: launches {launches}, want {want} "
                             f"of flash_attention only")
    steady = sorted(step_s["whole"][1:])
    med = steady[len(steady) // 2]
    tokens = P12["train_batch"] * P12["train_seq"]
    stats = {"losses": whole, "resumed": resumed, "resume_rel_err": resume_err,
             "first_step_s": step_s["whole"][0], "median_step_s": med,
             "step_s": step_s, "tok_per_s": tokens / med,
             "frames_per_s": P12["train_batch"] * cfg.n_frames / med,
             "wall_s": t_i, "walls_s": walls,
             "flash_attention": launches["flash_attention"]}
    stats["peak_mem_gb"], stats["held_gb"] = peak_gb(held)
    log(f"phase 12c (i) ({smi}) {describe(cfg)}: {n_steps} steps of "
        f"{P12['train_batch']} x {P12['train_seq']} tokens and "
        f"{cfg.n_frames} frames, a crash after step {crash}, resumed: "
        + json.dumps(stats))
    free_card()

    runs, want_l, nl = [], 0, P12["grad_layers"]
    with kernel_run(stash["train_prefix"]) as step_launches:
        for arch in (P12["encdec"], P12["vlm"]):
            cfg = p12_config(arch)
            if not P12["reduced"]:
                cfg = dataclasses.replace(
                    cfg, n_layers=nl, n_enc_layers=min(nl, cfg.n_enc_layers))
            model = build(cfg)
            fwd = (cfg.n_enc_layers + 2 * cfg.n_layers
                   if cfg.family == "encdec" else cfg.n_layers)
            want_l += 2 * fwd
            card = init_params(model.param_specs, torch.Generator(
                device=device).manual_seed(seed))
            x32, toks = prefix_inputs(cfg, P12["grad_batch"],
                                      P12["grad_seq"], seed)
            batch = prefix_batch(cfg, x32, toks, device)
            opt_cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=1,
                                  total_steps=1)
            held = peak_reset()
            t0 = clock()
            new_params, _, loss = make_train_step(model, opt_cfg)(
                card, adamw_init(card, opt_cfg), batch)
            loss = float(loss)
            step_ms = 1e3 * (clock() - t0)
            del new_params
            runs.append(dict(cfg=cfg, x32=x32, toks=toks, card=card,
                             loss=loss, step_ms=step_ms,
                             peak_mem_gb=peak_gb(held)))
    with kernel_run(stash["train_prefix_check"]) as check:
        for run in runs:  # each family's gradient on the card
            card = run.pop("card")
            _, got = loss_and_grads(build(run["cfg"]), card, prefix_batch(
                run["cfg"], run["x32"], run["toks"], device))
            run["got"] = as_dtype(got, torch.float32, "cpu")
            run["params"] = as_dtype(card, torch.float32, "cpu")
            del got, card
            free_card()
    out = {"i": stats}
    for run in runs:
        cfg, params, got = run["cfg"], run["params"], run["got"]
        cfg32 = dataclasses.replace(cfg, param_dtype="float32")
        _, want = loss_and_grads(build(cfg32), params, prefix_batch(
            cfg32, run["x32"], run["toks"], "cpu"), remat="none")
        errs = leaf_grad_errors(got, want)
        bad = [(n, e) for n, e, g in zip(leaf_names(params), errs,
                                        tree_leaves(got))
               if e[0] > 5e-2 or e[1] <= 0
               or not bool(torch.isfinite(g).all())]
        if bad or not np.isfinite(run["loss"]):
            raise AssertionError(f"phase 12c {cfg.name}: leaf gradients "
                                 f"off: {bad}, loss {run['loss']}")
        rec = {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
               "step_ms": run["step_ms"], "loss": run["loss"],
               "peak_mem_gb": run["peak_mem_gb"][0],
               "held_gb": run["peak_mem_gb"][1],
               "max_grad_rel_err": max(e[0] for e in errs), "limit": 5e-2}
        out[cfg.name] = rec
        log(f"phase 12c (ii) ({smi}) {describe(cfg)}: batch "
            f"{P12['grad_batch']} x {P12['grad_seq']}: " + json.dumps(rec))
        del want, run["got"], run["params"]
    for run_l, n in ((step_launches, want_l), (check, want_l)):
        if run_l["flash_attention"] != n or sum(run_l.values()) != n:
            raise AssertionError(f"phase 12c (ii): launches {run_l}, want "
                                 f"{n} of flash_attention only")
    return out, launches, step_launches, check


def prefix_families(seed, smi, stash, device="cuda"):
    """Phase 12: (a)-(c). Returns (stats, launches by path; a ``*_check``
    path's are a check's, not the path's)."""
    launches, stats, walls = {}, {}, {}
    t = time.perf_counter()
    for part, arch, path in (("a", P12["encdec"], "whisper"),
                             ("b", P12["vlm"], "internvl2")):
        stats[path], launches[path], launches[path + "_check"] = \
            prefix_serving(part, arch, path, seed, smi, stash, device)
        walls[part] = time.perf_counter() - t - sum(walls.values())
    (stats["train"], launches["train_whisper"], launches["train_prefix"],
     launches["train_prefix_check"]) = prefix_training(seed, smi, stash,
                                                       device)
    walls["c"] = time.perf_counter() - t - sum(walls.values())
    log(f"phase 12: {time.perf_counter() - t:.3f} s; by part (s): "
        + json.dumps(walls))
    return stats, launches


# ------------------------------------------------------------------ phase 8
# 8a's stream: Graph500 scale 16's edge count (16 batches of 65,536) of
# Zipf(1.1) rows over 2^16 ids, columns uniform over 4,096 (a hot row holds
# at most 4,096 entries), values normal; a rebalance round after every
# second batch. 8b's corpus: 4,096 documents of 512 tokens over smollm-135m's
# 49,152-token vocabulary
P8 = dict(ids=1 << 16, cols=4096, batch=1 << 16, batches=16, zipf=1.1,
          capacity=1 << 20, memtable=1 << 16, rebalance_every=2,
          point_ids=1024, hot_ids=1024, col_ids=64, fresh=1 << 16,
          docs=4096, doc_len=512, vocab=49152, draws=16, draw_batch=8)
TABLETS_DIR = ROOT / "build" / "phase8"


def tablet_stream(seed):
    """8a's (rows, cols, vals), from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = P8["batch"] * P8["batches"]
    rows = (rng.zipf(P8["zipf"], n) % P8["ids"]).astype(np.int32)
    cols = rng.integers(0, P8["cols"], n).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)
    return rows, cols, vals


def tablet_store(name, dynamic, device="cuda", use_pallas=True, **kw):
    """A transpose pair on 4 shards, combiner ``last``, with the hand
    kernels (or their plain versions); ``dynamic`` runs the row table on
    dynamic tablets."""
    from repro_torch.db import ShardedTable
    return ShardedTable(
        name, num_shards=4, capacity_per_shard=P8["capacity"],
        batch_cap=P8["batch"], id_capacity=P8["ids"],
        memtable_cap=P8["memtable"], combiner="last", engine="lsm",
        use_pallas=use_pallas, transpose=True, dynamic_tablets=dynamic,
        device=device, **kw)


def last_wins(r, c, v):
    """Host last-wins combine of a triple stream, sorted by (row, col)."""
    import numpy as np
    key = (r.astype(np.int64) << 32) | c.astype(np.int64)
    _, first = np.unique(key[::-1], return_index=True)
    keep = len(key) - 1 - first
    return r[keep], c[keep], v[keep]


class MigrationClock:
    """Times each migration of a store (flush, host scan of the source
    shard, clear, re-insert, flush) on the synchronised host clock."""

    def __init__(self, store):
        self.fn = store._migrate_shard
        self.log = []  # [source shard, seconds]
        store._migrate_shard = self

    def __call__(self, src):
        t0 = clock()
        self.fn(src)
        self.log.append([int(src), clock() - t0])


def tablet_queries(seed):
    """8a's reads, drawn from ``seed``: the full scan of both tables, a
    point read of ids >= 1,024 (rows of fewer than 256 entries), the hot
    row range and the whole id space, and a column read through the
    sibling. Returns {read: fn(store) -> (rows, cols, vals)}."""
    import numpy as np
    rng = np.random.default_rng(seed + 8)
    q = np.sort(rng.choice(np.arange(P8["hot_ids"], P8["ids"]),
                           P8["point_ids"], replace=False)).astype(np.int32)
    cq = np.sort(rng.choice(P8["cols"], P8["col_ids"],
                            replace=False)).astype(np.int32)
    return {
        "scan": lambda s: s.scan(),
        "sibling_scan": lambda s: s.t_store.scan(),
        "point_read": lambda s: s.query_rows(q, max_return=256),
        "hot_range": lambda s: s.scan_range(0, P8["hot_ids"]),
        "full_range": lambda s: s.scan_range(0, P8["ids"]),
        "col_read": lambda s: s.query_cols(cq, max_return=256),
    }


def tablet_reads(store, want, seed, what):
    """``tablet_queries(seed)`` of ``store``, each equal to ``want`` (the
    never-split twin's; the ranges in order) and the sibling the exact
    transpose. Returns {read: (seconds, launches)}."""
    import numpy as np
    from repro_torch.kernels import LAUNCHES
    out = {}
    for name, read in tablet_queries(seed).items():
        before = dict(LAUNCHES)
        got, t = timed_call(lambda: read(store))
        out[name] = (t, {k: v - before[k] for k, v in LAUNCHES.items()
                         if v - before[k]})
        same_arrays(got, want[name], f"{what} {name} vs the twin",
                    ordered=name.endswith("range"))
        if name == "scan":
            r, c, v = got
            same_arrays(store.t_store.scan(), (c, r, v),
                        f"{what}: the sibling is not the transpose")
        if name == "point_read":
            top = int(np.bincount(got[0]).max()) if len(got[0]) else 0
            if top >= 256:
                raise AssertionError(f"{what}: a point-read row holds {top}")
    return out


def dynamic_tablets(seed, smi, stash, device="cuda"):
    """Phase 8a: the Zipf stream into a dynamic-tablet pair with rebalance
    rounds; every read equals its never-split twin's and the card's
    balance on a fresh window is <= 2.0 and below the static one. The
    twin runs the plain versions of the kernels and is fed and read before
    the pair, outside the counted block. Returns (launches, the twin's
    reads)."""
    import numpy as np
    from repro_torch.db.kvstore import shard_of

    rows, cols, vals = tablet_stream(seed)
    twin = tablet_store("p8_twin", False, device, use_pallas=False)
    dyn = tablet_store("p8_dyn", True, device)
    for st in (twin, dyn):
        st.warmup()
        if st.device.type != device:
            raise AssertionError(f"phase 8a: a store on {st.device}")
    B = P8["batch"]
    put = {"dynamic_s": 0.0, "rebalance_s": 0.0, "twin_s": 0.0}
    for i in range(P8["batches"]):
        sl = slice(i * B, (i + 1) * B)
        put["twin_s"] += timed_call(
            lambda: twin.insert(rows[sl], cols[sl], vals[sl]))[1]
    want = {name: read(twin) for name, read in tablet_queries(seed).items()}
    twin.close()
    mig = MigrationClock(dyn)
    rounds = []
    with kernel_run(stash) as launches:
        for i in range(P8["batches"]):
            sl = slice(i * B, (i + 1) * B)
            put["dynamic_s"] += timed_call(
                lambda: dyn.insert(rows[sl], cols[sl], vals[sl]))[1]
            if (i + 1) % P8["rebalance_every"] == 0:
                n0 = len(mig.log)
                got, t = timed_call(dyn.maybe_rebalance)
                put["rebalance_s"] += t
                rounds.append(dict(got, after_batch=i + 1, seconds=t,
                                   tablets=dyn.tablet_map.n,
                                   migrations=mig.log[n0:]))
        reads = tablet_reads(dyn, want, seed, "phase 8a")
    tm = dyn.tablet_map
    splits, moves, merges = (int(c.value) for c in (
        dyn._c_tablet_splits, dyn._c_tablet_moves, dyn._c_tablet_merges))
    if tm.n <= 4 or splits <= 0 or moves <= 0:
        raise AssertionError(f"phase 8a: tablets {tm.n}, splits {splits}, "
                             f"moves {moves}")
    if not ((tm.splits > 0) & (tm.splits < P8["hot_ids"])).any():
        raise AssertionError(f"phase 8a: no split inside the hot range: "
                             f"{tm.splits.tolist()}")
    fresh = (np.random.default_rng(seed + 9).zipf(P8["zipf"], P8["fresh"])
             % P8["ids"]).astype(np.int64)
    per = np.bincount(tm.owner_of(fresh), minlength=4)
    static = np.bincount(shard_of(fresh, 4, P8["ids"]), minlength=4)
    balance = float(per.max() / per.mean())
    static_balance = float(static.max() / static.mean())
    if not (balance <= 2.0 and balance < static_balance):
        raise AssertionError(f"phase 8a: balance {balance} (static "
                             f"{static_balance}): {tm.to_manifest()}")
    for k in ("merge_path_rank", "rank_batched", "row_merge"):
        if launches[k] <= 0:
            raise AssertionError(f"phase 8a: kernel {k} never launched")
    log(f"phase 8a ({smi}): {len(rows)} triples in {P8['batches']} batches "
        f"of {B}, {len(rounds)} rebalance rounds: {splits} splits, {moves} "
        f"moves, {merges} merges, {tm.n} tablets; put {put['dynamic_s']:.6f}"
        f" s + rebalancing {put['rebalance_s']:.6f} s (the twin's put on "
        f"the plain path {put['twin_s']:.6f} s); migrations {len(mig.log)}, "
        f"{sum(t for _, t in mig.log):.6f} s")
    log(f"phase 8a ({smi}): balance on a fresh window of {P8['fresh']} Zipf "
        f"ids {balance:.6f} (per shard {per.tolist()}), static "
        f"{static_balance:.6f} (per shard {static.tolist()}); recorded-load "
        f"balance {tm.shard_balance():.6f}")
    log("phase 8a rounds: " + json.dumps(rounds))
    log(f"phase 8a ({smi}) reads, equal to the twin's (seconds, launches): "
        + json.dumps(reads))
    log("phase 8a map: " + json.dumps(tm.to_manifest()))
    dyn.close()
    return launches, want


def tablet_child(wal_dir, seed):
    """Phase 8a's writer, a process of its own: the dynamic-tablet pair
    with a WAL puts the first half of the stream, checkpoints, puts the
    rest with a rebalance round after every second batch, merges one
    adjacent same-owner pair if one exists, prints its map and timings as
    one JSON line and dies with ``os._exit(1)``."""
    import os
    rows, cols, vals = tablet_stream(seed)
    st = tablet_store("p8_wal", True, wal_dir=str(wal_dir))
    st.warmup()
    B, half = P8["batch"], P8["batches"] // 2
    t = {"put_s": 0.0, "rebalance_s": 0.0}
    for i in range(P8["batches"]):
        if i == half:
            t["checkpoint_s"] = timed_call(st.checkpoint)[1]
        sl = slice(i * B, (i + 1) * B)
        t["put_s"] += timed_call(
            lambda: st.insert(rows[sl], cols[sl], vals[sl]))[1]
        if i >= half and (i + 1) % P8["rebalance_every"] == 0:
            t["rebalance_s"] += timed_call(st.maybe_rebalance)[1]
    tm = st.tablet_map
    merged = None
    for i in range(tm.n - 1):
        if tm.owners[i] == tm.owners[i + 1]:
            merged = int(tm.tablet_ids[i])
            st.merge_tablet(merged)
            break
    print(json.dumps(dict(t, map=tm.to_manifest(), merged=merged,
                          first_half=half * B)), flush=True)
    os._exit(1)


def frame_oracle(wal, man, base, tablets=None):
    """Host replay of a format-3 directory: the snapshot's map and
    triples (``base``, last-wins), then the log's frames from the
    manifest's offset — meta frames onto the map, data frames (of
    ``tablets`` only, when given) onto the triples. No engine."""
    import numpy as np
    from repro_torch.db.lsm import WriteAheadLog
    from repro_torch.db.tablets import TabletMap
    tm = TabletMap.from_manifest(man["tablets"])
    parts = [base]
    for item in WriteAheadLog.replay_full(wal, start=man["wal_offset"]):
        if item[0] == "meta":
            op = item[1]
            if op["op"] == "split":
                tm.split(op["tablet"], op["key"], new_id=op["new"])
            elif op["op"] == "move":
                tm.move(op["tablet"], op["to"])
            else:
                tm.merge(op["tablet"])
            continue
        _, tid, r, c, v, pair = item
        if not pair or tid is None:
            raise AssertionError("phase 8a: an untagged or unpaired frame")
        if tablets is None or tid in tablets:
            parts.append((r, c, v))
    return tm, last_wins(*(np.concatenate([p[i] for p in parts])
                           for i in range(3)))


def tablet_recovery(seed, smi, stash, want, device="cuda"):
    """Phase 8a's recovery: the writer runs in a child process and
    crashes; the parent recovers on the card (the map equals the writer's,
    the reads ``want``, the never-split twin's), then recovers copies with
    ``tablet_filter`` for the hottest tablet of the log's suffix and one
    minted after the checkpoint, each held against ``frame_oracle``. Returns the launches
    of the recoveries and their reads."""
    import shutil
    from repro_torch.db.lsm import WriteAheadLog, recover

    shutil.rmtree(TABLETS_DIR, ignore_errors=True)
    TABLETS_DIR.mkdir(parents=True)
    wal_dir = TABLETS_DIR / "p8_wal"
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--tablet-child",
         str(wal_dir), "--seed", str(seed)],
        capture_output=True, text=True, timeout=900)
    t_child = time.perf_counter() - t0
    lines = [x for x in child.stdout.splitlines() if x.startswith("{")]
    if child.returncode != 1 or not lines:
        raise AssertionError(
            f"phase 8a: the writer exited {child.returncode}: "
            f"{child.stdout[-2000:]} {child.stderr[-4000:]}")
    wrote = json.loads(lines[-1])
    man = json.loads((wal_dir / "MANIFEST.json").read_text())
    wal = str(wal_dir / "wal.log")
    per_tablet, metas = {}, []
    for item in WriteAheadLog.replay_full(wal, start=man["wal_offset"]):
        if item[0] == "meta":
            metas.append(item[1]["op"])
        else:
            per_tablet[item[1]] = per_tablet.get(item[1], 0) + len(item[2])
    if man["format"] != 3 or "split" not in metas or "move" not in metas:
        raise AssertionError(f"phase 8a: manifest format {man['format']}, "
                             f"meta frames {metas}")
    hot = max(per_tablet, key=per_tablet.get)
    minted = [t for t in per_tablet if t >= 4 and t != hot]
    if not minted:
        raise AssertionError(f"phase 8a: no tablet minted after the "
                             f"checkpoint wrote data: {per_tablet}")
    minted = max(minted, key=per_tablet.get)
    copies = {}
    for tid in (hot, minted):
        copies[tid] = TABLETS_DIR / f"filter_{tid}"
        shutil.copytree(wal_dir, copies[tid])
    log(f"phase 8a ({smi}): the writer crashed after {t_child:.3f} s (put "
        f"{wrote['put_s']:.6f} s, rebalancing {wrote['rebalance_s']:.6f} s, "
        f"checkpoint {wrote['checkpoint_s']:.6f} s, merged tablet "
        f"{wrote['merged']}); WAL {(wal_dir / 'wal.log').stat().st_size / 1e6:.6f}"
        f" MB, snapshot {(wal_dir / 'snapshot.npz').stat().st_size / 1e6:.6f} "
        f"MB; meta frames after the checkpoint {metas}")

    rows, cols, vals = tablet_stream(seed)
    h = wrote["first_half"]
    base = last_wins(rows[:h], cols[:h], vals[:h])
    out = {}
    with kernel_run(stash) as launches:
        store, t = timed_call(lambda: recover(str(wal_dir), device=device))
        if store.device.type != device or not store.use_pallas:
            raise AssertionError(f"phase 8a: recovered on {store.device}, "
                                 f"use_pallas={store.use_pallas}")
        if store.tablet_map.to_manifest() != wrote["map"]:
            raise AssertionError("phase 8a: the recovered map differs from "
                                 "the writer's")
        out["recover_s"] = t
        out["reads"] = tablet_reads(store, want, seed, "phase 8a recovered")
        store.close()
        for tid, d in copies.items():
            st, t = timed_call(lambda: recover(str(d), tablet_filter=[tid],
                                               device=device))
            tm, kept = frame_oracle(wal, man, base, {tid})
            if st.tablet_map.to_manifest() != tm.to_manifest() or \
                    tm.to_manifest() != wrote["map"]:
                raise AssertionError(f"phase 8a: tablet {tid}'s recovered "
                                     f"map differs")
            r, c, v = st.scan()
            same_arrays((r, c, v), kept, f"phase 8a tablet_filter=[{tid}]")
            same_arrays(st.t_store.scan(), (kept[1], kept[0], kept[2]),
                        f"phase 8a tablet_filter=[{tid}] sibling")
            out[f"filter_{tid}"] = {"recover_s": t,
                                    "suffix_entries": per_tablet[tid],
                                    "nnz": len(r)}
            st.close()
    _, oracle = frame_oracle(wal, man, base)
    same_arrays(want["scan"], oracle,
                "phase 8a: the twin vs the host oracle")
    for k in ("merge_path_rank", "rank_batched", "row_merge"):
        if launches[k] <= 0:
            raise AssertionError(f"phase 8a: kernel {k} never launched in "
                                 f"the recoveries")
    log(f"phase 8a ({smi}) recovery: " + json.dumps(out))
    shutil.rmtree(TABLETS_DIR, ignore_errors=True)
    return launches


def host_batch(docs, batch, seq_len, rng):
    """``TokenStore.sample_batch``'s draw over the host corpus."""
    import numpy as np
    out = np.zeros((batch, seq_len), np.int32)
    for i, d in enumerate(rng.integers(0, len(docs), batch)):
        toks = docs[int(d)]
        if len(toks) >= seq_len:
            s = rng.integers(0, len(toks) - seq_len + 1)
            out[i] = toks[s:s + seq_len]
        else:
            out[i] = np.tile(toks, -(-seq_len // len(toks)))[:seq_len]
    return out


def token_pipeline(seed, smi, stash, device="cuda"):
    """Phase 8b: ``TokenStore`` on the card ingests the synthetic corpus;
    seeded ``sample_batch`` draws equal the same draws over the host
    corpus, exactly. Returns the launches."""
    import numpy as np
    from repro_torch.data import TokenStore, synthetic_corpus

    docs, t_corpus = timed_call(lambda: synthetic_corpus(
        P8["docs"], P8["doc_len"], P8["vocab"], seed=seed))
    ts = TokenStore(num_shards=4, capacity_per_shard=P8["capacity"],
                    max_docs=P8["docs"], use_pallas=True, device=device)
    if ts.store.device.type != device:
        raise AssertionError(f"phase 8b: the store is on {ts.store.device}")
    ts.store.warmup()
    n_tok = P8["docs"] * P8["doc_len"]
    with kernel_run(stash) as launches:
        _, t_ingest = timed_call(lambda: ts.ingest(docs))
        t_draw = 0.0
        for k in range(P8["draws"]):
            got, t = timed_call(lambda: ts.sample_batch(
                P8["draw_batch"], P8["doc_len"],
                np.random.default_rng(seed + 100 + k)))
            t_draw += t
            want = host_batch(docs, P8["draw_batch"], P8["doc_len"],
                              np.random.default_rng(seed + 100 + k))
            if not np.array_equal(got, want):
                raise AssertionError(f"phase 8b: batch {k} differs from "
                                     f"the host corpus")
    for k in ("rank_batched", "row_merge"):  # the fused document reads
        if launches[k] <= 0:
            raise AssertionError(f"phase 8b: kernel {k} never launched")
    drawn = P8["draws"] * P8["draw_batch"] * P8["doc_len"]
    log(f"phase 8b ({smi}): corpus of {P8['docs']} x {P8['doc_len']} tokens "
        f"(vocabulary {P8['vocab']}) built in {t_corpus:.3f} s on the host; "
        f"ingest {t_ingest:.6f} s ({n_tok / t_ingest:.1f} tokens/s), "
        f"{P8['draws']} batches of {P8['draw_batch']} x {P8['doc_len']} "
        f"{t_draw:.6f} s ({drawn / t_draw:.1f} tokens/s), every batch equal "
        f"to the host corpus'; launches " + json.dumps(
            {k: v for k, v in launches.items() if v}))
    ts.store.close()
    return launches


# ------------------------------------------------------------------ phase 9
# The mesh path: phase 3's graph in id space (ids 2^16, capacity_per_shard
# phase 3's), ingested by 4 SPMD ranks (this script with --rank-child),
# each its contiguous quarter of the entries in 8 batches of 2^15; L0
# stacks of 4 runs of 4 x 2^15; point reads in query tiles of 512, scans
# in windows of 4,096 widened while a run's slice overflows; the tablet
# step's map splits and moves after 4 steps. Part (d) is a single NCCL rank
# in this process: 4 batches of rank 0's quarter, a compaction into a level
# of 2^18 and a point read of up to 256 of their rows
P9 = dict(ranks=4, id_capacity=1 << 16, bcap=1 << 15, steps=8, slots=4,
          q_tile=512, width=4096, max_tablets=16, nccl_steps=4,
          nccl_level=1 << 18, nccl_queries=256)
MESH_DIR = ROOT / "build" / "phase9"


def mesh_inputs(graph, cap):
    """Phase 9's inputs: A's triples in id space (a vertex's id is its
    position in the sorted vertex list, as phase 3 interns them), the
    Listing-1 reads owner-routed per rank (point ids ``[S, Qb]``, pad -1;
    ranges ``[S, 2]`` cut to each rank's id range), the host answers phase
    3 holds its reads to (``A[sel]``: A's triples filtered in id space),
    the level runs phase 3's store holds shard by shard (the triples routed
    by owner, lexsorted, in both orientations), and the tablet step's
    split: the tablet the first 4 steps load most, at the median of its
    rows, its right half moved to the least-loaded other rank. Returns
    (arrays, config, answers, levels)."""
    import numpy as np
    from repro_torch.db.kvstore import shard_of
    from repro_torch.db.tablets import TabletMap
    S, B, idcap = P9["ranks"], P9["bcap"], P9["id_capacity"]
    verts, sels = graph["verts"], graph["sels"]

    def ids(names):
        return np.searchsorted(verts, np.asarray(names, dtype=verts.dtype)
                               ).astype(np.int32)

    def routed(q):
        own = shard_of(q, S, idcap)
        out = np.full((S, np.bincount(own, minlength=S).max()), -1, np.int32)
        for s in range(S):
            out[s, :(own == s).sum()] = q[own == s]
        return out

    def span(text):  # "a,:,b," -> [a, b + 1)
        first, _, last = text.split(",")[:3]
        return int(ids([first])[0]), int(ids([last])[0]) + 1

    def cut(lo, hi):  # [lo, hi) cut to each rank's id range
        out = np.zeros((S, 2), np.int32)
        for s in range(S):
            a, z = max(lo, s * idcap // S), min(hi, (s + 1) * idcap // S)
            out[s] = (a, z) if a < z else (a, a)
        return out

    rid, cid = (x.astype(np.int32) for x in graph["ids"][:2])
    val = np.asarray(graph["ids"][2], np.float32)
    row_q = ids(sels["row_ids"][0].split(",")[:-1])
    col_q = ids(sels["col_ids"][1].split(",")[:-1])
    n = len(rid)
    starts = [s * n // S for s in range(S + 1)]
    if starts[1] > P9["steps"] * B:
        raise ValueError(f"phase 9: a rank's {starts[1]} entries exceed "
                         f"{P9['steps']} batches of {B}")
    half = P9["steps"] // 2 * B
    first = np.concatenate([rid[starts[s]:min(starts[s] + half,
                                              starts[s + 1])]
                            for s in range(S)])
    tm = TabletMap.uniform(S, idcap)
    hot = int(np.bincount(tm.tablet_of(first), minlength=tm.n).argmax())
    lo, hi = (int(x[hot]) for x in tm.ranges())
    key = int(np.clip(np.median(first[(first >= lo) & (first < hi)]),
                      lo + 1, hi - 1))
    loads = np.bincount(tm.owner_of(first), minlength=S).astype(float)
    loads[tm.owners[hot]] = np.inf
    rlo, rhi = span(sels["row_range"][0])
    clo, chi = span(sels["col_range"][1])
    arrays = dict(rid=rid, cid=cid, val=val, row_q=routed(row_q),
                  col_q=routed(col_q), row_bounds=cut(rlo, rhi),
                  col_bounds=cut(clo, chi))
    want = {"row_ids": np.isin(rid, row_q), "col_ids": np.isin(cid, col_q),
            "row_range": (rid >= rlo) & (rid < rhi),
            "col_range": (cid >= clo) & (cid < chi)}
    cfg = dict(P9, capacity=cap, entries=n, starts=starts,
               row_max_return=int(np.bincount(rid)[row_q].max()),
               col_max_return=int(np.bincount(cid)[col_q].max()),
               split=dict(tablet=int(tm.tablet_ids[hot]), key=key,
                          move_to=int(loads.argmin())))
    levels = {}
    for name, r, c in (("Tedge", rid, cid), ("TedgeT", cid, rid)):
        o = np.lexsort((c, r))
        r, c, v = r[o], c[o], val[o]
        own = shard_of(r, S, idcap)
        levels[name] = [(r[own == s], c[own == s], v[own == s])
                        for s in range(S)]
    answers = {k: (rid[m], cid[m], val[m]) for k, m in want.items()}
    return arrays, cfg, answers, levels


def mesh_batch(arrays, lo, hi, width, dev):
    """Entries [lo, hi) of the id-space triples as one rank's batch of
    ``width`` (pads I32_MAX / 0) on ``dev``."""
    import numpy as np
    import torch
    from repro_torch.kernels.common import I32_MAX
    out = []
    for k, fill, dt in (("rid", I32_MAX, np.int32), ("cid", I32_MAX, np.int32),
                        ("val", 0, np.float32)):
        x = np.full(width, fill, dt)
        part = arrays[k][lo:hi]
        x[:len(part)] = part
        out.append(torch.as_tensor(x, device=dev))
    return out


def mesh_kept(out, *cols):
    """The kept entries of a read step's output as host arrays: ``cols``
    index its outputs (or are tensors of the output's shape)."""
    keep = out[-1] if len(out) == 3 else out[3]
    return tuple((out[c] if isinstance(c, int) else c)[keep].cpu().numpy()
                 for c in cols)


def mesh_rank(cfg, rank, dev, out_dir):
    """One rank of phase 9 (parts a-c) on the inputs in ``out_dir``;
    returns (result, {file name: arrays to save}): the arrays to keep and
    rank 0's merge-path inputs."""
    import numpy as np
    arrays = dict(np.load(out_dir / "inputs.npz"))
    from repro_torch.db import spmd
    from repro_torch.db.tablets import TabletMap
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.common import I32_MAX
    from repro_torch.obs import default_registry
    S, B, steps, slots = cfg["ranks"], cfg["bcap"], cfg["steps"], cfg["slots"]
    idcap, cap = cfg["id_capacity"], cfg["capacity"]
    q0, q1 = cfg["starts"][rank], cfg["starts"][rank + 1]

    def batch(i):
        return mesh_batch(arrays, q0 + min(i * B, q1 - q0),
                          q0 + min((i + 1) * B, q1 - q0), B, dev)

    mesh = spmd.make_mesh("data")
    route = spmd.exchange_route(mesh.get_group("data"), dev)
    times, keep = {}, {}

    def timed(label, fn):
        out, ms = timed_once(fn)
        times.setdefault(label, []).append(ms)
        return out

    def store(key, trip):
        for name, x in zip("rcv", trip):
            keep[f"{key}/{name}"] = x

    queries = {side: spmd.make_spmd_lsm_query_step(
        mesh, "data", "last", max_return=cfg[f"{side}_max_return"],
        q_tile=cfg["q_tile"]) for side in ("row", "col")}

    def reads(tag, l0, lv, l0t, lvt):
        q = torch_int(arrays["row_q"][rank], dev)
        out = timed("query_rows", lambda: queries["row"](l0, lv, q))
        store(f"{tag}/row_ids", mesh_kept(out, q[:, None].expand_as(out[0]),
                                          0, 1))
        # column ids through the sibling, whose rows are A's columns
        q = torch_int(arrays["col_q"][rank], dev)
        out = timed("query_cols", lambda: queries["col"](l0t, lvt, q))
        store(f"{tag}/col_ids", mesh_kept(out, 0, q[:, None].expand_as(
            out[0]), 1))
        for name, stacks, swap in (("row_range", (l0, lv), False),
                                   ("col_range", (l0t, lvt), True)):
            b = torch_int(arrays[name.split("_")[0] + "_bounds"][rank], dev)
            width = cfg["width"]
            while True:  # batch-scanner semantics: widen and scan again
                scan = spmd.make_spmd_lsm_scan_step(
                    mesh, "data", "last", width=width, transpose_output=swap)
                out = timed("scan_" + name.split("_")[0],
                            lambda: scan(*stacks, b))
                if int(out[4]) <= width:
                    break
                width = 1 << (int(out[4]) - 1).bit_length()
            times.setdefault("scan_width", []).append(width)
            store(f"{tag}/{name}", mesh_kept(out, 0, 1, 2))

    stash, launches = {}, {}
    with kernel_run(stash) as counted:
        # (a) the pair step, compactions at a full stack, reads around the
        # last compaction
        pair = spmd.make_spmd_lsm_pair_ingest_step(mesh, "data", S, idcap,
                                                   "last")
        compact = spmd.make_spmd_lsm_compact_step(mesh, "data", "last")
        l0, l0t = (spmd.l0_stacked_empty(slots, S * B, dev) for _ in "ab")
        lv, lvt = (spmd.stacked_empty(cap, dev) for _ in "ab")
        for i in range(steps):
            l0, l0t = timed("pair_step", lambda: pair(l0, l0t, *batch(i)))
            if int(l0.k) == slots or int(l0t.k) == slots:
                if i == steps - 1:
                    reads("before", l0, lv, l0t, lvt)
                l0, lv = timed("compact", lambda: compact(l0, lv))
                l0t, lvt = timed("compact", lambda: compact(l0t, lvt))
                if max(int(lv.n), int(lvt.n)) > cap:
                    raise OverflowError(f"phase 9 rank {rank}: level "
                                        f"{int(lv.n)}, {int(lvt.n)} > {cap}")
        reads("after", l0, lv, l0t, lvt)
        for key, level in (("level", lv), ("level_t", lvt)):
            n = int(level.n)
            store(key, (level.rows[:n].cpu().numpy(),
                        level.cols[:n].cpu().numpy(),
                        level.vals[:n].cpu().numpy()))
        launches["a"] = LAUNCHES["merge_path_rank"]
        # (b) the legacy step into a tablet of phase 3's capacity
        ingest = spmd.make_spmd_ingest_step(mesh, "data", S, idcap, "last")
        tab = spmd.stacked_empty(cap, dev)
        for i in range(steps):
            tab = timed("legacy_step", lambda: ingest(tab, *batch(i)))
            if int(tab.n) > cap:
                raise OverflowError(f"phase 9 rank {rank}: tablet "
                                    f"{int(tab.n)} > {cap}")
        n = int(tab.n)
        store("tablet", (tab.rows[:n].cpu().numpy(),
                         tab.cols[:n].cpu().numpy(),
                         tab.vals[:n].cpu().numpy()))
        launches["b"] = LAUNCHES["merge_path_rank"] - launches["a"]
        # (c) the tablet step, built once; after 4 steps a split and a move
        tstep = spmd.make_spmd_tablet_ingest_step(mesh, "data", S, "last")
        tm = TabletMap.uniform(S, idcap)
        routing = tm.device_routing(cfg["max_tablets"])
        l0c, received = spmd.l0_stacked_empty(slots, S * B, dev), []
        for i in range(steps):
            if i == steps // 2:  # the stack is full and checked: empty it
                sp = cfg["split"]
                tm.move(tm.split(sp["tablet"], sp["key"]), sp["move_to"])
                routing = tm.device_routing(cfg["max_tablets"])
                l0c = spmd.l0_stacked_empty(slots, S * B, dev)
            l0c = timed("tablet_step",
                        lambda: tstep(l0c, *batch(i), *routing))
            run = l0c.rows[int(l0c.k) - 1]
            rows = run[run != I32_MAX].cpu().numpy()
            if (tm.owner_of(rows) != rank).any():
                raise AssertionError(f"phase 9 rank {rank}: the tablet step "
                                     f"delivered rows the map does not give "
                                     f"it (step {i})")
            received.append(len(rows))
        launches["c"] = (LAUNCHES["merge_path_rank"] - launches["a"]
                         - launches["b"])
    calls = stash["merge_path_rank"].calls
    geos = sorted(calls)
    inputs = {}
    if rank == 0:
        for j, geo in enumerate(geos):
            for m, x in enumerate(calls[geo][1][0]):
                inputs[f"g{j}_{m}"] = x.cpu().numpy()
    result = dict(route=route, times=times, launches=launches,
                  counted=counted, received=received,
                  geometries=[[[list(s) for s in geo[0]], calls[geo][0]]
                              for geo in geos],
                  others={k: sum(c for c, _ in r.calls.values())
                          for k, r in stash.items()
                          if isinstance(r, Recorder)
                          and k != "merge_path_rank"},
                  map=tm.to_manifest(),
                  snapshot=default_registry().snapshot())
    files = {f"rank{rank}.npz": keep}
    if inputs:
        files["merge_inputs.npz"] = inputs
    return result, files


def torch_int(x, dev):
    import torch
    return torch.as_tensor(x, dtype=torch.int32, device=dev)


def rank_child(out_dir, rank):
    """Rank ``rank`` of phase 9's mesh or of phase 13a's, 13d's, 13f's, 13g's
    or 13h's mesh (``"phase"`` in ``out_dir``'s config.json names which), a
    process of its own: loads the kernel library phase 2 built (and refuses to
    build one), joins the mesh (the backend the parent chose: NCCL with a card
    a rank, else gloo with every rank on ``cuda:0``), runs the phase's body and
    writes its results into ``out_dir``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import common
    cfg = json.loads((out_dir / "config.json").read_text())
    body = {"phase 9": mesh_rank, "phase 13a": ep_rank,
            "phase 13d": cp_rank, "phase 13f": heads_rank,
            "phase 13g": serve_rank,
            "phase 13h": train_rank}[cfg["phase"]]
    if cfg["device"] == "cuda":
        if not (common.BUILD_DIR / common.source_hash()
                / "libreprotorch.so").exists():
            raise RuntimeError(f"{cfg['phase']}: no kernel library from "
                               "phase 2")
        common.lib()
        dev = torch.device("cuda", rank if cfg["backend"] == "nccl" else 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(cfg["device"])
    dist.init_process_group(cfg["backend"],
                            init_method=f"file://{out_dir / 'rdv'}",
                            world_size=cfg["ranks"], rank=rank)
    try:
        result, files = body(cfg, rank, dev, out_dir)
    finally:
        dist.destroy_process_group()
    for name, arrays in files.items():
        np.savez(out_dir / name, **arrays)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(result))
    return 0


def rank_command(out_dir, rank):
    """The command line of rank ``rank`` of the mesh set up in
    ``out_dir``."""
    return [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-child",
            str(out_dir), "--rank", str(rank)]


def run_ranks(n, out_dir, timeout=600):
    """Start the ``n`` ranks of the mesh set up in ``out_dir`` and wait for
    all; a rank that fails stops the others, and its log goes into the
    error. Returns seconds."""
    t0 = time.perf_counter()
    procs = []
    for r in range(n):
        out = open(out_dir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(rank_command(out_dir, r), stdout=out,
                                       stderr=subprocess.STDOUT), out))
    try:
        while True:
            codes = [p.poll() for p, _ in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            late = time.perf_counter() - t0 > timeout
            if bad or late:
                r = bad[0] if bad else 0
                raise AssertionError(
                    f"{out_dir.name}: rank {r} "
                    + (f"exited {codes[r]}" if bad else "timed out") + ": "
                    + (out_dir / f"rank{r}.log").read_text()[-4000:])
            if all(c == 0 for c in codes):
                break
            time.sleep(0.1)
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
    return time.perf_counter() - t0


class Recorded:
    """A path's kernel calls recorded in other processes, read as a
    ``Recorder``'s ``calls`` and a ``Calls``' count ``n``."""

    def __init__(self, calls=None):
        self.calls, self.n = calls or {}, 0


def mesh_path(graph, cap, smi, stash, device="cuda"):
    """Phase 9: the mesh path, parts a-c in 4 rank processes and d here.
    Checks every read against phase 3's host answers, the ranks' level runs
    and legacy tablets against the runs phase 3's store holds shard by
    shard (computed on the host from the triples), the tablet step's
    deliveries against the map, and the merged snapshots' step counts.
    Fills ``stash["mesh"]`` (the ranks' merge-path inputs, per geometry)
    and ``stash["mesh_nccl"]``; returns the two paths' launches."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.db.spmd import merge_process_metrics
    from repro_torch.obs.export import registry_from_snapshot
    S, steps = P9["ranks"], P9["steps"]
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    arrays, cfg, want, levels = mesh_inputs(graph, cap)
    nccl = device == "cuda" and torch.cuda.device_count() >= S
    cfg.update(phase="phase 9", backend="nccl" if nccl else "gloo",
               device=device)
    np.savez(MESH_DIR / "inputs.npz", **arrays)
    (MESH_DIR / "config.json").write_text(json.dumps(cfg))
    t_ranks = run_ranks(S, MESH_DIR)
    res = [json.loads((MESH_DIR / f"rank{r}.json").read_text())
           for r in range(S)]
    got = [dict(np.load(MESH_DIR / f"rank{r}.npz")) for r in range(S)]

    def union(key):
        return [np.concatenate([g[f"{key}/{x}"] for g in got]) for x in "rcv"]

    for tag in ("before", "after"):  # level + 4 L0 runs, then level only
        for name in want:
            same_arrays(union(f"{tag}/{name}"), want[name],
                        f"phase 9 {name} ({tag} the last compaction) vs "
                        f"phase 3's answer")
    for s in range(S):
        for key, table in (("level", "Tedge"), ("level_t", "TedgeT"),
                           ("tablet", "Tedge")):
            same_arrays([got[s][f"{key}/{x}"] for x in "rcv"],
                        levels[table][s], f"phase 9 rank {s} {key} vs "
                        f"phase 3's {table} shard {s}", ordered=True)
    starts = cfg["starts"]
    per_step = [sum(min(starts[r] + (i + 1) * P9["bcap"], starts[r + 1])
                    - min(starts[r] + i * P9["bcap"], starts[r + 1])
                    for r in range(S)) for i in range(steps)]
    delivered = [sum(x["received"][i] for x in res) for i in range(steps)]
    if delivered != per_step:
        raise AssertionError(f"phase 9 (c): delivered {delivered}, sent "
                             f"{per_step}")
    if any(x["map"] != res[0]["map"] for x in res):
        raise AssertionError("phase 9 (c): the ranks' maps differ")
    for x in res:
        if any(x["others"].values()):
            raise AssertionError(f"phase 9: a kernel other than the merge "
                                 f"path launched: {x['others']}")
    # the ranks' registries merged
    merged = registry_from_snapshot(merge_process_metrics(
        [x["snapshot"] for x in res]))
    counts = {op: sum(c.value for c in merged.series("spmd_steps", op=op))
              for op in ("spmd_lsm_pair_ingest", "spmd_lsm_compact",
                         "spmd_lsm_query", "spmd_lsm_scan", "spmd_ingest",
                         "spmd_tablet_ingest")}
    want_counts = {"spmd_lsm_pair_ingest": S * steps,
                   "spmd_lsm_compact": S * 4, "spmd_lsm_query": S * 4,
                   "spmd_ingest": S * steps, "spmd_tablet_ingest": S * steps}
    if any(counts[k] != v for k, v in want_counts.items()) \
            or counts["spmd_lsm_scan"] < S * 4:
        raise AssertionError(f"phase 9: merged step counts {counts}")
    # phase 5's inputs: rank 0's per geometry, the calls of every rank
    geos = [tuple(tuple(s) for s in g) for g, _ in res[0]["geometries"]]
    if any([tuple(tuple(s) for s in g) for g, _ in x["geometries"]] != geos
           for x in res):
        raise AssertionError("phase 9: the ranks' merge geometries differ")
    inputs = dict(np.load(MESH_DIR / "merge_inputs.npz"))
    recs = {name: Recorded() for name in wrapper_sites()}
    recs["probe_stack"], recs["combine_rows"] = Recorded(), Recorded()
    for j, geo in enumerate(geos):
        args = [torch.as_tensor(inputs[f"g{j}_{m}"], device=device)
                for m in range(len(geo))]
        key = (geo, (), tuple(str(a.dtype)[6:] for a in args))
        recs["merge_path_rank"].calls[key] = [
            sum(x["geometries"][j][1] for x in res), (args, {})]
    stash["mesh"] = recs
    launches = {"mesh": {k: sum(x["counted"][k] for x in res)
                         for k in res[0]["counted"]}}
    parts = {p: [x["launches"][p] for x in res] for p in "abc"}
    if launches["mesh"]["merge_path_rank"] <= 0 or not all(parts["a"]) \
            or not all(parts["b"]) or any(parts["c"]):
        raise AssertionError(f"phase 9: merge-path launches by part {parts}")
    # (d) a single NCCL rank (gloo on the CPU) in this process
    launches["mesh_nccl"], nccl_times = single_rank(arrays, cfg, stash,
                                                    device)
    for x in res:
        log(f"phase 9 rank: " + json.dumps({
            "route": x["route"], "launches": x["launches"],
            "received": x["received"], "ms": x["times"]}))
    log(f"phase 9 ({smi}): {S} ranks on "
        + ("one card each over NCCL" if nccl else
           f"{device} over gloo, the exchange "
           + ("staged through pinned host buffers" if device == "cuda"
              else "on host tensors"))
        + f", {t_ranks:.3f} s from start to exit; every read (before and "
        f"after the last compaction) equals phase 3's answer, the level runs "
        f"and legacy tablets equal phase 3's triples routed and sorted on "
        f"the host shard by shard, the "
        f"tablet step delivered {delivered} entries each to its owner under "
        f"the map (split of tablet {cfg['split']['tablet']} at "
        f"{cfg['split']['key']}, moved to rank {cfg['split']['move_to']}); "
        f"merge-path launches by part {parts}; merged step counts "
        + json.dumps(counts) + "; single NCCL rank "
        + json.dumps(nccl_times))
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    return launches


def single_rank(arrays, cfg, stash, device="cuda"):
    """Phase 9 (d): one rank (S = 1) over NCCL in this process (gloo when
    ``device`` is the CPU): the first batches of rank 0's quarter through
    the LSM ingest step, a compaction and a point read of some of their
    rows, held against a host filter. Fills ``stash["mesh_nccl"]``;
    returns (launches, ms)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.db import spmd
    B, n_steps = cfg["bcap"], cfg["nccl_steps"]
    end = min(cfg["starts"][1], n_steps * B)
    rng = np.random.default_rng(9)
    q = np.unique(rng.choice(arrays["rid"][:end], cfg["nccl_queries"]))
    sel = np.isin(arrays["rid"][:end], q)
    want = tuple(arrays[k][:end][sel] for k in ("rid", "cid", "val"))
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        init_method=f"file://{MESH_DIR / 'single_rdv'}", world_size=1,
        rank=0)
    times = {}
    try:
        mesh = spmd.make_mesh("data")
        ingest = spmd.make_spmd_lsm_ingest_step(mesh, "data", 1,
                                                cfg["id_capacity"], "last")
        compact = spmd.make_spmd_lsm_compact_step(mesh, "data", "last")
        query = spmd.make_spmd_lsm_query_step(
            mesh, "data", "last", max_return=int(np.bincount(want[0]).max()))
        stash["mesh_nccl"] = {}
        with kernel_run(stash["mesh_nccl"]) as launches:
            l0 = spmd.l0_stacked_empty(cfg["slots"], B, device)
            lv = spmd.stacked_empty(cfg["nccl_level"], device)
            for i in range(n_steps):
                l0, times[f"step{i}"] = timed_once(lambda: ingest(
                    l0, *mesh_batch(arrays, min(i * B, end),
                                    min((i + 1) * B, end), B, device)))
            (l0, lv), times["compact"] = timed_once(lambda: compact(l0, lv))
            qt = torch_int(q, device)
            out, times["query"] = timed_once(lambda: query(l0, lv, qt))
        same_arrays(mesh_kept(out, qt[:, None].expand_as(out[0]), 0, 1),
                    want, "phase 9 (d) point read vs the host")
        route = spmd.exchange_route(mesh.get_group("data"),
                                    torch.device(device))
    finally:
        dist.destroy_process_group()
    if launches["merge_path_rank"] <= 0 or route["staged"]:
        raise AssertionError(f"phase 9 (d): launches {launches}, {route}")
    times["backend"] = route["backend"]
    return launches, times


# ------------------------------------------------------------------ phase 5
# ------------------------------------------------------------------ phase 13
P13 = dict(reduced=False, moe="olmoe-1b-7b", layers=2, ranks=4, batch=4,
           seq=512, rtol=1e-5, timed_steps=5,
           # 13d: context parallelism and the kv_seq-sharded decode
           # (depth cut to 8 of 30 layers: the script's time limit)
           cp_arch="smollm-135m", cp_layers=8, cp_prompt=4096,
           cp_max_len=8192,
           cp_decode=32, cp_rtol={"float32": 1e-4, "bfloat16": 2e-2},
           # 13e: the reduced configs' head dims on the card
           small=(("smollm-135m", 16), ("yi-34b", 8)), small_prompt=64,
           small_decode=8,
           # 13e: the widest GQA groups (rep 7 and 12 at hd 128)
           wide=("yi-34b", "command-r-plus-104b"), wide_batch=2,
           wide_prompt=512, wide_decode=8,
           # 13f: heads the model axis does not divide, on DTensors
           heads_arch="smollm-135m", heads_layers=2, heads_batch=4,
           heads_seq=512,
           heads_rtol={"float32": 1e-5, "bfloat16": 2e-2},
           # 13g: serving on DTensors in the MoE, hybrid and enc-dec
           # families (2 layers a stack; the hybrid's one group)
           serve_archs=("olmoe-1b-7b", "zamba2-2.7b", "whisper-large-v3"),
           # and in float32 only: qwen2.5-3b (GQA rep 8, its 2 KV heads
           # split [1, 1, 0, 0] on the 4-wide axis)
           serve_f32_archs=("qwen2.5-3b",),
           mesh_layers=2, serve_batch=4, serve_prompt=512, serve_decode=8,
           serve_rtol={"float32": 1e-5, "bfloat16": 2e-2},
           # 13h: a train step on DTensors in five families (the same
           # cuts), bf16 in the hybrid only (the script's time limit)
           train_archs=("olmoe-1b-7b", "mamba2-2.7b", "zamba2-2.7b",
                        "whisper-large-v3", "internvl2-26b", "qwen2.5-3b"),
           train_bf16_archs=("zamba2-2.7b",), train_batch=4, train_seq=512,
           train_rtol={"float32": 1e-5, "bfloat16": 2e-2})
EP_DIR = ROOT / "build" / "phase13"
CP_DIR = ROOT / "build" / "phase13d"
HEADS_DIR = ROOT / "build" / "phase13f"
SERVE_DIR = ROOT / "build" / "phase13g"
TRAIN_DIR = ROOT / "build" / "phase13h"


def p13_config(**kw):
    import dataclasses
    from repro_torch.configs import get_config, get_reduced
    cfg = (get_reduced if P13["reduced"] else get_config)(P13["moe"])
    return dataclasses.replace(cfg, n_layers=P13["layers"], **kw)


def tensors_to_npz(prefix, tensors, out):
    """Tensors into ``out`` (a dict for ``np.savez``): bf16 as its int16
    bits, the dtype in the key."""
    import torch
    for m, t in enumerate(tensors):
        t = t.detach().cpu()
        name = str(t.dtype)[6:]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        out[f"{prefix}_{m}_{name}"] = t.numpy()


def tensors_from_npz(prefix, arrays, device):
    import torch
    got = []
    for key in sorted((k for k in arrays if k.startswith(prefix + "_")),
                      key=lambda k: int(k.split("_")[-2])):
        t = torch.from_numpy(arrays[key])
        if key.endswith("_bfloat16"):
            t = t.view(torch.bfloat16)
        got.append(t.to(device))
    return got


def ep_rank(conf, rank, dev, out_dir):
    """Phase 13a on one rank: the MoE prefill over the EP mesh against the
    local path, the drops at the config's own capacity, the int8 gather
    against its plain version and ``elastic_restore`` against the full
    arrays. Returns (result dict, {file name: arrays to save}), the file
    rank 0's attention inputs."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import (ShardingRules, build, init_params,
                                    make_sharder, moe)
    from repro_torch.models.spec import (flatten_up_to, local_block,
                                         placements, tree_leaves, tree_map,
                                         tree_unflatten)
    from repro_torch.train import checkpoint
    from repro_torch.train.elastic import elastic_restore

    n = conf["ranks"]
    cfg = p13_config()
    wide = p13_config(param_dtype="float32",
                      capacity_factor=cfg.n_experts / cfg.experts_per_token)
    own = p13_config(param_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(conf["seed"])
    p32 = init_params(build(wide).param_specs, gen, device=dev)
    specs16 = build(cfg).param_specs  # the served dtypes: bf16 weights
    p16 = tree_unflatten(specs16, [w.to(s.dtype) for s, w in zip(
        tree_leaves(specs16), flatten_up_to(specs16, p32))])
    rng = np.random.default_rng(conf["seed"])
    toks = torch.as_tensor(rng.integers(1, cfg.vocab, (conf["batch"],
                                                       conf["seq"]))
                           .astype(np.int32), device=dev)
    mesh = init_device_mesh("cpu", (1, n), mesh_dim_names=("data", "model"))
    sh = make_sharder(ShardingRules(batch=("data",), fsdp="data"), mesh)
    res, keep, rec = {"rank": rank}, {}, {}

    def prefill(c, params, hook):
        with Calls(moe, "route", keep=True) as routes:
            out = build(c).prefill(params, {"tokens": toks}, hook)[0]
        drops = sum(int((~r.keep).sum()) for _, r in routes.kept)
        return out.float(), drops

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    t0 = time.perf_counter()
    with kernel_run(rec) as launches:
        ep32, d32 = prefill(wide, p32, sh)
        ep16, d16 = prefill(p13_config(capacity_factor=wide.capacity_factor),
                            p16, sh)
        _, res["drops_own_factor"] = prefill(own, p32, sh)
        if rank == 0:  # the single-process local path
            loc32, _ = prefill(wide, p32, None)
            loc16, _ = prefill(p13_config(
                capacity_factor=wide.capacity_factor), p16, None)
            res["rel_f32"] = rel(ep32, loc32)
            res["rel_bf16_vs_local_bf16"] = rel(ep16, loc16)
            res["rel_bf16_vs_f32"] = rel(ep16, loc32)
            res["rel_local_bf16_vs_f32"] = rel(loc16, loc32)
        res["drops_no_drop_factor"] = d32 + d16
        res["finite"] = bool(torch.isfinite(ep32).all()
                             and torch.isfinite(ep16).all())
        # the int8 FSDP gather on a (2, 2) mesh, and a prefill through it
        mesh2 = init_device_mesh("cpu", (2, n // 2),
                                 mesh_dim_names=("data", "model"))
        rules2 = ShardingRules(batch=("data",), fsdp="data",
                               moe_gather="int8")
        ep8, d8 = prefill(wide, p32, make_sharder(rules2, mesh2))
        res["drops_no_drop_factor"] += d8
        res["int8_finite"] = bool(torch.isfinite(ep8).all())
        if rank == 0:
            res["rel_int8_vs_f32"] = rel(ep8, loc32)
    res["launches"] = dict(launches)
    res["calls"] = [[[list(map(list, g[0])), [list(kv) for kv in g[1]],
                      list(g[2])], c]
                    for g, (c, _) in rec["flash_attention"].calls.items()]
    if rank == 0:
        for j, (g, (_, (args, kw))) in enumerate(
                rec["flash_attention"].calls.items()):
            tensors_to_npz(f"g{j}", args, keep)
    gathered = {}
    fsdp = mesh2.get_group("data")
    d, m = mesh2.get_coordinate()
    blocks = tree_map(lambda w: w[0], p16["blocks"]["moe"])
    for name, axis in (("w_gate", 1), ("w_up", 1), ("w_down", 2)):
        w = blocks[name]
        spec = (("model", "data", None) if axis == 1 else
                ("model", None, "data"))
        mine = local_block(w, placements(spec, mesh2), mesh2)
        got = moe.gather_w_int8(mine, fsdp, axis)
        e = w.shape[0] // (n // 2)
        part = w.shape[axis] // 2
        shards = [w[m * e:(m + 1) * e].narrow(axis, j * part, part)
                  for j in range(2)]
        gathered[name] = bool(torch.equal(got, moe.gather_w_int8_ref(
            shards, axis)))
    res["int8_gather_equal"] = gathered
    # elastic_restore of layer 0's MoE parameters onto the (2, 2) mesh
    ckpt = Path(conf["dir"]) / "ckpt"
    if rank == 0:
        checkpoint.save(str(ckpt), 1, tree_map(lambda w: w.cpu(), blocks))
    dist.barrier()
    tree, _ = elastic_restore(str(ckpt), moe.moe_specs(cfg), mesh2,
                              rules2)
    eq = {}
    for name in sorted(blocks):
        t, full = tree[name], blocks[name].cpu()
        want = local_block(full, t.placements, mesh2)
        eq[name] = [list(t.to_local().shape),
                    bool(torch.equal(t.to_local(), want))]
    res["elastic"] = eq
    res["seconds"] = time.perf_counter() - t0
    return res, {"attention_inputs.npz": keep} if keep else {}


def moe_expert_parallel(seed, smi, stash, device="cuda"):
    """13a: olmoe-1b-7b at full width (depth cut to ``P13["layers"]``) in 4
    rank processes on mesh (1, 4) (EP 4) and (2, 2) (fsdp "data", int8
    gather). Checks the no-drop logits against rank 0's local path (float32
    within ``P13["rtol"]``), the int8 gathers and ``elastic_restore``
    exactly; fills ``stash["moe_ep"]`` with rank 0's #7 inputs (the calls
    of all ranks) and returns the path's launches."""
    import shutil
    import numpy as np
    import torch
    n = P13["ranks"]
    shutil.rmtree(EP_DIR, ignore_errors=True)
    EP_DIR.mkdir(parents=True)
    from repro_torch.configs import get_config
    cfg = p13_config()
    log(f"phase 13a: {describe(cfg)} (depth cut to {cfg.n_layers} of "
        f"{get_config(P13['moe']).n_layers}); {n} ranks, "
        f"{P13['batch']} x {P13['seq']} tokens")
    (EP_DIR / "config.json").write_text(json.dumps(
        dict(phase="phase 13a", backend="gloo", seed=seed, device=device,
             ranks=n, batch=P13["batch"], seq=P13["seq"], dir=str(EP_DIR))))
    t_ranks = run_ranks(n, EP_DIR, timeout=300)
    res = [json.loads((EP_DIR / f"rank{r}.json").read_text())
           for r in range(n)]
    r0 = res[0]
    if r0["rel_f32"] > P13["rtol"]:
        raise AssertionError(f"phase 13a: the expert-parallel float32 "
                             f"logits vs the local path's: {r0['rel_f32']}")
    for x in res:
        if x["drops_no_drop_factor"] or not x["finite"] \
                or not x["int8_finite"]:
            raise AssertionError(f"phase 13a rank {x['rank']}: drops "
                                 f"{x['drops_no_drop_factor']} at the no-drop"
                                 f" capacity, or non-finite logits")
        if not all(x["int8_gather_equal"].values()):
            raise AssertionError(f"phase 13a rank {x['rank']}: the int8 "
                                 f"gather vs its plain version "
                                 f"{x['int8_gather_equal']}")
        if not all(v[1] for v in x["elastic"].values()):
            raise AssertionError(f"phase 13a rank {x['rank']}: "
                                 f"elastic_restore {x['elastic']}")
        others = {k: v for k, v in x["launches"].items()
                  if v and k != "flash_attention"}
        prefills = 6 if x["rank"] == 0 else 4
        want = prefills * cfg.n_layers
        if device == "cuda" and (others or
                                 x["launches"]["flash_attention"] != want):
            raise AssertionError(f"phase 13a rank {x['rank']}: launches "
                                 f"{x['launches']}, want {want} of "
                                 f"flash_attention only")
    # phase 5's inputs: rank 0's per geometry, the calls of every rank
    inputs = dict(np.load(EP_DIR / "attention_inputs.npz"))
    recs = {name: Recorded() for name in wrapper_sites()}
    recs["probe_stack"], recs["combine_rows"] = Recorded(), Recorded()
    counts = {}
    for x in res:
        for g, c in x["calls"]:
            key = (tuple(tuple(s) for s in g[0]),
                   tuple(tuple(kv) for kv in g[1]), tuple(g[2]))
            counts[key] = counts.get(key, 0) + c
    for j, (g, _) in enumerate(r0["calls"]):
        key = (tuple(tuple(s) for s in g[0]),
               tuple(tuple(kv) for kv in g[1]), tuple(g[2]))
        args = tensors_from_npz(f"g{j}", inputs, device)
        recs["flash_attention"].calls[key] = [counts[key],
                                              (args, dict(key[1]))]
    if sum(counts.values()) != sum(c for c, _ in
                                   recs["flash_attention"].calls.values()):
        raise AssertionError("phase 13a: the ranks' attention geometries "
                             "differ from rank 0's")
    stash["moe_ep"] = recs
    launches = {k: sum(x["launches"][k] for x in res)
                for k in res[0]["launches"]}
    log(f"phase 13a ({smi}): {n} ranks on {device} over gloo, "
        f"{t_ranks:.3f} s from start to exit; no-drop capacity factor "
        f"{cfg.n_experts / cfg.experts_per_token:g}: float32 logits vs the "
        f"local path's relative error norm {r0['rel_f32']:.3g} (limit "
        f"{P13['rtol']:g}); bf16: vs the local bf16 "
        f"{r0['rel_bf16_vs_local_bf16']:.3g}, vs the local float32 "
        f"{r0['rel_bf16_vs_f32']:.3g} (the local bf16 vs float32 "
        f"{r0['rel_local_bf16_vs_f32']:.3g}); drops at the config's factor "
        f"{cfg.capacity_factor:g} by rank "
        + json.dumps([x["drops_own_factor"] for x in res])
        + f"; mesh (2, 2) int8 gather equal to plain "
        + json.dumps(r0["int8_gather_equal"])
        + f", its logits vs the local float32 {r0['rel_int8_vs_f32']:.3g}; "
        f"elastic_restore blocks equal to the full arrays' on every rank "
        + json.dumps(r0["elastic"]) + "; #7 launches by rank "
        + json.dumps([x["launches"]["flash_attention"] for x in res])
        + "; seconds by rank "
        + json.dumps([round(x["seconds"], 3) for x in res]))
    shutil.rmtree(EP_DIR, ignore_errors=True)
    return {"moe_ep": launches}


def cp_config(dtype):
    import dataclasses
    from repro_torch.configs import get_config, get_reduced
    cfg = (get_reduced if P13["reduced"] else get_config)(P13["cp_arch"])
    return dataclasses.replace(cfg, param_dtype=dtype,
                               n_layers=min(cfg.n_layers, P13["cp_layers"]))


def cp_rank(conf, rank, dev, out_dir):
    """Phase 13d on one rank: smollm-135m (full width, ``cp_layers`` of
    its 30 layers) on mesh (1, 4) with ``model``, ``attn_q`` and
    ``kv_seq`` on the 4-wide axis;
    the full weights, tokens and cache on every rank (``sharded_
    attention``'s full-value mode). A prefill of ``cp_prompt`` tokens into
    a ``cp_max_len``-slot cache (context parallelism: this rank's rows of
    every 512-row block, one #7 launch a block), then ``cp_decode`` steps
    (this rank's quarter of the slots, merged by (o, lse)); in bf16 (path
    ``cp``) and float32 (``cp_check``). Rank 0 runs the unsharded path too.
    Returns (result dict, {file: this rank's #7 inputs per geometry})."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import (ShardingRules, build, init_params,
                                    make_sharder, sharded_attention)
    n = conf["ranks"]
    mesh = init_device_mesh("cpu", (1, n), mesh_dim_names=("data", "model"))
    rules = ShardingRules(batch=("data",), model="model", kv_seq="model")
    sh = make_sharder(rules, mesh)
    s, m, steps = P13["cp_prompt"], P13["cp_max_len"], P13["cp_decode"]
    rng = np.random.default_rng(conf["seed"])
    toks = torch.as_tensor(rng.integers(1, cp_config("float32").vocab,
                                        (1, s + steps)).astype(np.int32),
                           device=dev)

    def run(model, params, hook, tag):
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": toks[:, :s],
                                               "max_len": m}, hook)
        out = [logits.float()]
        t1 = time.perf_counter()
        for t in range(steps):
            logits, cache = model.decode(params, {
                "token": toks[:, s + t:s + t + 1], "cache": cache,
                "pos": s + t}, hook)
            out.append(logits.float())
        out = torch.cat(out, 1)
        res["seconds_" + tag] = [t1 - t0, time.perf_counter() - t1]
        return out

    res, files, calls = {"rank": rank, "launches": {}}, {}, {}
    t0 = time.perf_counter()
    for dtype, path in (("bfloat16", "cp"), ("float32", "cp_check")):
        cfg = cp_config(dtype)
        model = build(cfg)
        gen = torch.Generator(device=dev).manual_seed(conf["seed"])
        params = init_params(model.param_specs, gen, device=dev)
        with Recorder(sharded_attention, "flash_attention") as rec:
            reset_launches()
            got = run(model, params, sh, path)
            res["launches"][path] = dict(LAUNCHES)
        res[f"finite_{dtype}"] = bool(torch.isfinite(got).all())
        res[f"logits_{dtype}"] = got[0, :, :256].cpu().numpy().tolist()
        if rank == 0:
            want = run(model, params, None, path + "_unsharded")
            res[f"rel_{dtype}"] = rel_err(got, want)
        calls[path] = [[[list(map(list, g[0])), [list(kv) for kv in g[1]],
                         list(g[2])], c]
                       for g, (c, _) in rec.calls.items()]
        for j, (_, (args, _)) in enumerate(rec.calls.values()):
            tensors_to_npz(f"{path}_g{j}", args, files)
        del params, model
    res["calls"] = calls
    res["seconds"] = time.perf_counter() - t0
    return res, {f"inputs{rank}.npz": files}


def context_parallel(seed, smi, stash, device="cuda"):
    """13d: ``cp_rank`` on 4 rank processes on ``cuda:0`` over gloo (their
    collectives staged through pinned host buffers). Checks each rank's
    logits against rank 0's unsharded path (float32 within ``cp_rtol``
    1e-4, the merge reorders sums; bf16 2e-2), every rank's logits equal,
    and the #7 launches per rank: a launch a 512-row block a layer in the
    prefill, and a decode step's launch on the ranks whose slots hold a
    position up to it. Fills ``stash["cp"]`` and ``stash["cp_check"]``
    with every rank's #7 inputs; returns the paths' launches."""
    import shutil
    import numpy as np
    n = P13["ranks"]
    shutil.rmtree(CP_DIR, ignore_errors=True)
    CP_DIR.mkdir(parents=True)
    cfg = cp_config("bfloat16")
    s, m, steps = P13["cp_prompt"], P13["cp_max_len"], P13["cp_decode"]
    log(f"phase 13d: {describe(cfg)}; {n} ranks on mesh (1, {n}), model / "
        f"attn_q / kv_seq on the {n}-wide axis; a prefill of 1 x {s} "
        f"tokens into {m} slots, {steps} decode steps")
    (CP_DIR / "config.json").write_text(json.dumps(
        dict(phase="phase 13d", backend="gloo", seed=seed, device=device,
             ranks=n, dir=str(CP_DIR))))
    t_ranks = run_ranks(n, CP_DIR, timeout=300)
    res = [json.loads((CP_DIR / f"rank{r}.json").read_text())
           for r in range(n)]
    for dtype in ("float32", "bfloat16"):
        rel = res[0][f"rel_{dtype}"]
        if not rel <= P13["cp_rtol"][dtype]:
            raise AssertionError(f"phase 13d: {dtype} sharded logits vs the "
                                 f"unsharded path's: {rel}")
        first = np.asarray(res[0][f"logits_{dtype}"])
        for x in res:  # every rank holds the same full values
            d = np.abs(np.asarray(x[f"logits_{dtype}"]) - first).max()
            if not x[f"finite_{dtype}"] or not d <= 1e-6 * np.abs(
                    first).max():
                raise AssertionError(f"phase 13d rank {x['rank']}: {dtype} "
                                     f"logits non-finite or {d} off rank "
                                     f"0's")
    slots = m // n
    want = [cfg.n_layers * (s // 512 + sum(
        1 for t in range(steps) if s + t >= r * slots)) for r in range(n)]
    launches = {}
    for path in ("cp", "cp_check"):
        got = [x["launches"][path] for x in res]
        for r, x in enumerate(got):
            others = {k: v for k, v in x.items()
                      if v and k != "flash_attention"}
            if device == "cuda" and (others
                                     or x["flash_attention"] != want[r]):
                raise AssertionError(f"phase 13d rank {r} {path}: launches "
                                     f"{x}, want {want[r]} of #7 only")
        launches[path] = {k: sum(x[k] for x in got) for k in got[0]}
        recs = {name: Recorded() for name in wrapper_sites()}
        recs["probe_stack"], recs["combine_rows"] = Recorded(), Recorded()
        for x in res:
            arrays = dict(np.load(CP_DIR / f"inputs{x['rank']}.npz"))
            for j, (g, c) in enumerate(x["calls"][path]):
                key = (tuple(tuple(d) for d in g[0]),
                       tuple(tuple(kv) for kv in g[1]), tuple(g[2]))
                if key in recs["flash_attention"].calls:
                    recs["flash_attention"].calls[key][0] += c
                    continue
                args = tensors_from_npz(f"{path}_g{j}", arrays, device)
                recs["flash_attention"].calls[key] = [c, (args,
                                                          dict(key[1]))]
        stash[path] = recs
    log(f"phase 13d ({smi}): {n} ranks on {device} over gloo, {t_ranks:.3f}"
        f" s from start to exit; logits ({1 + steps} positions) vs rank 0's "
        f"unsharded path: float32 relative error norm "
        f"{res[0]['rel_float32']:.3g} (limit {P13['cp_rtol']['float32']:g}),"
        f" bf16 {res[0]['rel_bfloat16']:.3g} (limit "
        f"{P13['cp_rtol']['bfloat16']:g}); every rank's logits equal; #7 "
        f"launches by rank (bf16, then float32) "
        + json.dumps([x["launches"]["cp"]["flash_attention"] for x in res])
        + " " + json.dumps([x["launches"]["cp_check"]["flash_attention"]
                            for x in res])
        + f" (want {want}: {s // 512} blocks a layer in the prefill, a "
        f"decode launch where the rank's slots reach the position); geometries"
        f" {len(stash['cp']['flash_attention'].calls)}; seconds by rank "
        + json.dumps([round(x["seconds"], 3) for x in res])
        + "; rank 0's (prefill, decode) seconds by run "
        + json.dumps({k[8:]: [round(t, 3) for t in v] for k, v in
                      res[0].items() if k.startswith("seconds_")}))
    shutil.rmtree(CP_DIR, ignore_errors=True)
    return launches


def small_heads(seed, smi, stash, device="cuda"):
    """13e: #7 at the reduced configs' head dims (16: smollm-135m, 8:
    yi-34b) on the card, bf16 and float32: a prefill of 2 x
    ``small_prompt`` tokens and ``small_decode`` steps, the logits against
    the CPU's plain route (float32 within 1e-4, bf16 2e-2). Fills
    ``stash["small"]``; returns its launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.models import build, init_params
    from repro_torch.models.spec import tree_map
    s, steps = P13["small_prompt"], P13["small_decode"]
    rng = np.random.default_rng(seed)

    def run(model, params, toks, dev):
        p = tree_map(lambda w: w.to(dev), params)
        t = toks.to(dev)
        logits, cache = model.prefill(p, {"tokens": t[:, :s],
                                          "max_len": s + steps})
        seq = [logits]
        for i in range(steps):
            logits, cache = model.decode(p, {
                "token": t[:, s + i:s + i + 1], "cache": cache,
                "pos": s + i})
            seq.append(logits)
        return torch.cat(seq, 1).cpu()

    runs = []  # (name, model, params, tokens, the CPU's logits)
    for arch, hd in P13["small"]:
        for dtype in ("bfloat16", "float32"):
            cfg = dataclasses.replace(get_reduced(arch), param_dtype=dtype)
            if cfg.hd != hd:
                raise AssertionError(f"phase 13e: {arch} hd {cfg.hd}")
            model = build(cfg)
            params = init_params(model.param_specs,
                                 torch.Generator().manual_seed(seed))
            toks = torch.as_tensor(rng.integers(
                1, cfg.vocab, (2, s + steps)).astype(np.int32))
            runs.append((f"{arch} hd {hd} {dtype}", model, params, toks,
                         run(model, params, toks, "cpu")))
    out, want_launches = {}, 0
    with kernel_run(stash) as launches:  # the card's runs only
        for name, model, params, toks, want in runs:
            rel = rel_err(run(model, params, toks, device), want)
            if not rel <= (1e-4 if "float32" in name else 2e-2):
                raise AssertionError(f"phase 13e: {name} logits vs the "
                                     f"CPU's: {rel}")
            out[name] = rel
            want_launches += model.cfg.n_layers * (1 + steps)
    if device == "cuda" and (launches["flash_attention"] != want_launches
                             or sum(launches.values()) != want_launches):
        raise AssertionError(f"phase 13e: launches {launches}, want "
                             f"{want_launches} of #7")
    log(f"phase 13e ({smi}): the reduced configs on the card, logits vs the "
        f"CPU's, relative error norms " + json.dumps(out)
        + f"; #7 launches {launches['flash_attention']}")
    return launches


def wide_gqa(seed, smi, stash, device="cuda"):
    """13e (cont.): #7 at the widest GQA groups on the card: yi-34b (56
    heads over 8: rep 7) and command-r-plus-104b (96 over 8: rep 12) at
    full width and hd 128, one layer, bf16 weights drawn on the card. A
    prefill of ``wide_batch`` x ``wide_prompt`` tokens into ``wide_prompt
    + wide_decode`` slots and ``wide_decode`` steps through
    ``build(cfg).prefill`` / ``.decode``, the last step's logits against
    one prefill over every token (the same cache rows: within 5e-2,
    phase 6's bf16 limit); path ``gqa_wide``. Then #7 called with the
    rows' lse at the same head layouts, seeded inputs: a prefill and a
    split-K decode step at the end of a 2,048-slot cache (path
    ``gqa_wide_check``: phase 5 holds o and lse to plain there). Fills
    both paths' stash; returns their launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build, init_params, layers
    b, s, steps = P13["wide_batch"], P13["wide_prompt"], P13["wide_decode"]
    rng = np.random.default_rng(seed)
    out, want = {}, 0
    for path in ("gqa_wide", "gqa_wide_check"):
        stash.setdefault(path, {})
    with kernel_run(stash["gqa_wide"]) as launches:
        for arch in P13["wide"]:
            cfg = dataclasses.replace(get_config(arch), n_layers=1)
            model = build(cfg)
            gen = torch.Generator(device=device).manual_seed(seed)
            params = init_params(model.param_specs, gen, device=device)
            toks = torch.as_tensor(rng.integers(1, cfg.vocab, (
                b, s + steps)).astype(np.int32), device=device)
            logits, cache = model.prefill(params, {"tokens": toks[:, :s],
                                                   "max_len": s + steps})
            for i in range(steps):
                logits, cache = model.decode(params, {
                    "token": toks[:, s + i:s + i + 1], "cache": cache,
                    "pos": s + i})
            full, _ = model.prefill(params, {"tokens": toks})
            rel = rel_err(logits[:, -1], full[:, -1])
            if not (rel <= 5e-2 and bool(torch.isfinite(logits).all())):
                raise AssertionError(f"phase 13e: {arch} the last decode "
                                     f"step vs one prefill: {rel}")
            out[f"{arch} rep {cfg.n_heads // cfg.n_kv_heads}"] = rel
            want += cfg.n_layers * (2 + steps)
            del params, cache, logits, full
            free_card()
    if device == "cuda" and (launches["flash_attention"] != want
                             or sum(launches.values()) != want):
        raise AssertionError(f"phase 13e: wide GQA launches {launches}, "
                             f"want {want} of #7")
    with kernel_run(stash["gqa_wide_check"]) as checks:
        for arch in P13["wide"]:
            cfg = get_config(arch)
            h, kv = cfg.n_heads, cfg.n_kv_heads
            gen = torch.Generator().manual_seed(seed)
            for (n, sq, sk), off in (((1, s, s), 0), ((4, 1, 2048), 2047)):
                q, k, v = (torch.randn(n, length, heads, cfg.hd,
                                       generator=gen).to(device=device,
                                                         dtype=torch.bfloat16)
                           for length, heads in ((sq, h), (sk, kv), (sk, kv)))
                layers.flash_attention(q, k, v, causal=True, q_offset=off,
                                       return_lse=True)
    log(f"phase 13e ({smi}): yi-34b and command-r-plus-104b at full width, "
        f"1 layer, bf16: the last of {steps} decode steps after a prefill of "
        f"{b} x {s} tokens vs one prefill over all, relative error norm "
        + json.dumps(out) + f"; #7 launches {launches['flash_attention']}; "
        f"with lse, held to plain in phase 5: "
        f"{checks['flash_attention']}")
    return {"gqa_wide": launches, "gqa_wide_check": checks}


def heads_config(dtype):
    import dataclasses
    from repro_torch.configs import get_config, get_reduced
    cfg = (get_reduced if P13["reduced"] else get_config)(P13["heads_arch"])
    return dataclasses.replace(cfg, param_dtype=dtype,
                               n_layers=P13["heads_layers"])


def heads_rank(conf, rank, dev, out_dir):
    """Phase 13f on one rank: smollm-135m at full width (9 heads over 3
    KV heads at hd 64: ranks 0-2 hold 3 heads each, rank 3 none; vocab
    49,152) and ``heads_layers`` of its layers on mesh (1, 4) under the
    production rules (``launch.dryrun.rules_for``: ``model``, ``kv_seq``
    and the experts on the 4-wide axis), the parameters and the batch
    DTensors on the rank's device (a CUDA mesh over gloo: DTensor's
    collectives go through pinned host buffers, ``spec.
    staged_collectives``). One train step of ``heads_batch`` x
    ``heads_seq`` tokens (the attention's "heads" case), then prefills of
    those tokens into as many slots: under the same rules (the cache
    sequence-sharded, the "kv_seq" case) and with ``kv_seq`` None (the
    cache whole on the axis, the "heads" case). All of it under
    ``launch.dryrun.ReshardOnRefusal``, which counts any op DTensor
    refuses. bf16 (path ``heads``) and float32 (``heads_check``); rank 0
    runs the unsharded step and prefills too. Returns (result dict,
    {file: this rank's #7 inputs per geometry})."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.dryrun import ReshardOnRefusal, rules_for
    from repro_torch.models import (build, init_params, make_sharder,
                                    sharded_attention, sharding_tree)
    from repro_torch.models.spec import (contiguous_stride, flatten_up_to,
                                         local_block, staged_collectives,
                                         tree_leaves, tree_map)
    from repro_torch.train.train_step import loss_and_grads
    n = conf["ranks"]
    mesh = init_device_mesh(dev.type, (1, n),
                            mesh_dim_names=("data", "model"))
    rules = {"train": rules_for(False),
             "heads": rules_for(False, {"kv_seq": None})}
    b, s = P13["heads_batch"], P13["heads_seq"]
    rng = np.random.default_rng(conf["seed"])
    toks = torch.as_tensor(rng.integers(1, heads_config("float32").vocab,
                                        (b, s)).astype(np.int32), device=dev)

    def place(tree, specs, r):
        """Each rank's block of the full values (the same on every rank),
        as DTensors placed by ``r``: no exchange."""
        pls = flatten_up_to(specs, sharding_tree(specs, r, mesh))
        it = iter(DTensor.from_local(
            local_block(x, pl, mesh).contiguous(), mesh, pl,
            run_check=False, shape=x.shape, stride=contiguous_stride(
                x.shape)) for x, pl in zip(flatten_up_to(specs, tree), pls))
        return tree_map(lambda _: next(it), specs)

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    res = {"rank": rank, "launches": {}, "fallbacks": {}, "seconds": {}}
    files, calls = {}, {}
    for dtype, path in (("bfloat16", "heads"), ("float32", "heads_check")):
        cfg = heads_config(dtype)
        model = build(cfg)
        gen = torch.Generator(device=dev).manual_seed(conf["seed"])
        params = init_params(model.param_specs, gen, device=dev)
        batch = {"tokens": toks}
        got, counts = {}, {}
        with Recorder(sharded_attention, "flash_attention") as rec, \
                staged_collectives(mesh), ReshardOnRefusal() as refusals:
            for part, r in (("train", rules["train"]),
                            ("prefill_kv_seq", rules["train"]),
                            ("prefill_heads", rules["heads"])):
                sh = make_sharder(r, mesh)
                dp = place(params, model.param_specs, r)
                db = place(batch, model.train_input_specs(b, s), r)
                reset_launches()
                t0 = time.perf_counter()
                if part == "train":
                    loss, grads = loss_and_grads(model, dp, db,
                                                 "dots_no_batch", sh)
                    out = [whole(loss)] + [whole(g) for g in
                                           tree_leaves(grads)]
                else:
                    logits, _ = model.prefill(dp, {"tokens": db["tokens"],
                                                   "max_len": s}, sh)
                    out = [whole(logits)]
                sync()
                res["seconds"][f"{path}/{part}"] = time.perf_counter() - t0
                counts[part] = dict(LAUNCHES)
                got[part] = out
                for k, v in sh.fallbacks.items():
                    res["fallbacks"][f"{path}/{part}/{k}"] = v
            for k, v in refusals.fallbacks.items():
                res["fallbacks"][f"{path}/refused/{k}"] = v
        res["launches"][path] = counts
        res[f"loss_{dtype}"] = float(got["train"][0])
        res[f"finite_{dtype}"] = all(bool(torch.isfinite(x).all())
                                     for v in got.values() for x in v)
        if rank == 0:  # the unsharded step and prefill
            loss, grads = loss_and_grads(model, params, batch,
                                         "dots_no_batch")
            want = {"train": [loss] + tree_leaves(grads)}
            logits, _ = model.prefill(params, {"tokens": toks,
                                               "max_len": s})
            want["prefill_kv_seq"] = want["prefill_heads"] = [logits]
            res[f"rel_{dtype}"] = {
                part: max(rel_err(g, w) for g, w in zip(got[part], want[part]))
                for part in got}
        calls[path] = [[[list(map(list, g[0])), [list(kv) for kv in g[1]],
                         list(g[2])], c]
                       for g, (c, _) in rec.calls.items()]
        for j, (_, (args, _)) in enumerate(rec.calls.values()):
            tensors_to_npz(f"{path}_g{j}", args, files)
        del params, model, got
    res["calls"] = calls
    return res, {f"inputs{rank}.npz": files}


def mesh_heads(seed, smi, stash, device="cuda"):
    """13f: ``heads_rank`` on 4 rank processes on ``cuda:0`` over gloo.
    Checks the sharded train step's loss and every gradient leaf, and the
    prefills' logits, against rank 0's unsharded path (relative error
    norms within ``heads_rtol``: float32 1e-5, bf16 2e-2), every rank's
    loss equal, no fallback (neither ``sh.fallbacks`` nor a refusal), and
    the #7 launches per rank: the train step's ``heads_layers`` forwards
    and their remat recomputes, and the heads prefill's, on the ranks
    that hold heads and none on the one that holds none; the kv_seq
    prefill's on every rank. Fills ``stash["heads"]`` and
    ``stash["heads_check"]`` with every rank's #7 inputs; returns the
    paths' launches."""
    import shutil
    import numpy as np
    from repro_torch.models.sharded_attention import head_chunks
    n = P13["ranks"]
    shutil.rmtree(HEADS_DIR, ignore_errors=True)
    HEADS_DIR.mkdir(parents=True)
    cfg = heads_config("bfloat16")
    b, s = P13["heads_batch"], P13["heads_seq"]
    from repro_torch.configs import get_config
    log(f"phase 13f: {describe(cfg)} (depth cut to {cfg.n_layers} of "
        f"{get_config(P13['heads_arch']).n_layers}); {n} ranks on mesh (1, "
        f"{n}) under the production rules, parameters and batch as "
        f"DTensors; a train step of {b} x {s} tokens, prefills of the "
        f"same into {s} slots")
    (HEADS_DIR / "config.json").write_text(json.dumps(
        dict(phase="phase 13f", backend="gloo", seed=seed, device=device,
             ranks=n, dir=str(HEADS_DIR))))
    t_ranks = run_ranks(n, HEADS_DIR, timeout=300)
    res = [json.loads((HEADS_DIR / f"rank{r}.json").read_text())
           for r in range(n)]
    for dtype in ("float32", "bfloat16"):
        for part, rel in res[0][f"rel_{dtype}"].items():
            if not rel <= P13["heads_rtol"][dtype]:
                raise AssertionError(f"phase 13f: {dtype} {part} vs the "
                                     f"unsharded path's: {rel}")
        for x in res:
            if not x[f"finite_{dtype}"] or \
                    x[f"loss_{dtype}"] != res[0][f"loss_{dtype}"]:
                raise AssertionError(f"phase 13f rank {x['rank']}: {dtype} "
                                     "non-finite, or a loss not rank 0's")
    for x in res:
        if x["fallbacks"]:
            raise AssertionError(f"phase 13f rank {x['rank']}: fallbacks "
                                 f"{x['fallbacks']}")
    heads = head_chunks(cfg.n_heads, n)
    want = [{"train": 2 * cfg.n_layers * (hi > lo),
             "prefill_kv_seq": cfg.n_layers,
             "prefill_heads": cfg.n_layers * (hi > lo)} for lo, hi in heads]
    launches = {}
    for path in ("heads", "heads_check"):
        for r, x in enumerate(res):
            for part, got in x["launches"][path].items():
                others = {k: v for k, v in got.items()
                          if v and k != "flash_attention"}
                if device == "cuda" and (others or got["flash_attention"]
                                         != want[r][part]):
                    raise AssertionError(
                        f"phase 13f rank {r} {path} {part}: launches {got}, "
                        f"want {want[r][part]} of #7 only")
        launches[path] = {k: sum(x["launches"][path][part][k] for x in res
                                 for part in x["launches"][path])
                          for k in res[0]["launches"][path]["train"]}
        recs = {name: Recorded() for name in wrapper_sites()}
        recs["probe_stack"], recs["combine_rows"] = Recorded(), Recorded()
        for x in res:
            arrays = dict(np.load(HEADS_DIR / f"inputs{x['rank']}.npz"))
            for j, (g, c) in enumerate(x["calls"][path]):
                key = (tuple(tuple(d) for d in g[0]),
                       tuple(tuple(kv) for kv in g[1]), tuple(g[2]))
                if key in recs["flash_attention"].calls:
                    recs["flash_attention"].calls[key][0] += c
                    continue
                args = tensors_from_npz(f"{path}_g{j}", arrays, device)
                recs["flash_attention"].calls[key] = [c, (args,
                                                          dict(key[1]))]
        stash[path] = recs
    log(f"phase 13f ({smi}): {n} ranks on {device} over gloo, {t_ranks:.3f}"
        f" s from start to exit; vs rank 0's unsharded path, relative "
        f"error norms (loss and every gradient leaf, then the logits): "
        f"float32 " + json.dumps(res[0]["rel_float32"]) + " (limit "
        f"{P13['heads_rtol']['float32']:g}), bf16 "
        + json.dumps(res[0]["rel_bfloat16"]) + f" (limit "
        f"{P13['heads_rtol']['bfloat16']:g}); no fallback; heads by rank "
        + json.dumps([hi - lo for lo, hi in heads]) + "; #7 launches by "
        "rank (bf16; train, prefill kv_seq, prefill heads) "
        + json.dumps([[x["launches"]["heads"][p]["flash_attention"]
                       for p in ("train", "prefill_kv_seq",
                                 "prefill_heads")] for x in res])
        + f"; geometries {len(stash['heads']['flash_attention'].calls)}; "
        "rank 0's seconds by part " + json.dumps(
            {k: round(v, 3) for k, v in res[0]["seconds"].items()}))
    shutil.rmtree(HEADS_DIR, ignore_errors=True)
    return launches


def mesh_config(arch, dtype):
    """13g's and 13h's config of ``arch``: full width, ``mesh_layers`` layers a
    stack (the hybrid: one group, its Mamba2 layers and one application of the
    shared attention), MoE at ``capacity_factor = n_experts /
    experts_per_token`` (the expert-parallel prefill drops no token)."""
    import dataclasses
    from repro_torch.configs import get_config, get_reduced
    cfg = (get_reduced if P13["reduced"] else get_config)(arch)
    kw = {"n_layers": P13["mesh_layers"]}
    if cfg.family == "hybrid":
        kw["n_layers"] = cfg.shared_attn_every
    if cfg.family == "encdec":
        kw["n_enc_layers"] = P13["mesh_layers"]
    if cfg.n_experts:
        kw["capacity_factor"] = cfg.n_experts / cfg.experts_per_token
    return dataclasses.replace(cfg, param_dtype=dtype, **kw)


def serve_rank(conf, rank, dev, out_dir):
    """Phase 13g on one rank: ``conf["archs"]`` (``serve_archs``) in bf16
    and float32 and ``conf["f32_archs"]`` (``serve_f32_archs``) in float32
    only, served on mesh (1, 4) under the production rules (``launch.dryrun.
    rules_for``: ``model``, ``kv_seq`` and the experts on the 4-wide
    axis), the parameters and the batch DTensors on the rank's device (a
    CUDA mesh over gloo: DTensor's collectives go through pinned host
    buffers), as a user calls the model: no ``ReshardOnRefusal``, so an op
    that DTensor refuses raises.
    Each config a prefill of ``serve_batch`` x ``serve_prompt`` tokens
    (whisper with its 1,500 seeded frames) into ``serve_prompt +
    serve_decode`` slots, then ``serve_decode`` decode steps of seeded
    tokens, each step's logits and the final state gathered whole. bf16
    (path ``mesh_serve``) and float32 (``mesh_serve_check``); rank 0 runs
    the unsharded path too. Returns (result dict, {file: this rank's #7
    inputs per geometry})."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.models import (build, init_params, make_sharder,
                                    sharded_attention, sharding_tree)
    from repro_torch.models.api import prefix_input
    from repro_torch.models.spec import (contiguous_stride, flatten_up_to,
                                         local_block, staged_collectives,
                                         tree_map)
    n = conf["ranks"]
    mesh = init_device_mesh(dev.type, (1, n),
                            mesh_dim_names=("data", "model"))
    rules = rules_for(False)
    b, s, new = P13["serve_batch"], P13["serve_prompt"], P13["serve_decode"]

    def place(tree, specs):
        """Each rank's block of the full values (the same on every rank),
        as DTensors placed by the rules: no exchange."""
        pls = flatten_up_to(specs, sharding_tree(specs, rules, mesh))
        it = iter(DTensor.from_local(
            local_block(x, pl, mesh).contiguous(), mesh, pl,
            run_check=False, shape=x.shape, stride=contiguous_stride(
                x.shape)) for x, pl in zip(flatten_up_to(specs, tree), pls))
        return tree_map(lambda _: next(it), specs)

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def leaves(state):
        if isinstance(state, (tuple, list)):
            return [x for y in state for x in leaves(y)]
        return [state]

    def serve(model, params, batch, toks, sh, place_token):
        """The prefill, then a decode step per column of ``toks``: (the
        logits [B, 1 + steps, V], the final state's leaves), gathered."""
        logits, *state = model.prefill(params, dict(batch, max_len=s + new),
                                       sh)
        out = [whole(logits)]
        for t in range(toks.shape[1]):
            step = {"token": place_token(toks[:, t:t + 1]),
                    "cache": state[0]}
            if model.cfg.family == "encdec":
                step["cross"] = state[1]
            if model.cfg.family != "ssm":
                step["pos"] = s + t
            logits, state[0] = model.decode(params, step, sh)
            out.append(whole(logits))
        return torch.cat(out, 1), [whole(x) for x in leaves(state)]

    def parts(out):
        """A serve's output as the compared parts: the prefill's logits,
        the decode steps', the final state's leaves."""
        return {"prefill": [out[0][:, :1]], "decode": [out[0][:, 1:]],
                "state": out[1]}

    res = {"rank": rank, "launches": {}, "fallbacks": {}, "seconds": {},
           "rel": {}, "rows": {}, "floor": {}, "sums": {}, "finite": {}}
    files, calls, bf16 = {}, {}, {}
    for dtype, path, archs in (
            ("bfloat16", "mesh_serve", conf["archs"]),
            ("float32", "mesh_serve_check",
             conf["archs"] + conf["f32_archs"])):
        counts = {}
        with Recorder(sharded_attention, "flash_attention") as rec, \
                staged_collectives(mesh):
            for arch in archs:
                cfg = mesh_config(arch, dtype)
                model = build(cfg)
                rng = np.random.default_rng(conf["seed"])
                toks = torch.as_tensor(rng.integers(
                    1, cfg.vocab, (b, s + new)).astype(np.int32), device=dev)
                batch = {"tokens": toks[:, :s]}
                prefix = prefix_input(cfg)
                if prefix is not None:
                    batch[prefix[0]] = torch.as_tensor(rng.normal(
                        size=(b, prefix[1], cfg.d_model)) * 0.02,
                        dtype=cfg.dtype, device=dev)
                gen = torch.Generator(device=dev).manual_seed(conf["seed"])
                params = init_params(model.param_specs, gen, device=dev)
                sh = make_sharder(rules, mesh)
                dp = place(params, model.param_specs)
                db = place(batch, model.prefill_input_specs(b, s))
                token_spec = {"token": model.decode_input_specs(
                    b, s + new)["token"]}
                if rank != 0:
                    del params
                reset_launches()
                t0 = time.perf_counter()
                got = serve(model, dp, db, toks[:, s:], sh, lambda t: place(
                    {"token": t}, token_spec)["token"])
                sync()
                res["seconds"][f"{path}/{arch}"] = time.perf_counter() - t0
                counts[arch] = dict(LAUNCHES)
                for k, v in sh.fallbacks.items():
                    res["fallbacks"][f"{path}/{arch}/{k}"] = v
                res["finite"][f"{path}/{arch}"] = all(
                    bool(torch.isfinite(x.float()).all())
                    for x in [got[0]] + got[1])
                res["sums"][f"{path}/{arch}"] = [
                    float(x.double().sum()) for x in [got[0]] + got[1]]
                if rank == 0:  # the unsharded path on the same weights
                    want = parts(serve(model, params, batch, toks[:, s:],
                                       None, lambda t: t))
                    got = parts(got)
                    lim = P13["serve_rtol"][dtype]
                    res["rel"][f"{dtype}/{arch}"] = {
                        k: max(rel_err(g, w) for g, w in zip(got[k], want[k]))
                        for k in got}
                    res["rows"][f"{dtype}/{arch}"] = {
                        k: row_errs(got[k], want[k], lim) for k in got}
                    if dtype == "bfloat16":  # for the float32 pass
                        bf16[arch] = {k: [x.cpu() for x in v]
                                      for k, v in want.items()}
                    elif arch in bf16:  # how far bf16 is from float32
                        lim = P13["serve_rtol"]["bfloat16"]
                        res["floor"][arch] = {
                            k: row_errs(bf16[arch][k], want[k], lim)
                            for k in want}
                    del params, want
                del dp, db, got, model
                free_card()
        res["launches"][path] = counts
        calls[path] = [[[list(map(list, g[0])), [list(kv) for kv in g[1]],
                         list(g[2])], c]
                       for g, (c, _) in rec.calls.items()]
        for j, (_, (args, _)) in enumerate(rec.calls.values()):
            tensors_to_npz(f"{path}_g{j}", args, files)
    res["calls"] = calls
    return res, {f"inputs{rank}.npz": files}


def row_errs(got, want, limit):
    """The relative error norm of each row (the last dim) of the tensors
    ``got`` against ``want``: [median, rows past ``limit``, rows]."""
    import torch
    errs = []
    for g, w in zip(got, want):
        g, w = (t.detach().float().cpu().flatten(0, -2) for t in (g, w))
        errs.append((g - w).norm(dim=1) / w.norm(dim=1).clamp_min(1e-30))
    errs = torch.cat(errs)
    return [float(errs.median()), int((errs > limit).sum()), errs.numel()]


def serve_launches(cfg):
    """#7's launches a rank in 13g's run of ``cfg``: the prefill's self
    attention and each decode step's once a layer over the rank's cache
    slots (the ``kv_seq`` case; a prompt below the blocked length), the
    enc-dec's encoder and its cross attention ("heads": the model axis
    divides whisper's 20 heads) once a layer each time they run."""
    steps = 1 + P13["serve_decode"]  # the prefill, then the decode steps
    if cfg.family == "hybrid":  # one application of the shared attention
        return steps
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers * steps
    return cfg.n_layers * steps


def mesh_serving(seed, smi, stash, device="cuda"):
    """13g: ``serve_rank`` on 4 rank processes on ``cuda:0`` over gloo.
    Checks each config's prefill logits, decode steps' logits and final
    state against rank 0's unsharded path (relative error norms within
    ``serve_rtol``: float32 1e-5), every rank's gathered values equal and
    finite, no fallback on any rank, and #7's launches a rank
    (``serve_launches``). bf16 is held by its median row (the last dim's
    vectors; the rows past the limit counted) within 2e-2, or within twice
    bf16's own distance from float32 (rank 0's unsharded bf16 path against
    its unsharded float32 path, median row) where that is larger: the
    sharded matmuls round otherwise than the unsharded ones, a difference
    that the SSM's recurrence carries on, and where a token's 8th and 9th
    expert are that close, its top 8 change, a discrete change of its
    output (float32 holds the whole at 1e-5). Fills
    ``stash["mesh_serve"]`` and ``stash["mesh_serve_check"]`` with every
    rank's #7 inputs; returns the paths' launches."""
    import shutil
    import numpy as np
    n = P13["ranks"]
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    SERVE_DIR.mkdir(parents=True)
    b, s, new = P13["serve_batch"], P13["serve_prompt"], P13["serve_decode"]
    log(f"phase 13g: {n} ranks on mesh (1, {n}) under the production rules, "
        f"parameters and batch as DTensors; each config a prefill of {b} x "
        f"{s} tokens into {s + new} slots, then {new} decode steps: "
        + "; ".join(describe(mesh_config(a, "bfloat16"))
                    for a in P13["serve_archs"]) + "; in float32 only: "
        + "; ".join(describe(mesh_config(a, "float32"))
                    for a in P13["serve_f32_archs"]))
    (SERVE_DIR / "config.json").write_text(json.dumps(
        dict(phase="phase 13g", backend="gloo", seed=seed, device=device,
             ranks=n, dir=str(SERVE_DIR), archs=P13["serve_archs"],
             f32_archs=P13["serve_f32_archs"])))
    t_ranks = run_ranks(n, SERVE_DIR, timeout=300)
    res = [json.loads((SERVE_DIR / f"rank{r}.json").read_text())
           for r in range(n)]
    for key, rel in res[0]["rel"].items():
        dtype, arch = key.split("/")
        for part, err in rel.items():
            if dtype == "float32":
                got, bound = err, P13["serve_rtol"][dtype]
            else:  # the median row; bf16's own distance from float32
                got = res[0]["rows"][key][part][0]
                bound = max(P13["serve_rtol"][dtype],
                            2 * res[0]["floor"][arch][part][0])
            if not got <= bound:
                raise AssertionError(
                    f"phase 13g: {key} {part} vs the unsharded path's: "
                    f"{got} (limit {bound}; error norm {err}, rows "
                    f"{res[0]['rows'][key][part]})")
    for x in res:
        if x["fallbacks"]:
            raise AssertionError(f"phase 13g rank {x['rank']}: fallbacks "
                                 f"{x['fallbacks']}")
        if not all(x["finite"].values()) or x["sums"] != res[0]["sums"]:
            raise AssertionError(f"phase 13g rank {x['rank']}: non-finite "
                                 "values, or values not rank 0's")
    launches = {}
    for path in ("mesh_serve", "mesh_serve_check"):
        for r, x in enumerate(res):
            for arch, got in x["launches"][path].items():
                want = serve_launches(mesh_config(arch, "float32"))
                others = {k: v for k, v in got.items()
                          if v and k != "flash_attention"}
                if device == "cuda" and (others or got["flash_attention"]
                                         != want):
                    raise AssertionError(
                        f"phase 13g rank {r} {path} {arch}: launches {got}, "
                        f"want {want} of #7 only")
        first = next(iter(res[0]["launches"][path].values()), {})
        launches[path] = {k: sum(x["launches"][path][a][k] for x in res
                                 for a in x["launches"][path])
                          for k in first}
        recs = {name: Recorded() for name in wrapper_sites()}
        recs["probe_stack"], recs["combine_rows"] = Recorded(), Recorded()
        for x in res:
            arrays = dict(np.load(SERVE_DIR / f"inputs{x['rank']}.npz"))
            for j, (g, c) in enumerate(x["calls"][path]):
                key = (tuple(tuple(d) for d in g[0]),
                       tuple(tuple(kv) for kv in g[1]), tuple(g[2]))
                if key in recs["flash_attention"].calls:
                    recs["flash_attention"].calls[key][0] += c
                    continue
                args = tensors_from_npz(f"{path}_g{j}", arrays, device)
                recs["flash_attention"].calls[key] = [c, (args,
                                                          dict(key[1]))]
        stash[path] = recs
    log(f"phase 13g ({smi}): {n} ranks on {device} over gloo, {t_ranks:.3f}"
        f" s from start to exit; vs rank 0's unsharded path, relative "
        f"error norms (prefill logits, decode logits, final state; limits "
        f"float32 {P13['serve_rtol']['float32']:g}, bf16 "
        f"{P13['serve_rtol']['bfloat16']:g}): " + json.dumps(res[0]["rel"])
        + "; by row (median, rows past the limit, rows): "
        + json.dumps(res[0]["rows"]) + "; bf16's own, unsharded against "
        "float32: " + json.dumps(res[0]["floor"])
        + "; no fallback; #7 launches a rank (bf16, float32) " + json.dumps(
            [{p: {a: v["flash_attention"]
                  for a, v in x["launches"][p].items()}
              for p in ("mesh_serve", "mesh_serve_check")} for x in res])
        + f"; geometries {len(stash['mesh_serve']['flash_attention'].calls)}"
        "; rank 0's seconds " + json.dumps(
            {k: round(v, 3) for k, v in res[0]["seconds"].items()}))
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    return launches


@contextlib.contextmanager
def float64_reference():
    """For a reference step run in float64 (parameters and float inputs
    cast): ``Tensor.float()`` keeps a float64 tensor float64 (the models
    upcast to float32 for their softmax, norms, loss and scan), and
    attention runs as #7's plain version, which has no float64 body."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models import layers
    upcast, kernel = torch.Tensor.float, layers.flash_attention
    torch.Tensor.float = (lambda t, *a, **kw: t if t.dtype == torch.float64
                          else upcast(t, *a, **kw))
    layers.flash_attention = flash_attention_ref
    try:
        yield
    finally:
        torch.Tensor.float, layers.flash_attention = upcast, kernel


@contextlib.contextmanager
def shard_aux(n_batch, n_seq):
    """For a reference step on one rank of an expert-parallel mesh step:
    the MoE layer dispatches locally over the whole batch (at the no-drop
    capacity its output is the expert-parallel one's) and takes its aux
    loss as the mean of the aux losses of the ``n_batch`` x ``n_seq``
    blocks of the tokens, the shards of the step on a mesh whose batch
    axes have ``n_batch`` ranks and whose model axis ``n_seq``, each block
    ``E * sum(mean probs * mean choices)`` of its own routing, as JAX's
    ``_apply_moe_spmd`` takes it (a mean of products: not the aux of the
    whole batch)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import moe
    from repro_torch.models.spec import no_sharding
    expert_parallel = moe.apply_moe

    def apply(cfg, p, x, sh=None):
        y, _ = moe._apply_moe_local(cfg, p, x, sh or no_sharding)
        e, aux = cfg.n_experts, []
        for xb in x.chunk(n_batch, 0):
            for xs in xb.chunk(n_seq, 1):
                r = moe.route(cfg, p["router"], xs.reshape(-1, x.shape[-1]))
                ce = F.one_hot(r.eidx, e).float().sum(1).mean(0)
                aux.append(e * torch.sum(r.probs.mean(0) * ce))
        return y, torch.stack(aux).mean()

    moe.apply_moe = apply
    try:
        yield
    finally:
        moe.apply_moe = expert_parallel


def train_launches(cfg):
    """#7's launches a rank in 13h's step of ``cfg``: each attention's
    forward and its remat recompute (``dots_no_batch``) once a layer on
    the rank's heads (the "heads" case: every rank holds heads of these
    configs on the 4-wide axis), the enc-dec's encoder, decoder self and
    cross attention, the hybrid's one application of the shared
    attention, none in an SSM."""
    per = {"ssm": 0, "hybrid": 1,
           "encdec": cfg.n_enc_layers + 2 * cfg.n_layers}
    return 2 * per.get(cfg.family, cfg.n_layers)


def train_rank(conf, rank, dev, out_dir):
    """Phase 13h on one rank: for each of ``conf["archs"]``
    (``train_archs``) one train step through ``train_step.
    loss_and_grads`` on mesh (1, 4) under the production rules
    (``launch.dryrun.rules_for``), the parameters and the batch DTensors
    on the rank's device (a CUDA mesh over gloo: DTensor's collectives go
    through pinned host buffers), as a user calls it: no
    ``ReshardOnRefusal``, so an op DTensor refuses raises. A batch of
    ``train_batch`` x ``train_seq`` positions (internvl2's 256 image
    embeddings among them, whisper's 1,500 seeded frames beside them),
    remat ``dots_no_batch``. The reference on the same weights: rank 0's
    unsharded step, for MoE with the aux loss of the mesh step
    (``shard_aux``: on a mesh it is the mean of the token shards' aux, as
    JAX's ``_apply_moe_spmd`` takes it, so the unsharded step is no
    reference). float32 (path ``mesh_train_check``), then bf16
    (``mesh_train``, the archs of ``conf["bf16_archs"]``). The loss and
    each gradient leaf are gathered whole on rank 0 one at a time, which
    holds each to the reference (relative error norm; for bf16 also the
    reference's own distance from float32's, and for a float32 config
    with a leaf past ``train_rtol`` float32's own distance from the
    reference run in float64) and every rank's copy of a replicated block
    to the first's, exactly. Returns (result dict,
    {file: this rank's #7 inputs per geometry})."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.models import (build, init_params, make_sharder,
                                    sharded_attention, sharding_tree)
    from repro_torch.models.api import prefix_input
    from repro_torch.models.spec import (contiguous_stride, flatten_up_to,
                                         local_block, staged_collectives,
                                         tree_leaves, tree_map)
    from repro_torch.train.train_step import loss_and_grads
    n = conf["ranks"]
    mesh = init_device_mesh(dev.type, (1, n),
                            mesh_dim_names=("data", "model"))
    rules = rules_for(False)
    b, s = P13["train_batch"], P13["train_seq"]

    def place(tree, specs):
        """Each rank's block of the full values (the same on every rank),
        as DTensors placed by the rules: no exchange."""
        pls = flatten_up_to(specs, sharding_tree(specs, rules, mesh))
        it = iter(DTensor.from_local(
            local_block(x, pl, mesh).contiguous(), mesh, pl,
            run_check=False, shape=x.shape, stride=contiguous_stride(
                x.shape)) for x, pl in zip(flatten_up_to(specs, tree), pls))
        return tree_map(lambda _: next(it), specs)

    coords = [(mesh.mesh == r).nonzero()[0].tolist() for r in range(n)]

    def gathered(t):
        """(``t`` whole on rank 0, None elsewhere; whether every rank's
        copy of a replicated block equals the first's): each rank's block
        goes to rank 0 once, as bytes by a gather on the host (where a
        full tensor would bring every rank every block)."""
        pl = ([Replicate()] * n if not isinstance(t, DTensor) else
              [Replicate() if isinstance(q, Partial) else q
               for q in t.placements])
        if isinstance(t, DTensor):
            if tuple(pl) != tuple(t.placements):
                t = t.redistribute(mesh, pl)
            local = t.to_local()
        else:
            local = t
        wire = local.detach().contiguous().cpu().reshape(-1).view(
            torch.uint8)
        parts = [torch.empty_like(wire) for _ in range(n)] if rank == 0 \
            else None
        dist.gather(wire, parts, dst=0)
        if rank:
            return None, True
        full = torch.empty(t.shape, dtype=t.dtype, device=dev)
        seen, equal = set(), True
        for r, part in enumerate(parts):
            block = full
            for i, q in enumerate(pl):
                if isinstance(q, Shard):
                    size = block.shape[q.dim] // mesh.shape[i]
                    block = block.narrow(q.dim, coords[r][i] * size, size)
            part = part.view(t.dtype).reshape(local.shape).to(dev)
            key = tuple(coords[r][i] if isinstance(q, Shard) else None
                        for i, q in enumerate(pl))
            if key in seen:
                equal &= bool(torch.equal(block, part))
            else:
                block.copy_(part)
                seen.add(key)
        return full, equal

    def rel(got, want):
        """||got - want|| / ||want|| in float32 on ``got``'s device."""
        g, w = got.detach().float(), want.detach().float().to(got.device)
        return float((g - w).norm() / w.norm().clamp_min(1e-30))

    res = {"rank": rank, "launches": {}, "fallbacks": {}, "seconds": {},
           "ref_seconds": {}, "parts": {}, "names": {}, "rel": {},
           "floor": {}, "finite": {}, "unequal": {}}
    files, calls, f32 = {}, {}, {}

    def reference_moe(cfg):
        """The MoE reference's aux: the mean over this mesh's token
        shards (none for the other families)."""
        if not cfg.n_experts:
            return contextlib.nullcontext()
        return shard_aux(mesh.shape[0], mesh.shape[1])

    for dtype, path, archs in (
            ("float32", "mesh_train_check", conf["archs"]),
            ("bfloat16", "mesh_train", conf["bf16_archs"])):
        counts = {}
        rec = Recorder(sharded_attention, "flash_attention")
        with staged_collectives(mesh):
            for arch in archs:
                key = f"{dtype}/{arch}"
                cfg = mesh_config(arch, dtype)
                model = build(cfg)
                rng = np.random.default_rng(conf["seed"])
                prefix = prefix_input(cfg)
                n_img = prefix[1] if cfg.family == "vlm" else 0
                batch = {"tokens": torch.as_tensor(rng.integers(
                    1, cfg.vocab, (b, s - n_img)).astype(np.int32),
                    device=dev)}
                if prefix is not None:
                    batch[prefix[0]] = torch.as_tensor(rng.normal(
                        size=(b, prefix[1], cfg.d_model)) * 0.02,
                        dtype=cfg.dtype, device=dev)
                t0 = time.perf_counter()
                gen = torch.Generator(device=dev).manual_seed(conf["seed"])
                params = init_params(model.param_specs, gen, device=dev)
                sh = make_sharder(rules, mesh)
                want, part = None, {}
                if rank == 0:  # the reference
                    t1 = time.perf_counter()
                    with reference_moe(cfg):
                        loss, grads = loss_and_grads(model, params, batch,
                                                     "dots_no_batch")
                    want = [loss] + tree_leaves(grads)
                    res["names"][arch] = ["loss"] + leaf_names(grads)
                    del loss, grads
                    sync()
                    res["ref_seconds"][key] = time.perf_counter() - t1
                dp = place(params, model.param_specs)
                db = place(batch, model.train_input_specs(b, s))
                if rank:
                    del params
                sync()
                part["init_ref_place"] = time.perf_counter() - t0
                reset_launches()
                t0 = time.perf_counter()
                with rec:
                    loss, grads = loss_and_grads(model, dp, db,
                                                 "dots_no_batch", sh)
                sync()
                res["seconds"][key] = time.perf_counter() - t0
                counts[arch] = dict(LAUNCHES)
                for k, v in sh.fallbacks.items():
                    res["fallbacks"][f"{key}/{k}"] = v
                got = [loss] + tree_leaves(grads)
                del dp, db, loss, grads
                t0 = time.perf_counter()
                finite, errs, floor, unequal = True, [], [], []
                for i in range(len(got)):  # one whole leaf at a time
                    g, equal = gathered(got[i])
                    got[i] = None
                    if rank:
                        continue
                    finite &= bool(torch.isfinite(g).all())
                    if not equal:
                        unequal.append(res["names"][arch][i])
                    errs.append(rel(g, want[i]))
                    if dtype == "float32" and arch in conf["bf16_archs"]:
                        f32.setdefault(arch, []).append(want[i].cpu())
                    elif dtype == "bfloat16":
                        floor.append(rel(want[i], f32[arch][i]))
                        f32[arch][i] = None
                    del g
                part["gather_compare"] = time.perf_counter() - t0
                res["parts"][key] = part
                if rank == 0:
                    res["finite"][key], res["unequal"][key] = finite, unequal
                    res["rel"][key] = errs
                    if floor:
                        res["floor"][arch] = floor
                if dtype == "float32" and rank == 0 and \
                        max(errs) > P13["train_rtol"]["float32"]:
                    # float32's own distance from float64 for each leaf
                    t0 = time.perf_counter()
                    with float64_reference(), reference_moe(cfg):
                        loss, grads = loss_and_grads(
                            model, tree_map(torch.Tensor.double, params),
                            {k: x if k == "tokens" else x.double()
                             for k, x in batch.items()}, "dots_no_batch")
                    res["floor"][f"float64/{arch}"] = [
                        rel(w, g) for w, g in zip(
                            want, [loss] + tree_leaves(grads))]
                    del loss, grads
                    sync()
                    res["ref_seconds"][f"float64/{arch}"] = \
                        time.perf_counter() - t0
                del got, want, model
                params = None
                free_card()
        res["launches"][path] = counts
        calls[path] = [[[list(map(list, g[0])), [list(kv) for kv in g[1]],
                         list(g[2])], c]
                       for g, (c, _) in rec.calls.items()]
        for j, (_, (args, _)) in enumerate(rec.calls.values()):
            tensors_to_npz(f"{path}_g{j}", args, files)
    res["calls"] = calls
    return res, {f"inputs{rank}.npz": files}


def mesh_training(seed, smi, stash, device="cuda"):
    """13h: ``train_rank`` on 4 rank processes on ``cuda:0`` over gloo. Checks
    the loss and every gradient leaf of each config's DTensor step against its
    reference (relative error norms within ``train_rtol``: float32 1e-5, bf16
    2e-2; or, where it is larger, twice the reference's own distance for that
    leaf from the same step in a wider type: bf16's from the float32 reference,
    and for a config with a float32 leaf past 1e-5, float32's from the
    reference run in float64 (13g's rule: the sharded matmuls add in another
    order than the unsharded ones; a token's top 8 experts flip on a bf16
    rounding, and the gradient of Mamba2's decay, a sum over every position
    with cancellation, carries float32's rounding up to ~4e-5 of its norm),
    every value finite and every replicated block equal across ranks, no
    fallback on any rank, and #7's launches a rank (``train_launches``). Fills
    ``stash["mesh_train"]`` and ``stash["mesh_train_check"]`` with every rank's
    #7 inputs; returns the paths' launches."""
    import shutil
    import numpy as np
    n = P13["ranks"]
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir(parents=True)
    b, s = P13["train_batch"], P13["train_seq"]
    archs = P13["train_archs"]
    bf16_archs = P13["train_bf16_archs"]
    log(f"phase 13h: {n} ranks on mesh (1, {n}) under the production rules, "
        f"parameters and batch as DTensors; each config one train step "
        f"(loss_and_grads, remat dots_no_batch) of {b} x {s} positions, "
        f"float32 (" + ", ".join(archs) + "), then bf16 ("
        + ", ".join(bf16_archs) + "): "
        + "; ".join(describe(mesh_config(a, "bfloat16")) for a in archs))
    (TRAIN_DIR / "config.json").write_text(json.dumps(
        dict(phase="phase 13h", backend="gloo", seed=seed, device=device,
             ranks=n, dir=str(TRAIN_DIR), archs=archs,
             bf16_archs=bf16_archs)))
    t_ranks = run_ranks(n, TRAIN_DIR, timeout=300)
    res = [json.loads((TRAIN_DIR / f"rank{r}.json").read_text())
           for r in range(n)]
    worst = {}
    for key, errs in res[0]["rel"].items():
        dtype, arch = key.split("/")
        lim = P13["train_rtol"][dtype]
        own = res[0]["floor"].get(arch if dtype == "bfloat16" else
                                  f"float64/{arch}", [0.0] * len(errs))
        bounds = [max(lim, 2 * f) for f in own]
        i = int(np.argmax(np.array(errs) / np.array(bounds)))
        worst[key] = [res[0]["names"][arch][i], errs[i], bounds[i], errs[0]]
        if not errs[i] <= bounds[i]:
            raise AssertionError(
                f"phase 13h: {key} {res[0]['names'][arch][i]} vs the "
                f"reference's: {errs[i]} (limit {bounds[i]}); every leaf "
                + json.dumps(dict(zip(res[0]["names"][arch], errs))))
    for x in res:
        if x["fallbacks"]:
            raise AssertionError(f"phase 13h rank {x['rank']}: fallbacks "
                                 f"{x['fallbacks']}")
    if not all(res[0]["finite"].values()) or any(res[0]["unequal"].values()):
        raise AssertionError("phase 13h: non-finite values, or a replicated "
                             "block that differs between ranks: "
                             + json.dumps(res[0]["unequal"]))
    launches = {}
    for path in ("mesh_train", "mesh_train_check"):
        for r, x in enumerate(res):
            for arch, got in x["launches"][path].items():
                want = train_launches(mesh_config(arch, "float32"))
                others = {k: v for k, v in got.items()
                          if v and k != "flash_attention"}
                if device == "cuda" and (others or got["flash_attention"]
                                         != want):
                    raise AssertionError(
                        f"phase 13h rank {r} {path} {arch}: launches {got}, "
                        f"want {want} of #7 only")
        first = next(iter(res[0]["launches"][path].values()), {})
        launches[path] = {k: sum(a[k] for x in res
                                 for a in x["launches"][path].values())
                          for k in first}
        recs = {name: Recorded() for name in wrapper_sites()}
        recs["probe_stack"], recs["combine_rows"] = Recorded(), Recorded()
        for x in res:
            arrays = dict(np.load(TRAIN_DIR / f"inputs{x['rank']}.npz"))
            for j, (g, c) in enumerate(x["calls"][path]):
                key = (tuple(tuple(d) for d in g[0]),
                       tuple(tuple(kv) for kv in g[1]), tuple(g[2]))
                if key in recs["flash_attention"].calls:
                    recs["flash_attention"].calls[key][0] += c
                    continue
                args = tensors_from_npz(f"{path}_g{j}", arrays, device)
                recs["flash_attention"].calls[key] = [c, (args,
                                                          dict(key[1]))]
        stash[path] = recs
    floor = {a: max(v) for a, v in res[0]["floor"].items()}
    ref_s = {k: round(v, 3) for k, v in res[0]["ref_seconds"].items()}
    log(f"phase 13h ({smi}): {n} ranks on {device} over gloo, {t_ranks:.3f}"
        f" s from start to exit; vs the reference (rank 0's unsharded "
        f"step, for MoE with the token shards' mean aux), the leaf nearest "
        f"its limit [leaf, relative error norm, limit, the loss's error] "
        f"(float32 "
        f"{P13['train_rtol']['float32']:g}; bf16 "
        f"{P13['train_rtol']['bfloat16']:g} or twice bf16's own): "
        + json.dumps(worst)
        + "; the reference's own distance from the wider type's (bf16 from "
        "float32; float64/: float32 from float64), worst leaf: "
        + json.dumps(floor) + "; no fallback; every replicated block "
        "equal across ranks; #7 launches a rank (bf16, float32) "
        + json.dumps([{p: {a: v["flash_attention"]
                           for a, v in x["launches"][p].items()}
                       for p in ("mesh_train", "mesh_train_check")}
                      for x in res])
        + f"; geometries {len(stash['mesh_train']['flash_attention'].calls)}"
        "; rank 0's seconds (the DTensor step) " + json.dumps(
            {k: round(v, 3) for k, v in res[0]["seconds"].items()})
        + ", (the reference) " + json.dumps(ref_s) + "; rank 0's seconds "
        "by part " + json.dumps({k: {p: round(v, 3) for p, v in x.items()}
                                 for k, x in res[0]["parts"].items()}))
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return launches


def attention_work(args, kw):
    """(bytes, flops) of one #7 forward call on ``args`` / ``kw``
    (``kernels.flash_attention.attention_cost``, the formula ``OpCost``
    counts the op by): q read and o written once (and lse when asked
    for), of K and V only the keys some row may see (the causal limit of
    the last row); four flops per (row, key, dim) pair kept by the mask
    (q.k and p.v, multiply + add)."""
    from repro_torch.kernels.flash_attention import attention_cost
    q, k = args[:2]
    return attention_cost(q.shape, k.shape, kw.get("causal", True),
                          kw.get("q_offset", 0), q.element_size(),
                          kw.get("return_lse", False))


def cost_step(seed, smi, stash, device="cuda"):
    """13b: phase 10's smollm-135m train step (``P10``'s batch, full width)
    once under ``launch.op_cost.OpCost`` (#7's forward is a registered op
    the counter sees and counts by its causal triangle; its backward is
    plain ops), then timed uncounted; the counted roofline against the
    measured step, and the step's model-FLOPs share. Returns the counted
    run's launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.launch import analysis
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models import build, init_params
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step

    cfg = (get_reduced if P10["reduced"] else get_config)(P10["arch"])
    model = build(cfg)
    b, s = P10["batch"], P10["seq"]
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(model.param_specs, gen, device=device)
    opt_cfg = AdamWConfig()
    opt = adamw_init(params, opt_cfg)
    step = make_train_step(model, opt_cfg, remat="dots_no_batch")
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(rng.integers(1, cfg.vocab, (b, s))
                                       .astype(np.int32), device=device)}
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    with kernel_run(stash) as launches:
        with OpCost() as counter:
            params, opt, loss = step(params, opt, batch)
        loss = float(loss)
    if device == "cuda" and (launches["flash_attention"] != 2 * cfg.n_layers
                             or sum(launches.values())
                             != launches["flash_attention"]):
        raise AssertionError(f"phase 13b: launches {launches}, want "
                             f"{2 * cfg.n_layers} of flash_attention only")
    cost = counter.cost
    calls, attn_flops, _ = counter.by_op.get("repro_torch.flash_attention",
                                             (0, 0, 0.0))
    if device == "cuda" and calls != launches["flash_attention"]:
        raise AssertionError(f"phase 13b: OpCost saw {calls} #7 calls, "
                             f"{launches['flash_attention']} launched")
    peak = (torch.cuda.max_memory_allocated() - held if device == "cuda"
            else 0)
    mflops = analysis.model_flops_for(cfg, "train", s, b)
    roof = analysis.analyze(cost, 1, mflops, peak)
    if not math.isfinite(loss) or cost.flops < mflops:
        raise AssertionError(f"phase 13b: loss {loss}, counted flops "
                             f"{cost.flops} below the model's {mflops}")
    step(params, opt, batch)  # uncounted, warm
    times = []
    for _ in range(P13["timed_steps"]):
        t0 = clock()
        params, opt, loss_t = step(params, opt, batch)
        float(loss_t)
        times.append(clock() - t0)
    t = float(np.median(times))
    share = mflops / (t * analysis.PEAK_FLOPS)
    log(f"phase 13b ({smi}): {cfg.name} train step, {b} x {s} tokens, remat "
        f"dots_no_batch, counted by op_cost: "
        + json.dumps({"flops": cost.flops, "attention_calls": calls,
                      "attention_flops": attn_flops,
                      "bytes": cost.bytes, "bytes_ideal": cost.bytes_ideal,
                      "roofline_bytes": roof.bytes_per_device,
                      "compute_ms": roof.compute_s * 1e3,
                      "memory_ms": roof.memory_s * 1e3,
                      "bottleneck": roof.bottleneck,
                      "model_flops": mflops,
                      "useful_ratio": roof.useful_ratio,
                      "peak_mem_gb": peak / 1e9,
                      "ops": len(counter.by_op)}))
    log(f"phase 13b ({smi}): measured step {t * 1e3:.3f} ms median of "
        f"{len(times)} (" + ", ".join(f"{x * 1e3:.3f}" for x in times)
        + f" ms); roofline compute {roof.compute_s * 1e3:.3f} ms, memory "
        f"{roof.memory_s * 1e3:.3f} ms; model-FLOPs share "
        f"{mflops:.6g} / ({t:.6g} s x {analysis.PEAK_FLOPS:g}) = {share:.4f}")
    top = sorted(counter.by_op.items(), key=lambda kv: -kv[1][2])[:6]
    log("phase 13b: the counted ops moving the most bytes (calls, flops, "
        "bytes): " + json.dumps(dict(top)))
    return launches


DRY_RUNS = {
    "dryrun_single": [sys.executable, "-c",
                      "import json; from repro_torch.launch.dryrun import "
                      "run_cell; print('RECORD ' + json.dumps(run_cell("
                      "'smollm-135m', 'decode_32k', False)))"],
    "dryrun_multi": [sys.executable, "-c",
                     "import json; from repro_torch.launch.dryrun import "
                     "run_cell; print('RECORD ' + json.dumps(run_cell("
                     "'smollm-135m', 'decode_32k', True)))"],
    "ingest": [sys.executable, "-m", "repro_torch.launch.ingest", "--dryrun",
               "--mesh", "single"],
}


def dry_runs_start():
    """13c: the dry runs, each in a process of its own (a fake world is
    process-wide), on the host's CPU while 13a and 13b use the card."""
    import os
    EP_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = {}
    for name, cmd in DRY_RUNS.items():
        out = open(EP_DIR.parent / f"phase13_{name}.log", "w")
        procs[name] = (subprocess.Popen(cmd, stdout=out,
                                        stderr=subprocess.STDOUT, env=env,
                                        cwd=str(ROOT)), out)
    return procs, time.perf_counter()


def dry_runs_finish(procs, t0, smi, timeout=300):
    """Wait for 13c's processes and check their records."""
    recs = {}
    try:
        for name, (p, out) in procs.items():
            code = p.wait(timeout=max(1.0, timeout - (time.perf_counter()
                                                      - t0)))
            out.close()
            text = (EP_DIR.parent / f"phase13_{name}.log").read_text()
            if code != 0:
                raise AssertionError(f"phase 13c {name}: exit {code}: "
                                     + text[-3000:])
            recs[name] = text
    finally:
        for p, out in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
    summary = {}
    for name, multi in (("dryrun_single", False), ("dryrun_multi", True)):
        line = [x for x in recs[name].splitlines()
                if x.startswith("RECORD ")][-1]
        r = json.loads(line[len("RECORD "):])
        if r["chips"] != (512 if multi else 256) or \
                not r["flops_per_device"] > 0 or r["collective_s"] < 0 or \
                r["bottleneck"] not in ("compute", "memory", "collective") \
                or not r["hbm_bytes_per_device"] < 80e9:
            raise AssertionError(f"phase 13c {name}: {r}")
        summary[r["mesh"]] = {k: r[k] for k in (
            "chips", "trace_s", "flops_per_device", "bytes_per_device",
            "arg_bytes", "temp_bytes", "hbm_bytes_per_device", "compute_s",
            "memory_s", "collective_s", "bottleneck", "useful_ratio",
            "collective_counts")}
    ingest = [x for x in recs["ingest"].splitlines()
              if "ingest dry-run" in x][-1]
    if "colls={'all-to-all': 1}" not in ingest:
        raise AssertionError(f"phase 13c ingest: {ingest}")
    log(f"phase 13c: smollm-135m decode_32k dry runs (a fake world on the "
        f"host's CPU, its terms from the H100 data-sheet peaks in "
        f"launch.analysis; this card: {smi}): " + json.dumps(summary))
    log(f"phase 13c: {ingest}; {time.perf_counter() - t0:.3f} s for the "
        f"three")


def launch_tools(seed, smi, stash, device="cuda"):
    """Phase 13: the dry runs started on the CPU, then 13a, 13b and 13d-13g
    on the card, then the dry runs' records. Returns launches by path."""
    procs, t0 = dry_runs_start()
    try:
        t = {}
        ta = time.perf_counter()
        launches = moe_expert_parallel(seed, smi, stash, device)
        t["a"] = time.perf_counter() - ta
        free_card()
        tb = time.perf_counter()
        launches["cost_step"] = cost_step(seed, smi, stash["cost_step"],
                                          device)
        t["b"] = time.perf_counter() - tb
        free_card()
        td = time.perf_counter()
        launches.update(context_parallel(seed, smi, stash, device))
        t["d"] = time.perf_counter() - td
        te = time.perf_counter()
        launches["small"] = small_heads(seed, smi, stash["small"], device)
        launches.update(wide_gqa(seed, smi, stash, device))
        t["e"] = time.perf_counter() - te
        free_card()
        tf = time.perf_counter()
        launches.update(mesh_heads(seed, smi, stash, device))
        t["f"] = time.perf_counter() - tf
        free_card()
        tg = time.perf_counter()
        launches.update(mesh_serving(seed, smi, stash, device))
        t["g"] = time.perf_counter() - tg
        free_card()
        th = time.perf_counter()
        launches.update(mesh_training(seed, smi, stash, device))
        t["h"] = time.perf_counter() - th
        log(f"phase 13h: {t['h']:.3f} s")
        tc = time.perf_counter()
        dry_runs_finish(procs, t0, smi)
        t["c_wait"] = time.perf_counter() - tc
    finally:
        for p, out in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
    log("phase 13 by part (s): " + json.dumps(t))
    return launches


# ------------------------------------------------------------------ phase 14
# qwen2.5-3b whole on the card (36 layers, bf16, the seeded init drawn on
# the card): (a) served, (b) trained with microbatches, (c) one step's
# gradients and the int8 AdamW moments against the CPU's; (d) on the
# DTensor mesh, in 13g and 13h (``P13``'s archs)
P14 = dict(arch="qwen2.5-3b", reduced=False, long_requests=4,
           long_prompt=1920, long_new=128, long_max_len=2048, cpu_layers=2,
           train_steps=3, train_batch=4, train_seq=512, microbatches=2,
           grad_layers=2, grad_batch=2, grad_seq=256)


def p14_config(**kw):
    import dataclasses
    from repro_torch.configs import get_config, get_reduced
    cfg = (get_reduced if P14["reduced"] else get_config)(P14["arch"])
    return dataclasses.replace(cfg, **kw) if kw else cfg


def spec_bytes(specs):
    from repro_torch.models.spec import tree_leaves
    return sum(math.prod(s.shape) * s.dtype.itemsize
               for s in tree_leaves(specs))


def qwen_serving(seed, smi, stash, device="cuda"):
    """14a: qwen2.5-3b at full width and depth in bf16: run a through
    ``repro_torch.launch.serve.main`` with its defaults (8 requests of 4-23
    tokens, 16 new each, 4 slots, max_len 128; path ``qwen_a``), run b one
    batch of ``long_requests`` x ``long_prompt`` tokens, ``long_new`` new
    tokens each, at ``long_max_len`` through ``Engine`` (weights drawn on
    the card; path ``qwen_b``): every request yields its tokens, every
    logit finite, self-attention only on #7 (``n_layers`` launches a
    forward; 16 heads over 2 KV heads at hd 128, GQA rep 8). Then
    prefill-then-decode against the full prefill on run b's weights
    (bf16: within 5e-2, phase 6's rule) and, at ``cpu_layers`` layers in
    float32, the card's prefill against the CPU's (relative error norm
    within 1e-3, phase 12's rule). Returns (stats, launches by path)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import build, init_params, param_count, transformer
    from repro_torch.serve import Engine, Request

    cfg = p14_config()
    model = build(cfg)
    n_layers, new = cfg.n_layers, P14["long_new"]
    log(f"phase 14a: {describe(cfg)}, QKV biases, tied table (padded "
        f"{cfg.vocab_padded}); {param_count(model.param_specs) / 1e9:.3f} B "
        f"parameters")
    for path in ("qwen_a", "qwen_b"):
        stash.setdefault(path, {})
    stats, launches = {}, {}
    argv = ["--arch", P14["arch"], "--seed", str(seed), "--device",
            str(device)] + (["--reduced"] if P14["reduced"] else [])
    held = peak_reset()
    with kernel_run(stash["qwen_a"]) as launches["qwen_a"]:
        stats["qwen_a"] = launch_serve.main(argv)
    free_card()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(model.param_specs, gen, device=device)
    stats["init_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, P14["long_prompt"])
                    .astype(np.int32), max_new=new)
            for _ in range(P14["long_requests"])]
    engine = Engine(model, params, batch_slots=4,
                    max_len=P14["long_max_len"], device=device)
    finite = finite_logits(engine)
    with kernel_run(stash["qwen_b"]) as launches["qwen_b"]:
        stats["qwen_b"] = engine.run(reqs)
    stats["peak_mem_gb"], stats["held_gb"] = peak_gb(held)
    # batches x (1 prefill + max_new - 1 decode steps) x layers
    for run, n_tok, want in (("qwen_a", 8 * 16, 2 * 16 * n_layers),
                             ("qwen_b", len(reqs) * new, new * n_layers)):
        got = launches[run]
        if stats[run]["tokens_out"] != n_tok:
            raise AssertionError(f"phase 14a {run}: "
                                 f"{stats[run]['tokens_out']} tokens, want "
                                 f"{n_tok}")
        if device == "cuda" and (got["flash_attention"] != want
                                 or sum(got.values()) != want):
            raise AssertionError(f"phase 14a {run}: launches {got}, want "
                                 f"{want} of flash_attention only")
    if not all(finite) or any(len(r.out) != new for r in reqs):
        raise AssertionError("phase 14a qwen_b: non-finite logits or "
                             "short requests")

    # prefill then one decode step against the full prefill (run a's first
    # four prompts, left-padded as the engine pads them)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab, rng.integers(4, 24)).astype(
        np.int32) for _ in range(4)]
    plen = max(len(p) for p in prompts)
    toks = np.zeros((4, plen), np.int32)
    for j, p in enumerate(prompts):
        toks[j, plen - len(p):] = p
    toks = torch.from_numpy(toks)
    full, _ = transformer.prefill(cfg, params, toks.to(device), 128)
    _, cache = transformer.prefill(cfg, params, toks[:, :-1].to(device), 128)
    dec, _ = transformer.decode_step(cfg, params, toks[:, -1:].to(device),
                                     cache, plen - 1)
    stats["decode_vs_prefill"] = float((dec - full).abs().max())
    torch.testing.assert_close(dec, full, rtol=5e-2, atol=5e-2, msg=lambda m:
                               f"phase 14a decode vs prefill: {m}")
    # float32 at cpu_layers layers: the card's prefill against the CPU's
    cfg32 = dataclasses.replace(cfg, n_layers=P14["cpu_layers"],
                                param_dtype="float32")
    p32 = as_dtype(cut_params(cfg, params, cfg32.n_layers), torch.float32,
                   "cpu")
    del engine, params, cache, full, dec
    free_card()
    want, _ = transformer.prefill(cfg32, p32, toks, 128)
    got, _ = transformer.prefill(cfg32, as_dtype(p32, torch.float32, device),
                                 toks.to(device), 128)
    stats["card_vs_cpu_f32"] = rel_err(got, want)
    if not stats["card_vs_cpu_f32"] <= 1e-3:
        raise AssertionError(f"phase 14a: the card's float32 prefill vs the "
                             f"CPU's: {stats['card_vs_cpu_f32']}")
    for run in ("qwen_a", "qwen_b"):
        st = stats[run]
        log(f"phase 14a {run} ({smi}): " + json.dumps(
            {k: st[k] for k in ("tok_per_s", "wall_s", "prefill_s",
                                "decode_s", "decode_steps", "tokens_out",
                                "batches")}
            | {"flash_attention": launches[run]["flash_attention"]}))
    log(f"phase 14a ({smi}): peak device memory {stats['peak_mem_gb']:.3f} "
        f"GB over the {stats['held_gb']:.3f} GB held before; run b's weights "
        f"drawn on the card in {stats['init_s']:.3f} s; prefill-then-decode "
        f"vs the full prefill max |diff| {stats['decode_vs_prefill']:.6f} "
        f"(limit 5e-2); at {cfg32.n_layers} layers in float32 the card's "
        f"prefill vs the CPU's, relative error norm "
        f"{stats['card_vs_cpu_f32']:.3g} (limit 1e-3)")
    free_card()
    return stats, launches


def qwen_training(seed, smi, stash, device="cuda"):
    """14b: qwen2.5-3b at full width and depth through
    ``repro_torch.launch.train.main``: ``train_steps`` steps of
    ``train_batch`` x ``train_seq`` tokens in ``microbatches``
    microbatches, float32 AdamW moments, remat ``dots_no_batch``, no
    checkpoint (phases 10 and 12c cover them). Every loss finite; #7 only,
    2 launches a layer a microbatch a step (the remat recompute); each step
    timed (host clock, synchronised by the loss); the peak device memory
    beside the reckoning of the state (parameters, bf16 gradients, the
    moments, one microbatch's float32 logits). Path ``qwen_train``; returns
    (stats, launches)."""
    import numpy as np
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build
    from repro_torch.train.optimizer import AdamWConfig, opt_state_specs

    cfg = p14_config()
    model = build(cfg)
    steps, mb = P14["train_steps"], P14["microbatches"]
    b, s = P14["train_batch"], P14["train_seq"]
    reckon = {"params_gb": spec_bytes(model.param_specs) / 1e9,
              "moments_gb": spec_bytes(opt_state_specs(
                  model.param_specs, AdamWConfig())) / 1e9,
              "logits_gb": b // mb * s * cfg.vocab_padded * 4 / 1e9}
    reckon["grads_gb"] = reckon["params_gb"]
    reckon["sum_gb"] = sum(reckon.values())
    log(f"phase 14b: {describe(cfg)}; {steps} steps of {b} x {s} tokens in "
        f"{mb} microbatches, float32 moments; the state by reckoning "
        + json.dumps({k: round(v, 3) for k, v in reckon.items()}))
    argv = ["--arch", P14["arch"], "--steps", str(steps), "--batch", str(b),
            "--seq", str(s), "--microbatches", str(mb), "--seed", str(seed),
            "--log-every", "1", "--device", str(device)] + (
                ["--reduced"] if P14["reduced"] else [])
    step_s, make_step = [], launch_train.make_train_step

    def timed_make(*a, **kw):
        step = make_step(*a, **kw)

        def timed(*args):
            t0 = clock()
            out = step(*args)
            out[2].item()
            step_s.append(clock() - t0)
            return out
        return timed

    held = peak_reset()
    launch_train.make_train_step = timed_make
    try:
        with kernel_run(stash.setdefault("qwen_train", {})) as launches:
            losses = launch_train.main(argv)
    finally:
        launch_train.make_train_step = make_step
    peak, held_gb = peak_gb(held)
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"phase 14b: losses {losses}")
    want = 2 * cfg.n_layers * mb * steps
    if device == "cuda" and (launches["flash_attention"] != want
                             or sum(launches.values()) != want):
        raise AssertionError(f"phase 14b: launches {launches}, want {want} "
                             f"of flash_attention only")
    med = sorted(step_s[1:])[len(step_s[1:]) // 2]
    stats = {"losses": losses, "step_s": step_s, "median_step_s": med,
             "tok_per_s": b * s / med, "peak_mem_gb": peak,
             "held_gb": held_gb, "reckoning": reckon,
             "flash_attention": launches["flash_attention"]}
    log(f"phase 14b ({smi}): " + json.dumps(stats))
    free_card()
    return stats, launches


def qwen_gradients(seed, smi, device="cuda"):
    """14c: qwen2.5-3b at full width, ``grad_layers`` layers, one step on
    ``grad_batch`` x ``grad_seq`` tokens. Every leaf's gradient on the card
    in bf16 against the CPU's in float32 on the same weights: relative
    error norm within 5e-2 and a non-zero norm (phase 10b's rule), the QKV
    biases and the tied table among them. Then the same step in float32
    through ``make_train_step`` with int8 AdamW moments
    (``AdamWConfig(quantized_state=True)``) on the card against
    ``adamw_update`` on the CPU's gradients: each dequantized moment within
    one int8 level of the CPU's (the larger of the two rows' scales, 1%
    over for the scales' own rounding; a 1-D leaf's float32 moments within
    1e-3 relative error norm), each leaf's update within 1e-3 relative
    error norm. Logs the full-depth state bytes with int8 moments beside
    float32's. Returns stats."""
    import dataclasses
    import torch
    from repro_torch.models import build, init_params
    from repro_torch.models.spec import tree_leaves
    from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                                   make_train_step, opt_state_specs)
    from repro_torch.train.optimizer import _q8_decode
    from repro_torch.train.train_step import loss_and_grads

    full = p14_config()
    cfg = dataclasses.replace(full, n_layers=P14["grad_layers"])
    model = build(cfg)
    model32 = build(dataclasses.replace(cfg, param_dtype="float32"))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    params = init_params(model.param_specs, gen, device=device)
    toks = torch.randint(1, cfg.vocab, (P14["grad_batch"], P14["grad_seq"]),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed + 1))
    batch = {"tokens": toks.to(device)}
    cpu32 = as_dtype(params, torch.float32, "cpu")
    t0 = time.perf_counter()
    _, want = loss_and_grads(model32, cpu32, {"tokens": toks})
    t_cpu = time.perf_counter() - t0

    def on_card(tree):
        return as_dtype(tree, torch.float32, device)

    def rel(got, want):  # relative error norm, float32 on the card
        g, w = got.float(), want.to(got.device).float()
        return float((g - w).norm() / w.norm().clamp_min(1e-30))

    _, got = loss_and_grads(model, params, batch)
    names = leaf_names(params)
    errs = [(rel(g, w), float(g.float().norm())) for g, w in zip(
        tree_leaves(got), tree_leaves(on_card(want)))]
    del got
    bad = [(n, e) for n, e in zip(names, errs) if e[0] > 5e-2 or e[1] <= 0]
    if bad:
        raise AssertionError(f"phase 14c: leaf gradients off: {bad}")
    # the same step in float32 with int8 moments
    qcfg = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                       quantized_state=True)
    cpu_p, cpu_opt = adamw_update(want, adamw_init(cpu32, qcfg), cpu32, qcfg)
    card32 = as_dtype(params, torch.float32, device)
    del params
    card_p, card_opt, _ = make_train_step(model32, qcfg)(
        card32, adamw_init(card32, qcfg), batch)
    upd, mom = {}, {}
    for n, p0, pc, pw, in zip(names, tree_leaves(card32),
                              tree_leaves(card_p), tree_leaves(cpu_p)):
        upd[n] = rel(pc - p0, pw.to(device) - p0)
    for part in ("m", "v"):
        got_m, want_m = card_opt[part], cpu_opt[part]
        for n in names:
            g, w = got_m, want_m
            for k in n.split("/"):
                g, w = g[k], w[k]
            if isinstance(w, dict):  # int8 codes and per-row scales
                w = {k: x.to(device) for k, x in w.items()}
                level = torch.maximum(g["s"], w["s"])
                gap = (_q8_decode(g) - _q8_decode(w)).abs()
                mom[f"{part}/{n}"] = float((gap / level).max())
                ok = mom[f"{part}/{n}"] <= 1.01
            else:
                mom[f"{part}/{n}"] = rel(g, w)
                ok = mom[f"{part}/{n}"] <= 1e-3
            if not ok:
                raise AssertionError(f"phase 14c: int8 moment {part}/{n} vs "
                                     f"the CPU's: {mom[f'{part}/{n}']}")
    worst = max(upd, key=upd.get)
    if not upd[worst] <= 1e-3:
        raise AssertionError(f"phase 14c: the update of {worst} vs the "
                             f"CPU's: {upd[worst]}; every leaf "
                             + json.dumps(upd))
    state = {q: spec_bytes(opt_state_specs(build(full).param_specs,
                                           AdamWConfig(quantized_state=q)))
             / 1e9 for q in (False, True)}
    stats = {"grad_rel_err": dict(zip(names, (e[0] for e in errs))),
             "cpu_grads_s": t_cpu, "update_rel_err": upd,
             "moment_levels": mom,
             "state_gb": {"float32": state[False], "int8": state[True]}}
    log(f"phase 14c ({smi}): {cfg.n_layers} layers, {P14['grad_batch']} x "
        f"{P14['grad_seq']} tokens: every leaf's gradient on the card (bf16) "
        f"against the CPU's (float32), relative error norm <= "
        f"{max(e[0] for e in errs):.4g} (limit 5e-2), norms > 0: "
        + json.dumps(stats["grad_rel_err"]) + "; the float32 step with int8 "
        f"moments vs the CPU's: the update's relative error norm <= "
        f"{upd[worst]:.3g} ({worst}; limit 1e-3), the moments' largest gap "
        f"in int8 levels (1-D leaves: relative error norm) "
        + json.dumps({k: round(v, 6) for k, v in mom.items()})
        + f"; the full-depth optimizer state float32 {state[False]:.3f} GB, "
        f"int8 {state[True]:.3f} GB; the CPU's gradients {t_cpu:.3f} s")
    free_card()
    return stats


def qwen_whole(seed, smi, stash, device="cuda"):
    """Phase 14 (a)-(c); (d) runs in 13g and 13h. Returns launches."""
    t = {}
    t0 = time.perf_counter()
    _, launches = qwen_serving(seed, smi, stash, device)
    t["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, launches["qwen_train"] = qwen_training(seed, smi, stash, device)
    t["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    qwen_gradients(seed, smi, device)
    t["c"] = time.perf_counter() - t0
    log("phase 14 by part (s): " + json.dumps(t))
    return launches


# ------------------------------------------------------------------ phase 15
# yi-34b whole (60 layers, bf16, 68.82 GB of weights drawn on the card),
# served through Engine; runs right after the build, while the card holds
# nothing else
P15 = dict(arch="yi-34b", reduced=False, requests=4, prompt=512, new=16)


def yi_whole(seed, smi, stash, device="cuda"):
    """Phase 15: yi-34b at full width and depth in bf16, weights drawn on
    the card, ``requests`` requests of ``prompt`` tokens and ``new`` new
    tokens each through ``Engine`` (one batch of 4 slots, max_len ``prompt
    + new``; path ``yi``): every request yields its tokens, every logit
    finite, self-attention only on #7 (60 launches a forward: 56 heads
    over 8 at hd 128, GQA rep 7). The last decode step's logits against
    one prefill over every token the step saw (relative error norm within
    5e-2, phase 6's bf16 limit). The peak device memory beside the
    weights plus the cache. Returns launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models import build, init_params, param_count
    from repro_torch.serve import Engine, Request

    cfg = (get_reduced if P15["reduced"] else get_config)(P15["arch"])
    model = build(cfg)
    s, new = P15["prompt"], P15["new"]
    weights = spec_bytes(model.param_specs)
    cache = 2 * cfg.n_layers * 4 * (s + new) * cfg.n_kv_heads * cfg.hd * 2
    log(f"phase 15: {describe(cfg)}; {param_count(model.param_specs) / 1e9:.3f}"
        f" B parameters, {weights / 1e9:.3f} GB; {P15['requests']} requests "
        f"of {s} tokens, {new} new each")
    held = peak_reset()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(model.param_specs, gen, device=device)
    if device == "cuda":
        sync()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, s).astype(np.int32),
                    max_new=new) for _ in range(P15["requests"])]
    engine = Engine(model, params, batch_slots=4, max_len=s + new,
                    device=device)
    last, greedy = {"finite": True}, engine._greedy

    def kept(logits):  # the last step's logits; every step's finite
        last["logits"] = logits[:, -1]
        last["finite"] &= bool(torch.isfinite(logits).all())
        return greedy(logits)

    engine._greedy = kept
    with kernel_run(stash.setdefault("yi", {})) as launches:
        st = engine.run(reqs)
    want = new * cfg.n_layers  # 1 prefill + new - 1 decode steps
    if st["tokens_out"] != len(reqs) * new or not last["finite"]:
        raise AssertionError(f"phase 15: {st['tokens_out']} tokens, finite "
                             f"logits {last['finite']}")
    if device == "cuda" and (launches["flash_attention"] != want
                             or sum(launches.values()) != want):
        raise AssertionError(f"phase 15: launches {launches}, want {want} "
                             f"of flash_attention only")
    # the last decode step saw each prompt and the first new - 1 tokens
    toks = torch.as_tensor(np.stack([np.concatenate([r.prompt, r.out[:-1]])
                                     for r in reqs]), device=device)
    full, _ = model.prefill(engine.params, {"tokens": toks})
    rel = rel_err(last["logits"], full[:, -1])
    if not rel <= 5e-2:
        raise AssertionError(f"phase 15: the last decode step vs one prefill "
                             f"over every token: {rel}")
    peak, held_gb = peak_gb(held)
    log(f"phase 15 ({smi}): " + json.dumps(
        {k: st[k] for k in ("tok_per_s", "wall_s", "prefill_s", "decode_s",
                            "decode_steps", "tokens_out")}
        | {"init_s": t_init, "flash_attention": launches["flash_attention"],
           "decode_vs_prefill": rel, "peak_mem_gb": peak,
           "held_gb": held_gb, "weights_gb": weights / 1e9,
           "cache_gb": cache / 1e9,
           "peak_over_weights_and_cache_gb": peak - (weights + cache) / 1e9}))
    del engine._greedy, kept, greedy  # the wrapper's cycle through engine
    del engine, params, full, last
    free_card()
    return launches


def input_groups(inputs):
    """Group recorded inputs as 'path shapes kw=...': the decode steps'
    positions (``q_offset``) fold into one group, shown as a range.
    Returns {text: [indices into inputs]}."""
    groups, offs = {}, {}
    for n, (path, key, _, _) in enumerate(inputs):
        kw = dict(key[1])
        off = kw.pop("q_offset", None)
        text = f"{path} " + " ".join(
            str(list(x)) if isinstance(x, tuple) else str(x)
            for x in key[0]) + "".join(f" {k}={v}" for k, v in kw.items())
        if len(set(key[2])) == 1 and key[2][0] != "int32":  # one float type
            text += f" {key[2][0]}"
        groups.setdefault(text, []).append(n)
        if off is not None:
            offs.setdefault(text, []).append(off)
    out = {}
    for text, idx in groups.items():
        o = offs.get(text, [])
        span = (f" q_offset={min(o)}" if len(o) == 1 else
                f" q_offset={min(o)}..{max(o)}" if o else "")
        out[text + span] = idx
    return out


def kernel_checks(stash, launches):
    """Each kernel against its plain version at every input each path gave
    it (``stash[path][kernel]``, recorded in phases 3, 4b, 4c, 4d, 7, 8, 9,
    6, 10, 13, 12 and 11: one per geometry for #1-#3 and #7, every call for
    #4-#6 and the tablet gather; a decode step's position is part of #7's
    geometry; ``stash[path]["tablet_read"]`` the 4c reads).
    ``launches[path]`` are the paths' launch counts. Every time is the
    mean per launch over all the paths' launches, so ms x launches is the
    kernel's device time on the paths. A ``*_check`` path (the float32
    twins and gradient checks of phases 11 and 12) is a check's run: its
    inputs are held to the plain version, and its launches are neither
    counted as the kernel's nor timed."""
    import numpy as np
    import torch
    from repro_torch.kernels.common import I32_MAX
    from repro_torch.kernels import common
    from repro_torch.kernels.merge_rank import (apply_row_rank,
                                                merge_combine_rows_ref,
                                                merge_ranks, merge_ranks_ref,
                                                pair_rank, pair_rank_ref,
                                                row_merge, row_merge_ref,
                                                row_rank, row_rank_ref)
    from repro_torch.kernels.segment_reduce import (segment_sum,
                                                    segment_sum_direct,
                                                    segment_sum_ref)
    from repro_torch.kernels.sorted_search import (rank, rank_batched,
                                                   rank_binary, rank_ref,
                                                   rank_sides_ref,
                                                   tablet_gather,
                                                   tablet_gather_ref,
                                                   tablet_read,
                                                   tablet_read_ref)
    from repro_torch.kernels.spmv import (spmv_csr, spmv_csr_ref, spmv_ell,
                                          spmv_ell_ref)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    out = []

    def check(name, got, want):
        """Ranks and degree sums (integer-valued) must be exactly equal;
        the merge ranks are a pair (rank_a, rank_b)."""
        if isinstance(want, tuple):
            return max(check(name, g, w) for g, w in zip(got, want))
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{name}: {bad} results differ from plain")
        return float((got.double() - want.double()).abs().max())

    def check_close(name, got, want):
        """SpMV: the warp reduction and the segmented scan add in another
        order than the plain row sum, so within rtol=1e-5."""
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                                   msg=lambda m: f"{name}: {m}")
        return float((got.double() - want.double()).abs().max())

    attn_rel = [0.0]  # the largest relative error norm #7's checks saw

    def attn_err(got, want):
        """(max |got - want|, ||got - want|| / ||want||, within the
        limits). Both sides compute in float32 and round once to the
        output dtype, adding in another order, so bf16 allows about one
        ulp (rtol 8e-3) above atol 1e-3 (the outputs at run b's inputs
        are ~1e-2), float32 2e-5; and for both an error norm within 1e-2
        of the output's."""
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"attention: {got.shape} {got.dtype} vs "
                                 f"{want.shape} {want.dtype}")
        g, w = got.float(), want.float()
        tol = (8e-3, 1e-3) if got.dtype == torch.bfloat16 else (2e-5, 2e-5)
        d = (g - w).abs()
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        ok = bool((d <= tol[1] + tol[0] * w.abs()).all()) and rel <= 1e-2
        return float(d.max()), rel, ok

    attn_lse = [0.0]  # the largest |lse - plain's| #7's checks saw

    def check_attn(name, got, want):
        """o as ``attn_err`` holds it; with (o, lse) pairs also lse, the
        row's float32 log-sum-exp, within 1e-5 (float32 inputs) or 1e-2
        (bf16: the kernel's exp2 and its sums in another order), relative
        above 1."""
        if isinstance(got, tuple):
            (got, lse), (want, want_lse) = got, want
            tol = 1e-2 if got.dtype == torch.bfloat16 else 1e-5
            d = (lse - want_lse).abs()
            same_inf = torch.isinf(want_lse) & (lse == want_lse)
            bad = ~same_inf & ~(d <= tol * want_lse.abs().clamp_min(1.0))
            if lse.shape != want_lse.shape or bool(bad.any()):
                raise AssertionError(f"{name}: lse {tuple(lse.shape)} "
                                     f"{int(bad.sum())} rows past {tol:g}")
            attn_lse[0] = max(attn_lse[0], float(d[~same_inf].max())
                              if bool((~same_inf).any()) else 0.0)
        err, rel, ok = attn_err(got, want)
        if not ok:
            raise AssertionError(f"{name}: max |diff| {err:.3g}, relative "
                                 f"error norm {rel:.3g} past the limits")
        attn_rel[0] = max(attn_rel[0], rel)
        return err

    def masked_attention(q, k, v, keep):
        """Plain float32 attention where key j is seen by row i iff
        ``keep[i, j]``: makes the planted faults below."""
        g = q.shape[2] // k.shape[2]
        kk, vv = (x.float().repeat_interleave(g, dim=2) for x in (k, v))
        sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) \
            * q.shape[-1] ** -0.5
        sc = sc.masked_fill(~keep, -1e30)
        return torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1),
                            vv).to(q.dtype)

    def attn_faults():
        """The power of #7's check at run b's inputs (its prefill and its
        first decode step, where the cache holds 127 empty slots): two
        planted faults, made with the plain math and a key mask, must
        fail it: an eighth of the keys dropped (every 8th 32-key tile, as
        a lost key split would), and the causal limit moved 100 keys past
        each row's position. Returns the readings."""
        calls = stash["serve_b"]["flash_attention"].calls
        pre = [c[1] for key, c in calls.items() if key[0][0][1] > 1]
        dec = [c[1] for key, c in calls.items() if key[0][0][1] == 1]
        readings = {}
        for label, (args, kw) in (("prefill", pre[0]), ("decode", min(
                dec, key=lambda c: c[1]["q_offset"]))):
            q, k, v = args
            want = flash_attention_ref(*args, **kw)
            rows = kw["q_offset"] + torch.arange(q.shape[1], device=dev)
            keys = torch.arange(k.shape[1], device=dev)[None, :]
            causal = rows[:, None] >= keys
            for fault, keep in (
                    ("split dropped", causal & ((keys // 32) % 8 != 7)),
                    ("100 keys past", rows[:, None] + 100 >= keys)):
                err, rel, ok = attn_err(masked_attention(q, k, v, keep),
                                        want)
                if ok:
                    raise AssertionError(f"flash_attention: the check "
                                         f"passes a planted fault ({fault}, "
                                         f"run b {label})")
                readings[f"{label}, {fault}"] = {"max_abs_err": err,
                                                 "rel_err": rel}
            del want
        return readings

    def steps(n):  # probe steps of a binary search over n entries
        return max(1, math.ceil(math.log2(n + 1)))

    def probed(n, n_q):  # table entries a binary search must read
        return min(n, n_q * steps(n))

    # bytes: the queries read and the output written once, and of each
    # searched table only the entries the queries' binary searches probe
    # (at most the table); operations: a compare and an add per probe step
    # (rank search, for each side) or per pair (row rank), three compares
    # and a select per probe step (pair rank)
    def search_cost(args, kw):
        tabs, qq, side = args
        k, n = tabs.shape
        sides = 2 if side == "both" else 1
        return (4 * (k * probed(n, qq.numel()) + qq.numel()
                     + sides * k * qq.numel()),
                2 * sides * k * qq.numel() * steps(n))

    def row_cost(args, kw):
        (keys,) = args
        return 4 * 2 * keys.numel(), 2 * keys.shape[0] * keys.shape[1] ** 2

    # row merge: keys and values read once, both written once (values of
    # their own width); the row rank's compares and adds
    def row_merge_cost(args, kw):
        keys, vals = args
        n_bytes = (4 + vals.element_size()) * 2 * keys.numel()
        return n_bytes, row_cost((keys,), kw)[1]

    def pair_cost(args, kw):
        tr, _, qr, _ = args
        (n_s, m), n = tr.shape, qr.shape[1]
        return (4 * (2 * n_s * probed(m, n) + 3 * qr.numel()),
                4 * qr.numel() * steps(m))

    # merge ranks: each run's rows and cols read once and its ranks written
    # once, 12 bytes per entry of both runs; a pair compare (three int
    # compares and a select) per merged entry
    def merge_cost(args, kw):
        ar, _, br, _ = args
        n = ar.numel() + br.numel()
        return 12 * n, 4 * n

    def rank_cost(args, kw):
        tab, qq, side = args
        return search_cost((tab[None], qq, side), kw)

    # compacting gather: each copied entry's col and value read and its
    # (row, col, value) written, 20 bytes; each query's id, start and end
    # offset read once; an add (the entry's source) per entry
    def gather_cost(args, kw):
        q, total = args[4:]
        return 20 * total + 12 * q.numel(), total

    # segment sum: ids and values read, the [S] sums written; one float add
    # per entry (at the float32 rate, below)
    def segsum_cost(args, kw):
        ids = args[0]
        return 8 * ids.numel() + 4 * kw["n_segments"], ids.numel()

    # ELL SpMV: every slot's column is read (it says whether the slot is a
    # pad), but a value only where the slot holds an entry of this run's
    # ELL; x read and y written once; a multiply and an add per entry
    def spmv_cost(args, kw):
        cols, _, x = args
        nnz = int(((cols >= 0) & (cols < x.numel())).sum())
        return (4 * (cols.numel() + nnz + x.numel() + cols.shape[0]),
                2 * nnz)

    # CSR SpMV: indptr, cols and vals read once, x read and y written once;
    # a multiply and an add per entry whose column is in x
    def csr_cost(args, kw):
        indptr, cols, _, x = args
        nnz = int(((cols >= 0) & (cols < x.numel())).sum())
        return (4 * (indptr.numel() + 2 * cols.numel() + x.numel()
                     + indptr.numel() - 1), 2 * nnz)

    # one PyTorch call computing the same function
    def attn_lib(args, kw):
        """SDPA on [B, H, S, hd] copies (made off the clock) in two forms:
        with the boolean causal mask, and without one where the function
        allows it (``is_causal`` at q_offset 0, whose mask SDPA aligns
        top-left; a decode row over the K/V slice it sees), which lets
        SDPA take its fused flash backend. Each form's output is first
        held against the plain version (the CPU tests' 2e-2)."""
        sdpa = torch.nn.functional.scaled_dot_product_attention
        kw = {k: x for k, x in kw.items() if k != "return_lse"}  # o only
        q, k, v = (x.transpose(1, 2).contiguous() for x in args)
        sq, sk = q.shape[2], k.shape[2]
        off, causal = kw.get("q_offset", 0), kw.get("causal", True)
        mask = (off + torch.arange(sq, device=dev)[:, None]
                >= torch.arange(sk, device=dev)[None, :]) if causal else None
        forms = {"lib_masked": lambda: sdpa(q, k, v, attn_mask=mask,
                                            enable_gqa=True)}
        if causal and off == 0:
            forms["lib_free"] = lambda: sdpa(q, k, v, is_causal=True,
                                             enable_gqa=True)
        elif causal and sq == 1:
            ks, vs = k[:, :, :off + 1], v[:, :, :off + 1]
            forms["lib_free"] = lambda: sdpa(q, ks, vs, enable_gqa=True)
        else:  # no mask, or no mask-free form: the same call
            forms["lib_free"] = forms["lib_masked"]
        want = flash_attention_ref(*args, **kw)
        for form, fn in forms.items():
            torch.testing.assert_close(
                fn().transpose(1, 2), want, rtol=2e-2, atol=2e-2,
                msg=lambda m: f"flash_attention library {form}: {m}")
        return forms

    def search_lib(args, kw):  # one searchsorted per side
        tabs, qq, side = args
        qk = qq[None].expand(tabs.shape[0], -1).contiguous()
        rights = {"left": (False,), "right": (True,), "both": (False, True)}

        def run():
            return [torch.searchsorted(tabs, qk, right=r, out_int32=True)
                    for r in rights[side]]
        return run

    def pair_lib(args, kw):
        tr, tc, qr, qc = args
        tkey = (tr.long() << 32) | tc.long()
        qkey = (qr.long() << 32) | qc.long()
        return lambda: torch.searchsorted(tkey, qkey, right=not kw["strict"],
                                          out_int32=True)

    def merge_lib(args, kw):  # the two int64 searchsorted calls
        ar, ac, br, bc = args
        akey = (ar.long() << 32) | ac.long()
        bkey = (br.long() << 32) | bc.long()
        return lambda: (
            torch.searchsorted(bkey, akey, out_int32=True),
            torch.searchsorted(akey, bkey, right=True, out_int32=True))

    def merge_old(args, kw):  # the two binary-search pair_rank launches
        ar, ac, br, bc = args
        return lambda: (pair_rank(br, bc, ar, ac, True),
                        pair_rank(ar, ac, br, bc, False))

    def rank_lib(args, kw):  # one searchsorted per side
        tab, qq, side = args
        rights = {"left": (False,), "right": (True,), "both": (False, True)}
        return lambda: [torch.searchsorted(tab, qq, right=r, out_int32=True)
                        for r in rights[side]]

    def rank_old(args, kw):  # the binary search, one launch per side
        tab, qq, side = args
        sides = ("left", "right") if side == "both" else (side,)
        return lambda: tuple(rank_binary(tab, qq, x) for x in sides)

    def row_merge_lib(args, kw):  # the engine's wide-row route: stable sort
        return lambda: merge_combine_rows_ref(*args)  # + gather

    def row_merge_old(args, kw):  # the row-rank launch, then the scatters
        keys, vals = args
        return lambda: apply_row_rank(keys, vals, row_rank(keys))

    def segsum_old(args, kw):  # one global atomic per entry
        return lambda: segment_sum_direct(*args, **kw)

    def segsum_lib(args, kw):  # index_add_ on the valid ids (off the clock)
        ids, vals = args
        n_seg = kw["n_segments"]
        ok = (ids >= 0) & (ids < n_seg)
        vi, vv = ids[ok].long(), vals[ok]
        return lambda: torch.zeros(n_seg, device=dev).index_add_(0, vi, vv)

    def spmv_lib(args, kw):  # cuSPARSE CSR product (CSR built off the clock)
        cols, vals, x = args
        ok = cols >= 0
        crow = torch.zeros(cols.shape[0] + 1, dtype=torch.int64, device=dev)
        crow[1:] = ok.sum(1).cumsum(0)
        a = torch.sparse_csr_tensor(crow, cols[ok].long(), vals[ok],
                                    size=(cols.shape[0], x.shape[0]))
        xc = x[:, None]
        return lambda: a @ xc

    def csr_lib(args, kw):  # cuSPARSE on the entries in x (off the clock)
        indptr, cols, vals, x = args
        rows = torch.repeat_interleave(
            torch.arange(indptr.numel() - 1, device=dev),
            (indptr[1:] - indptr[:-1]).long())
        ok = (cols >= 0) & (cols < x.numel())
        crow = torch.zeros(indptr.numel(), dtype=torch.int64, device=dev)
        crow[1:] = torch.bincount(rows[ok], minlength=indptr.numel() - 1
                                  ).cumsum(0)
        a = torch.sparse_csr_tensor(crow, cols[ok].long(), vals[ok],
                                    size=(indptr.numel() - 1, x.numel()))
        xc = x[:, None]
        return lambda: a @ xc

    # name, kernel, plain, cost, library, plain timing reps, check, op
    # peak (or a function of the inputs), library timed eagerly (cuSPARSE is not captured in a graph),
    # source, TPU kernel, and the kernel it redesigned (checked and timed
    # beside it), if any
    specs = (
        ("rank_batched", rank_batched, rank_sides_ref, search_cost,
         search_lib, (20, 3), check, PEAK_OPS_PER_S, False,
         "src/repro_torch/csrc/rank_batched.cu",
         "src/repro/kernels/sorted_search/kernel.py:66", None),
        # the generic rank, launched on phase 3's path by the check of the
        # route the row merge replaced
        ("row_rank", row_rank, row_rank_ref, row_cost, None, (20, 3), check,
         PEAK_OPS_PER_S, False, "src/repro_torch/csrc/row_rank.cu",
         "src/repro/kernels/merge_rank/kernel.py:67", None),
        # the same TPU kernel's function as the point read applies it (rank,
        # then the merged row), in one launch
        ("row_merge", row_merge, row_merge_ref, row_merge_cost, row_merge_lib,
         (20, 3), check, PEAK_OPS_PER_S, False,
         "src/repro_torch/csrc/row_rank.cu",
         "src/repro/kernels/merge_rank/kernel.py:67", row_merge_old),
        # the plain pair rank is a chunked quadratic count (up to ~7e11
        # compares per shard at the single engine's flush): its time is
        # that of the one call the check makes, no warm-up
        ("pair_rank", pair_rank, pair_rank_ref, pair_cost, pair_lib, (0, 0),
         check, PEAK_OPS_PER_S, False, "src/repro_torch/csrc/pair_rank.cu",
         "src/repro/kernels/merge_rank/kernel.py:36", None),
        # the same TPU kernel's function on the merge path, for two sorted
        # runs (the plain version is a stable sort of the int64 keys)
        ("merge_path_rank", merge_ranks, merge_ranks_ref, merge_cost,
         merge_lib, (5, 1), check, PEAK_OPS_PER_S, False,
         "src/repro_torch/csrc/merge_path.cu",
         "src/repro/kernels/merge_rank/kernel.py:36", merge_old),
        # the plain 1-D rank is the compare count over the whole tablet;
        # the warp search beside the one-thread binary search it replaced
        ("rank", rank, rank_ref, rank_cost, rank_lib, (3, 1), check,
         PEAK_OPS_PER_S, False, "src/repro_torch/csrc/rank.cu",
         "src/repro/kernels/sorted_search/kernel.py:30", rank_old),
        # the rest of the same TPU kernel's caller, the single engine's point
        # read: the compacting copy of the ranked rows (no library call)
        ("tablet_gather", tablet_gather, tablet_gather_ref, gather_cost,
         None, (20, 3), check, PEAK_OPS_PER_S, False,
         "src/repro_torch/csrc/rank.cu",
         "src/repro/kernels/sorted_search/kernel.py:30", None),
        ("segment_sum", segment_sum, segment_sum_ref, segsum_cost,
         segsum_lib, (20, 3), check, PEAK_F32_PER_S, False,
         "src/repro_torch/csrc/segment_sum.cu",
         "src/repro/kernels/segment_reduce/kernel.py:33", segsum_old),
        ("spmv_ell", spmv_ell, spmv_ell_ref, spmv_cost, spmv_lib, (3, 1),
         check_close, PEAK_F32_PER_S, True, "src/repro_torch/csrc/spmv_ell.cu",
         "src/repro/kernels/spmv/kernel.py:34", None),
        # the same TPU kernel's function on Graphulo's path, in CSR
        ("spmv_csr", spmv_csr, spmv_csr_ref, csr_cost, csr_lib, (3, 1),
         check_close, PEAK_F32_PER_S, True, "src/repro_torch/csrc/spmv_csr.cu",
         "src/repro/kernels/spmv/kernel.py:34", None),
        # bf16 inputs run on the tensor cores, float32 on the CUDA cores
        ("flash_attention", flash_attention, flash_attention_ref,
         attention_work, attn_lib, (5, 1), check_attn,
         lambda args: (PEAK_BF16_PER_S if args[0].dtype == torch.bfloat16
                       else PEAK_F32_PER_S), False,
         "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/kernel.py:64", None),
    )

    def binary_block(rows, cols, vals, q, width):
        """The padded block as the parent's ``tablet_query_rows`` built
        it: a binary-search rank launch per side, then the gathers."""
        start, end = (rank_binary(rows, q, side) for side in ("left", "right"))
        idx = start[:, None] + torch.arange(width, dtype=torch.int32,
                                            device=dev)[None, :]
        idxc = idx.clamp(0, rows.shape[0] - 1).long()
        return cols[idxc], vals[idxc], idx < end[:, None], end - start

    def read_routes(stash):
        """Every recorded ``tablet_read`` (phase 4c) against its plain
        version and the route it replaced (``padded_read`` on the binary
        search, four rank launches with the widen), each equal to the
        path's result and timed whole with CUDA events (their host syncs
        keep them out of a graph); launches per read."""
        reads = [r for recs in stash.values() for r in
                 recs.get("tablet_read", [])]
        per = []
        for args, got in reads:
            rows, cols, vals, q = args
            routes = {
                "route": lambda: tablet_read(*args),
                "plain_route": lambda: tablet_read_ref(*args),
                "old_route": lambda: padded_read(
                    lambda w: binary_block(rows, cols, vals, q, w), q)}
            t = {}
            for k, fn in routes.items():
                if not all(torch.equal(g, w) for g, w in zip(fn(), got)):
                    raise AssertionError(f"tablet_read: the {k} differs at "
                                         f"Q={q.shape[0]}")
                t[k + "_ms"] = cuda_ms(fn, 20)
            per.append(t)
            log(f"tablet_read Q={q.shape[0]} ({got[0].shape[0]} entries): "
                + ", ".join(f"{k} {v:.6g}" for k, v in t.items()))
        if not reads:
            raise AssertionError("tablet_read: no recorded read")
        res = {k: sum(t[k] for t in per) / len(per) for k in per[0]}
        res["reads"] = len(reads)
        for name in ("rank", "tablet_gather"):
            res[f"{name}_launches_per_read"] = sum(
                c for recs in stash.values()
                for c, _ in recs[name].calls.values()) / len(reads)
        return res

    def empty_launch():
        stream = torch.cuda.current_stream().cuda_stream
        err = common.lib().launch_floor(stream)
        if err:
            raise RuntimeError(f"launch_floor: CUDA error {err}")
    floor_ms = graph_ms(empty_launch, 200)
    log(f"launch floor (an empty kernel, graph replay): {floor_ms:.6g} ms")
    for (name, fn, ref, cost, lib, (p_reps, p_warm), chk, peak, lib_eager,
         src, tpu, old) in specs:
        by_path, inputs, by_check, check_inputs = {}, [], {}, []
        for path, recorders in stash.items():
            calls = recorders[name].calls
            n = sum(c for c, _ in calls.values())
            if n != launches[path][name]:
                raise AssertionError(
                    f"{name} in {path}: recorded {n} calls, "
                    f"{launches[path][name]} launches")
            recs = [(path, key, *calls[key])
                    for key in sorted(calls, key=lambda g: -calls[g][0])]
            if path.endswith("_check"):  # checked, neither counted nor timed
                by_check[path], check_inputs = n, check_inputs + recs
            else:
                by_path[path], inputs = n, inputs + recs
        n_calls = sum(by_path.values())
        if n_calls == 0:
            raise AssertionError(f"{name}: launched on no path")
        err, per = 0.0, []  # per input: ms, eager, plain, lib, bound
        ops_by = [0.0, 0.0]
        for _, _, cnt, (args, kw) in inputs:
            want, t_plain = timed_once(lambda: ref(*args, **kw))
            err = max(err, chk(name, fn(*args, **kw), want))
            if name == "flash_attention" and not kw.get("return_lse"):
                lkw = dict(kw, return_lse=True)  # and the row's lse
                chk(name, fn(*args, **lkw), ref(*args, **lkw))
            t = {"ms": graph_ms(lambda: fn(*args, **kw), 50),
                 "eager": cuda_ms(lambda: fn(*args, **kw), 50),
                 "plain": (cuda_ms(lambda: ref(*args, **kw), p_reps,
                                   warm=p_warm) if p_reps else t_plain),
                 "lib": 0.0}
            if old is not None:  # the redesigned kernel: equal, and timed
                got_old = old(args, kw)()
                if isinstance(got_old, tuple) and not isinstance(want, tuple):
                    got_old = torch.stack(got_old)
                chk(name + " (old kernel)", got_old, want)
                t["old"] = graph_ms(old(args, kw), 50)
            if lib is not None:  # the faster form where there are two
                timer = cuda_ms if lib_eager else graph_ms
                forms = lib(args, kw)
                if callable(forms):
                    forms = {"lib": forms}
                for form, f in forms.items():
                    t[form] = timer(f, 50)
                t["lib"] = min(t[form] for form in forms)
            del want
            t["bound"], by = bound_ms(*cost(args, kw), peak_ops=(
                peak(args) if callable(peak) else peak))
            ops_by[by == "operations"] += cnt * t["bound"]
            per.append(t)

        for _, _, _, (args, kw) in check_inputs:
            if name == "flash_attention":  # o and the row's lse
                kw = dict(kw, return_lse=True)
            err = max(err, chk(name, fn(*args, **kw), ref(*args, **kw)))

        def mean(idx, k):  # launch-weighted mean over some inputs
            n = sum(inputs[i][2] for i in idx)
            return sum(inputs[i][2] * per[i][k] for i in idx) / n

        groups = {f"{sum(inputs[i][2] for i in idx)}x {text}": idx
                  for text, idx in input_groups(inputs).items()}
        lib_forms = [k for k in per[0] if k.startswith("lib_")]
        for text, idx in groups.items():
            log(f"{name} {text}: ms {mean(idx, 'ms'):.6g}, plain "
                f"{mean(idx, 'plain'):.6g}, library {mean(idx, 'lib'):.6g}"
                + "".join(f" ({k[4:]} {mean(idx, k):.6g})" for k in lib_forms)
                + (f", old kernel {mean(idx, 'old'):.6g}" if old else "")
                + f", bound {mean(idx, 'bound'):.6g}")
        tot = {k: mean(range(len(inputs)), k) for k in per[0]}
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": tpu, "launches": n_calls,
                    "max_abs_err": err, "ms": tot["ms"],
                    "plain_ms": tot["plain"], "bound_ms": tot["bound"],
                    "bound_by": ("operations" if ops_by[1] > ops_by[0]
                                 else "bytes"),
                    "library_ms": tot["lib"] if lib else None,
                    "eager_ms": tot["eager"], "launch_floor_ms": floor_ms,
                    "launches_by_path": {k: v for k, v in by_path.items()
                                         if v},
                    "inputs": "; ".join(groups)})
        if any(by_check.values()):  # the checks' launches, held to plain
            out[-1]["check_launches"] = {k: v for k, v in by_check.items()
                                         if v}
            log(f"{name}: also equal to plain at the inputs of the checks' "
                f"launches " + json.dumps(out[-1]["check_launches"]) + ": "
                + "; ".join(input_groups(check_inputs)))
        if lib_forms:
            out[-1]["library_forms_ms"] = {k[4:]: tot[k] for k in lib_forms}
        if old is not None:
            out[-1]["old_kernel_ms"] = tot["old"]
        if name == "rank_batched":  # one launch per probed run stack
            both = sum(c for _, key, c, _ in inputs if "both" in key[0])
            probes = sum(r["probe_stack"].n for r in stash.values())
            out[-1]["launches_per_probe_stack"] = both / max(probes, 1)
            out[-1]["probe_stacks"] = probes
            log(f"rank_batched: {both} two-sided launches for {probes} "
                f"probed run stacks")
        if name == "row_merge":  # one launch per merge_combine_rows call
            combines = sum(r["combine_rows"].n for r in stash.values())
            out[-1]["launches_per_merge_combine_rows"] = n_calls / max(
                combines, 1)
            out[-1]["merge_combine_rows_calls"] = combines
            log(f"row_merge: {n_calls} launches for {combines} "
                f"merge_combine_rows calls")
        if name == "tablet_gather":  # the single engine's whole point read
            out[-1].update(read_routes(stash))
        if name == "flash_attention":
            by_hd = {}  # launch-weighted means per head dim
            for i, (_, key, _, _) in enumerate(inputs):
                by_hd.setdefault(key[0][0][-1], []).append(i)
            out[-1]["by_head_dim"] = {
                str(hd): {"launches": sum(inputs[i][2] for i in idx),
                          **{k: mean(idx, k) for k in ("ms", "plain",
                                                        "lib", "bound")}}
                for hd, idx in sorted(by_hd.items())}
            log("flash_attention by head dim: "
                + json.dumps(out[-1]["by_head_dim"]))
            out[-1]["rel_err"] = attn_rel[0]
            out[-1]["lse_max_abs_err"] = attn_lse[0]
            out[-1]["planted_faults"] = attn_faults()
            log(f"flash_attention: largest relative error norm {attn_rel[0]:.3g}"
                f", largest |lse - plain| {attn_lse[0]:.3g}"
                f"; planted faults, each failing the check: "
                + json.dumps(out[-1]["planted_faults"]))

    # #2 also at the widest row the path sends it ([512, 256]: 8 runs x 32),
    # as a check (not part of the path's mean)
    keys = (rng.integers(0, 1 << 14, (512, 256)) * 256
            + np.arange(256)).reshape(512, 8, 32)  # unique within a row
    keys.sort(axis=2)
    fill = rng.integers(0, 33, (512, 8, 1))
    keys = np.where(np.arange(32) < fill, keys, I32_MAX).reshape(512, 256)
    kt = torch.as_tensor(keys.astype(np.int32), device=dev)
    vt = torch.as_tensor(rng.normal(size=keys.shape).astype(np.float32),
                         device=dev)
    check("row_rank", row_rank(kt), row_rank_ref(kt))
    check("row_merge", row_merge(kt, vt), row_merge_ref(kt, vt))
    log(f"row_rank [512,256]: equal to plain; "
        f"{graph_ms(lambda: row_rank(kt), 100):.6f} ms per launch; row_merge "
        f"equal to plain, {graph_ms(lambda: row_merge(kt, vt), 100):.6f} ms")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=int, default=16)
    ap.add_argument("--profile", metavar="DIR", type=Path,
                    help="after the timed runs, run each path once more "
                         "with its put and reads traced by torch.profiler, "
                         "and write the per-op tables into DIR")
    ap.add_argument("--crash-child", metavar="DIR", type=Path,
                    help="run only phase 7's writer into DIR, which then "
                         "dies without closing anything (phase 7 starts it)")
    ap.add_argument("--tablet-child", metavar="DIR", type=Path,
                    help="run only phase 8a's writer into DIR, which then "
                         "dies without closing anything (phase 8a starts it)")
    ap.add_argument("--rank-child", metavar="DIR", type=Path,
                    help="run only one rank of phase 9's or phase 13a's "
                         "mesh, with the config and inputs in DIR (the "
                         "phase starts the ranks)")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of --rank-child")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import common
    except ImportError as e:
        print(f"chip_smoke: the port's sources are missing ({e})",
              file=sys.stderr)
        return 2
    if args.crash_child is not None:
        crash_child(args.crash_child, args.scale, args.seed)
    if args.tablet_child is not None:
        tablet_child(args.tablet_child, args.seed)
    if args.rank_child is not None:
        return rank_child(args.rank_child, args.rank)
    t_start = time.perf_counter()

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    # 2. build
    t0 = time.perf_counter()
    common.build()
    common.lib()
    log(f"build: {time.perf_counter() - t0:.3f} s")

    # each path's recorded kernel inputs and launch counts, for phase 5
    stash = {p: {} for p in ("yi", "qwen_a", "qwen_b", "qwen_train",
                             "listing1", "fig4", "graphulo", "single",
                             "recover", "tablets", "tablets_recover",
                             "tokens", "mesh", "mesh_nccl", "serve_a",
                             "serve_b", "train", "moe_a", "moe_b", "kimi",
                             "mamba2", "zamba2", "train_families",
                             "mamba2_check", "zamba2_check",
                             "train_families_check", "whisper",
                             "internvl2", "train_whisper", "train_prefix",
                             "whisper_check", "internvl2_check",
                             "train_prefix_check", "cost_step", "small")}
    launches = {}

    # 15. yi-34b whole (68.8 GB of weights), then 14. qwen2.5-3b whole
    # (served, trained: ~75 GB at the update), while the card holds no
    # recorded inputs; only #7's inputs go to the stash
    t15 = time.perf_counter()
    launches["yi"] = yi_whole(args.seed, smi, stash)
    log(f"phase 15: {time.perf_counter() - t15:.3f} s")
    t14 = time.perf_counter()
    launches.update(qwen_whole(args.seed, smi, stash))
    log(f"phase 14: {time.perf_counter() - t14:.3f} s")

    # 3. Listing-1 on the hand kernels. Both paths first run once untimed
    # (their cold times are logged), so that first uses of the device code
    # (lazy module loads, allocator growth) stay off the compared clocks
    graph, cap = make_graph(args.scale, args.seed)
    for use_pallas in (True, False):
        cold = listing1(graph, use_pallas, cap)[2]
        log(f"cold run (use_pallas={use_pallas}): {json.dumps(cold)}")
    reads, stats, times, launches["listing1"] = listing1(
        graph, True, cap, stash["listing1"])
    A = graph["A"]
    for key, sel in graph["sels"].items():
        same_triples(reads[key], A[sel], f"phase 3 {key} vs Assoc")
        if reads[key].nnz() == 0:
            raise AssertionError(f"phase 3 {key}: empty read")
    tot = {k: stats["Tedge"][k] + stats["TedgeT"][k]
           for k in ("major_compactions", "fused_dispatches",
                     "scan_dispatches", "fused_tiles")}
    for k, v in tot.items():
        if v <= 0:
            raise AssertionError(f"phase 3: {k} = {v}")
    for k in ("rank_batched", "row_rank", "row_merge", "merge_path_rank"):
        if launches["listing1"][k] <= 0:
            raise AssertionError(f"phase 3: kernel {k} never launched")
    log("phase 3 (use_pallas=True): " + json.dumps(
        {"times": times, "engine": tot, "launches": launches["listing1"],
         "nnz": {k: reads[k].nnz() for k in reads}}))

    # 4. the PyTorch-ops path on the card, then both paths again in the
    # other order (kernels, ops, ops, kernels); every read equals phase 3's
    timing = {True: [times], False: []}
    for use_pallas in (False, False, True):
        again = listing1(graph, use_pallas, cap)
        if not use_pallas and any(again[3].values()):
            raise AssertionError(f"phase 4 launched a hand kernel: {again[3]}")
        for key in reads:
            same_triples(again[0][key], reads[key],
                         f"use_pallas={use_pallas} {key} vs phase 3")
        timing[use_pallas].append(again[2])
    log("phase 4 (use_pallas=False): " + json.dumps({"times": timing[False]}))
    log("phase 3-4 timing, kernels, ops, ops, kernels: " + json.dumps(
        {"use_pallas=True": timing[True], "use_pallas=False": timing[False]}))
    if args.profile is not None:  # one more run of each path, traced
        for use_pallas in (True, False):
            traced = listing1(graph, use_pallas, cap, profile_dir=args.profile)
            for key in reads:
                same_triples(traced[0][key], reads[key],
                             f"traced use_pallas={use_pallas} {key}")

    # 4e. the per-run read path, interleaved with the fused read
    ab, perrun = perrun_reads(graph, cap, reads)
    log(f"phase 4e ({smi}): per-run read counters " + json.dumps(perrun))
    log(f"phase 4e ({smi}) timing, fused, per-run, per-run, fused: "
        + json.dumps(ab))

    # 4b-4d. the D4M 2.0 schema and the Fig. 4 reads, Graphulo's SpMV on
    # the schema's Tedge, and the legacy single-run engine, each on both
    # paths; each path's kernel launches are counted from 0 around it
    from repro_torch.db import NaiveTable
    naive = NaiveTable("naive")
    _, t_naive = timed_call(lambda: naive.put_triple(*graph["raw"]))
    log(f"phase 4b: NaiveTable put of {len(graph['raw'][0])} triples "
        f"{t_naive:.3f} s")
    for use_pallas in (False, True):
        g, DB, fl, ft = fig4(graph, cap, use_pallas, naive, args.seed,
                             stash["fig4"] if use_pallas else None)
        log(f"phase 4b (schema, use_pallas={use_pallas}): "
            + json.dumps({"times": ft, "launches": fl}))
        if use_pallas:
            launches["fig4"] = fl
            gt, launches["graphulo"] = graphulo_spmv(g, DB, args.seed,
                                                     stash["graphulo"])
            log("phase 4d (graphulo): " + json.dumps(
                {"times": gt, "launches": launches["graphulo"]}))
        g.delete()
        if DB.ls():
            raise AssertionError(f"tables left after delete: {DB.ls()}")
    for use_pallas in (True, False):
        st, sl = single_engine(graph, cap, use_pallas, reads,
                               stash["single"] if use_pallas else None)
        if use_pallas:
            launches["single"] = sl
        log(f"phase 4c (single engine, use_pallas={use_pallas}): "
            + json.dumps({"times": st, "launches": sl}))
    if args.profile is not None:  # one more run of each path, traced
        for use_pallas in (True, False):
            g, DB, _, _ = fig4(graph, cap, use_pallas, naive, args.seed,
                               profile_dir=args.profile)
            g.delete()
            single_engine(graph, cap, use_pallas, reads,
                          profile_dir=args.profile)

    # 7. a real crash of the pair and its recovery on the card
    launches["recover"] = crash_recovery(graph, cap, reads, times["put_s"],
                                         args, smi, stash["recover"])

    # 8. dynamic tablets (a Zipf stream, its crash and recovery) and the
    # token store, on the card
    t8 = time.perf_counter()
    launches["tablets"], twin_reads = dynamic_tablets(args.seed, smi,
                                                      stash["tablets"])
    launches["tablets_recover"] = tablet_recovery(
        args.seed, smi, stash["tablets_recover"], twin_reads)
    launches["tokens"] = token_pipeline(args.seed, smi, stash["tokens"])
    log(f"phase 8: {time.perf_counter() - t8:.3f} s")

    # 9. the mesh path: 4 SPMD ranks (parts a-c) and a single NCCL rank (d)
    t9 = time.perf_counter()
    launches.update(mesh_path(graph, cap, smi, stash))
    log(f"phase 9: {time.perf_counter() - t9:.3f} s")

    # 6. LM serving at full width
    serve_stats, serve_launches = serving(args.seed, stash, args.profile)
    launches.update(serve_launches)
    for run in ("serve_a", "serve_b"):
        st = serve_stats[run]
        log(f"phase 6 ({run}): " + json.dumps(
            {"tok_per_s": st["tok_per_s"], "wall_s": st["wall_s"],
             "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
             "decode_steps": st["decode_steps"],
             "tokens_out": st["tokens_out"], "batches": st["batches"],
             "launches": serve_launches[run]["flash_attention"]}))
    log(f"phase 6: peak device memory {serve_stats['peak_mem_gb']:.3f} GB")

    # 10. LM training at full width, a crash and a resume; F1's pin
    t10 = time.perf_counter()
    train_stats, launches["train"] = training(args.seed, smi, stash["train"])
    log(f"phase 10 ({smi}): " + json.dumps(train_stats))
    log(f"phase 10: {time.perf_counter() - t10:.3f} s")

    # 13. the launch and mesh tools: MoE expert parallelism over 4 ranks,
    # the op-level cost counter on phase 10's step, the dry runs. It runs
    # here, while the card holds little of the recorded inputs
    t13 = time.perf_counter()
    launches.update(launch_tools(args.seed, smi, stash))
    log(f"phase 13: {time.perf_counter() - t13:.3f} s")

    # 12. the enc-dec and VLM families: serving and training. It runs
    # before phase 11: 12c's AdamW step at internvl2's width and the
    # recorded inputs of phase 11 (its decode caches) do not fit together
    prefix_stats, prefix_launches = prefix_families(args.seed, smi, stash)
    launches.update(prefix_launches)

    # 11. the MoE, Mamba2 and hybrid families: serving and one train step
    family_stats, family_launches = families(args.seed, smi, stash)
    launches.update(family_launches)

    # 5. kernels against their plain versions
    log(f"phase 5: the recorded inputs hold "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB of the card")
    kernels = kernel_checks(stash, launches)
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
