"""Roofline terms of one dry-run step (the JAX package's
``launch/analysis.py``) on the H100.

Hardware model: NVIDIA H100 SXM5 at its 700 W limit, from NVIDIA's data
sheet: 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM3, and
450 GB/s one way per GPU over NVLink 4 (900 GB/s both ways).

  compute    = counted flops (per device)  / PEAK_FLOPS
  memory     = counted bytes (per device)  / HBM_BW
  collective = per-device link traffic     / LINK_BW, the traffic of each
               collective from ring costs over its group of n ranks:
                 all-reduce       2·S·(n-1)/n     (S = per-device payload)
                 all-gather       S_full·(n-1)/n
                 reduce-scatter   S_shard·(n-1)
                 all-to-all       S·(n-1)/n
                 collective-permute  S

A 16-wide mesh axis spans two 8-GPU hosts, whose link is InfiniBand, not
NVLink: the collective term is then a lower bound. The counts come from
``op_cost`` (PyTorch has no HLO: ``parse_collectives``, which reads HLO
text, has no counterpart) and the per-device HBM from the dry run's
counted bytes (XLA's ``memory_analysis`` has none either).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12   # bf16 dense, tensor cores
HBM_BW = 3.35e12      # HBM3
LINK_BW = 450e9       # NVLink 4, one way


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, float]     # per-device link traffic
    link_bytes_total: float


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collectives: CollectiveStats
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float                  # analytic 6·N·D (or 2·N·D fwd-only)
    useful_ratio: float                 # model_flops / (counted flops × chips)
    per_device_hbm_bytes: float         # args + temps of one device
    bytes_lower: float = 0.0            # matmuls, gathers, collectives only
    bytes_upper: float = 0.0            # every op meets HBM


def analyze(cost, n_chips: int, model_flops: float,
            hbm_bytes: float) -> Roofline:
    """The roofline of one device's step from its ``op_cost.Cost``. The
    memory term takes the geometric mean of the two byte counts, as the
    JAX package does: eager PyTorch meets HBM at every op (the upper
    count), a fused step only at the matmuls, gathers and collectives (the
    lower); both are recorded."""
    flops = cost.flops
    byts = (cost.bytes_ideal * cost.bytes) ** 0.5
    colls = CollectiveStats(dict(cost.coll_counts), dict(cost.coll_link),
                            cost.link_bytes)
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    coll_s = colls.link_bytes_total / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops / max(flops * n_chips, 1.0)
    return Roofline(flops, byts, colls, compute_s, memory_s, coll_s,
                    bottleneck, model_flops, useful, float(hbm_bytes),
                    bytes_lower=cost.bytes_ideal, bytes_upper=cost.bytes)


def model_flops_for(cfg, shape_kind: str, seq: int, gb: int) -> float:
    """6·N·D for training, 2·N·D for forward-only steps (N excludes the
    embedding table; MoE uses active params)."""
    n = cfg.n_params_active() - cfg.vocab_padded * cfg.d_model
    if shape_kind == "train":
        return 6.0 * n * seq * gb
    if shape_kind == "prefill":
        return 2.0 * n * seq * gb
    return 2.0 * n * gb  # decode: one token per sequence
