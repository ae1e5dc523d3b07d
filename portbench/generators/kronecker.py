"""Graph500's unpermuted Kronecker edges, drawn on the device from the run's
seed (a configuration's ``"generator": "kronecker"``).

The generator is Graph500's reference Kronecker generator (A, B, C = 0.57,
0.19, 0.19; arXiv:1808.05138 §IV-A): for each of ``scale`` bits, the row
bit is set with probability 1 - (A + B), and the column bit with C / (C + D)
where the row bit is set and B / (A + B) where it is not. Nothing is
permuted. It draws with a ``torch.Generator`` on the device in a few large
calls, so a graph of millions of edges costs milliseconds of set-up.

A generator module gives ``vertices(cfg)``, the size of the vertex space,
and ``edges(cfg, gen, device)``, one ingestor's graph as (rows, cols) int64
tensors of vertex numbers.
"""
from __future__ import annotations

import torch


def vertices(cfg: dict) -> int:
    return 1 << cfg["scale"]


def edges(cfg: dict, gen: torch.Generator, device) -> tuple:
    return kronecker(cfg["scale"], cfg["edge_factor"],
                     (cfg["kronecker_A"], cfg["kronecker_B"],
                      cfg["kronecker_C"]), gen, device)


def kronecker(scale: int, edge_factor: int, abc, gen: torch.Generator,
              device) -> tuple:
    """(rows, cols) int64 tensors on ``device``: one Graph500 graph of
    ``edge_factor << scale`` edges over ``1 << scale`` vertices."""
    a, b, c = abc
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    m = edge_factor << scale
    rows = torch.zeros(m, dtype=torch.int64, device=device)
    cols = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        draws = torch.rand((2, m), generator=gen, device=device)
        ii = draws[0] > ab
        jj = draws[1] > torch.where(ii, c_norm, a_norm)
        rows += ii.to(torch.int64) << bit
        cols += jj.to(torch.int64) << bit
    return rows, cols
