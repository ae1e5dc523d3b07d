"""Graph500 unpermuted power-law Kronecker generator (paper §IV-A, ref [22]).

Scale ``s`` and average degree ``d`` produce 2**s vertices and d * 2**s
edges. 'Unpermuted' = no vertex relabeling pass, exactly as the paper's
ingest benchmark uses. Matches the Graph500 reference kronecker generator
(A, B, C = 0.57, 0.19, 0.19).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

A, B, C = 0.57, 0.19, 0.19


def kronecker_edges(scale: int, edges_per_vertex: int = 16,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(start_vertices, end_vertices) int32 arrays, 0-based ids."""
    m = edges_per_vertex * (1 << scale)
    rng = np.random.default_rng(seed)
    ij = np.zeros((2, m), dtype=np.int64)
    ab = A + B
    c_norm = C / (1.0 - ab)
    a_norm = A / ab
    for ib in range(scale):
        ii_bit = rng.random(m) > ab
        jj_bit = rng.random(m) > (c_norm * ii_bit + a_norm * ~ii_bit)
        ij[0] += (1 << ib) * ii_bit
        ij[1] += (1 << ib) * jj_bit
    return ij[0].astype(np.int32), ij[1].astype(np.int32)


def vertex_strings(ids: np.ndarray) -> np.ndarray:
    """D4M-style string vertex keys ('v0000123') — fixed width so string
    sort order == numeric order (range queries behave)."""
    return np.asarray([f"v{int(i):08d}" for i in ids], dtype=object)


def graph500_triples(scale: int, edges_per_vertex: int = 16, seed: int = 0):
    """(row_strs, col_strs, ones) ready for putTriple."""
    u, v = kronecker_edges(scale, edges_per_vertex, seed)
    return vertex_strings(u), vertex_strings(v), np.ones(len(u), np.float32)
