"""Vectorized host-side sparse kernels backing associative-array algebra.

COO triples (r, c, v) with int64 indices. All routines are pure numpy and
fully vectorized (no Python loops over nnz) — these are the host analogues;
the device hot paths live in ``repro_torch.kernels``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

Coo = Tuple[np.ndarray, np.ndarray, np.ndarray]


def coalesce(r: np.ndarray, c: np.ndarray, v: np.ndarray, op: str = "sum") -> Coo:
    """Sort row-major and combine duplicate (r, c) entries with ``op``."""
    if len(r) == 0:
        return r.astype(np.int64), c.astype(np.int64), v
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    new = np.empty(len(r), dtype=bool)
    new[0] = True
    new[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    starts = np.flatnonzero(new)
    if len(starts) == len(r):
        return r, c, v
    if op == "sum":
        vv = np.add.reduceat(v, starts)
    elif op == "min":
        vv = np.minimum.reduceat(v, starts)
    elif op == "max":
        vv = np.maximum.reduceat(v, starts)
    elif op == "first":
        vv = v[starts]
    elif op == "last":
        ends = np.append(starts[1:], len(r)) - 1
        vv = v[ends]
    else:
        raise ValueError(f"unknown collision op {op!r}")
    return r[starts], c[starts], vv


def csr_from_coo(r: np.ndarray, c: np.ndarray, v: np.ndarray, n_rows: int):
    """(indptr, cols, vals) — assumes coalesced, row-major-sorted input."""
    counts = np.bincount(r, minlength=n_rows)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, c, v


def _segment_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0-1, 0..c1-1, ...] for counts ci, vectorized."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(counts)
    starts = ends - counts
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


def spgemm(a: Coo, b: Coo, n_inner: int) -> Coo:
    """C = A @ B for COO operands; inner dimension size ``n_inner``.

    Join A's column index against B's row index through B's CSR indptr,
    expand all products, then coalesce with sum — the classic expand/
    sort/contract SpGEMM, fully vectorized.
    """
    ar, ac, av = a
    br, bc, bv = b
    if len(ar) == 0 or len(br) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), np.zeros(0, dtype=np.float64)
    indptr, bcols, bvals = csr_from_coo(br, bc, bv, n_inner)
    starts = indptr[ac]
    counts = indptr[ac + 1] - starts
    b_idx = np.repeat(starts, counts) + _segment_arange(counts)
    out_r = np.repeat(ar, counts)
    out_c = bcols[b_idx]
    out_v = np.repeat(av, counts) * bvals[b_idx]
    return coalesce(out_r, out_c, out_v, "sum")


def spmv(a: Coo, x: np.ndarray) -> np.ndarray:
    """y = A @ x with dense x; returns dense y sized by max row index + 1."""
    ar, ac, av = a
    n = int(ar.max()) + 1 if len(ar) else 0
    y = np.zeros(n, dtype=np.float64)
    np.add.at(y, ar, av * x[ac])
    return y


def union_keys(a: np.ndarray, b: np.ndarray):
    """Union of two sorted unique key arrays + index maps into the union."""
    u = np.union1d(a, b)
    return u, np.searchsorted(u, a), np.searchsorted(u, b)


def intersect_maps(a: np.ndarray, b: np.ndarray):
    """Intersection of sorted unique arrays + positions in each operand."""
    inter, ia, ib = np.intersect1d(a, b, assume_unique=True, return_indices=True)
    return inter, ia, ib
