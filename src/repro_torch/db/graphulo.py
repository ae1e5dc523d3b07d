"""Graphulo-style server-side GraphBLAS ops — the paper's §VI future work.

Graphulo implements GraphBLAS kernels as Accumulo server-side iterators so
graph algorithms run *inside* the database. The analogue here: operate on
the shard-resident tablet arrays directly (no client round-trip through
string space), using the CSR SpMV kernel / vectorized SpGEMM on the
dictionary-encoded ids, and write results back through the combiner path.

Provided kernels (GraphBLAS-style over the arithmetic semiring):
  * ``table_spmv``  — y = A @ x           (BFS / PageRank steps)
  * ``table_spgemm``— C = A @ B           (multi-hop reachability), result
                      ingested into a new table with a sum combiner
  * ``table_tricount`` — triangle counting via C = A @ A masked by A
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import sparsegemm as sg
from ..kernels.spmv import csr_from_coo, spmv_csr
from .connector import DBserver, Table, TablePair


def _table_coo(table: Table):
    """Server-side view: dictionary-encoded triples straight off the shards."""
    r, c, v = table.store.scan()
    order = np.lexsort((c, r))
    return r[order].astype(np.int64), c[order].astype(np.int64), \
        v[order].astype(np.float64)


def _dim(server: DBserver) -> int:
    return len(server.keydict)


def table_spmv(table, x: np.ndarray, use_pallas: bool = False) -> np.ndarray:
    """y = A @ x over vertex-id space (x indexed by key id), on the table's
    device.

    ``use_pallas=True`` builds the CSR of the table's row-sorted scan on
    the host and runs the SpMV kernel (float32, one entry per key id);
    otherwise a COO ``index_add_`` in float64, sized by the largest row id
    + 1 (the JAX host product's shape)."""
    t = table.table if isinstance(table, TablePair) else table
    r, c, v = _table_coo(t)
    n = _dim(t.server)
    dev = t.store.device
    if use_pallas:
        indptr, cols, vals = csr_from_coo(r, c, v, n)
        y = spmv_csr(*(torch.as_tensor(a, device=dev)
                       for a in (indptr, cols, vals)),
                     torch.as_tensor(np.asarray(x, np.float32), device=dev))
        return y.cpu().numpy()
    rows = torch.as_tensor(r, device=dev)
    xd = torch.as_tensor(np.asarray(x, np.float64), device=dev)
    terms = torch.as_tensor(v, device=dev) * xd[torch.as_tensor(c, device=dev)]
    n_out = min(int(r.max()) + 1 if len(r) else 0, n)
    y = torch.zeros(n_out, dtype=torch.float64, device=dev)
    return y.index_add_(0, rows, terms).cpu().numpy()


def table_spgemm(table_a, table_b, server: DBserver,
                 out_name: Optional[str] = None):
    """C = A @ B server-side; optionally ingest C into ``out_name``.

    Returns (rows, cols, vals) id-space triples; when ``out_name`` is given
    the result lands in a new table through the normal combiner path and is
    queryable with Listing-1 syntax immediately.
    """
    ta = table_a.table if isinstance(table_a, TablePair) else table_a
    tb = table_b.table if isinstance(table_b, TablePair) else table_b
    a = _table_coo(ta)
    b = _table_coo(tb)
    n = _dim(server)
    rr, cc, vv = sg.spgemm(a, b, n)
    if out_name is not None:
        out = server[out_name]
        keys = server.keydict.decode(np.arange(n))
        out.put_triple(keys[rr], keys[cc], vv)
        return out
    return rr, cc, vv


def table_tricount(pair: TablePair, server: DBserver) -> int:
    """Triangles = sum(A ∘ (A @ A)) / 6 on the symmetrized pattern."""
    t = pair.table if isinstance(pair, TablePair) else pair
    r, c, v = _table_coo(t)
    keep = r != c                                     # drop self loops
    r, c = r[keep], c[keep]
    # symmetrize the pattern
    rs = np.concatenate([r, c])
    cs = np.concatenate([c, r])
    rs, cs, vs = sg.coalesce(rs, cs, np.ones(len(rs)), "max")
    n = _dim(server)
    rr, cc, vv = sg.spgemm((rs, cs, vs), (rs, cs, vs), n)
    # hadamard mask with A: count paths of length 2 that close
    akeys = set(zip(rs.tolist(), cs.tolist()))
    total = sum(val for a, b, val in zip(rr.tolist(), cc.tolist(), vv.tolist())
                if (a, b) in akeys)
    return int(round(total / 6.0))
