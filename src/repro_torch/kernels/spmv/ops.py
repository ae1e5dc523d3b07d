"""Public wrappers of the SpMVs: CSR (the associative-array matvec under
``graphulo.table_spmv``) and ELL (the JAX package's format), with the host
COO -> CSR and COO -> ELL conversions. A CUDA tensor goes to the hand
kernel (``csrc/spmv_csr.cu``, ``csrc/spmv_ell.cu``) or raises; a CPU tensor
to the plain version."""
import numpy as np
import torch

from ..common import cdiv, check_cuda, launch
from .ref import spmv_csr_ref, spmv_ell_ref

_CSR_BLOCK = 1024  # entries per block of the CSR kernel: one scratch word each


def ell_from_coo(r: np.ndarray, c: np.ndarray, v: np.ndarray, n_rows: int):
    """Host-side COO (row-major sorted) -> ELL (cols, vals), pad col = -1."""
    counts = np.bincount(r, minlength=n_rows)
    k = max(int(counts.max()) if len(counts) else 1, 1)
    cols = np.full((n_rows, k), -1, dtype=np.int32)
    vals = np.zeros((n_rows, k), dtype=np.float32)
    ends = np.cumsum(counts)
    starts = ends - counts
    slot = np.arange(len(r)) - starts[r]
    cols[r, slot] = c
    vals[r, slot] = v
    return cols, vals


def spmv_ell(cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for ELL ``A`` (``cols``/``vals`` [R, K]): float32 [R].
    Pad columns are -1; a column < 0 or >= len(x) adds 0."""
    cols = cols.to(torch.int32).contiguous()
    vals = vals.to(torch.float32).contiguous()
    x = x.to(torch.float32).reshape(-1).contiguous()
    if cols.dim() != 2 or cols.shape != vals.shape:
        raise ValueError("spmv_ell takes cols[R, K] and vals[R, K]")
    if cols.device.type == "cpu":
        return spmv_ell_ref(cols, vals, x)
    check_cuda("spmv_ell", (cols, torch.int32), (vals, torch.float32),
               (x, torch.float32))
    n_r, k = cols.shape
    y = torch.empty(n_r, dtype=torch.float32, device=cols.device)
    launch("spmv_ell", cols.device, cols.data_ptr(), vals.data_ptr(), n_r, k,
           x.data_ptr(), x.shape[0], y.data_ptr())
    return y


def csr_from_coo(r: np.ndarray, c: np.ndarray, v: np.ndarray, n_rows: int):
    """Host-side COO sorted by row -> CSR (indptr int32 [n_rows + 1], cols
    int32, vals float32)."""
    r = np.asarray(r)
    if len(r) and (r.min() < 0 or r.max() >= n_rows or np.any(r[1:] < r[:-1])):
        raise ValueError("csr_from_coo takes rows sorted, in [0, n_rows)")
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=n_rows), out=indptr[1:])
    if indptr[-1] > np.iinfo(np.int32).max:
        raise ValueError("csr_from_coo: more than 2**31 - 1 entries")
    return (indptr.astype(np.int32), np.asarray(c).astype(np.int32),
            np.asarray(v).astype(np.float32))


def spmv_csr(indptr: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for CSR ``A`` (``indptr`` [R + 1], non-decreasing from 0 to
    nnz; ``cols``/``vals`` [nnz]): float32 [R]. A column < 0 or >= len(x)
    adds 0; duplicate columns accumulate."""
    indptr = indptr.to(torch.int32).contiguous()
    cols = cols.to(torch.int32).contiguous()
    vals = vals.to(torch.float32).contiguous()
    x = x.to(torch.float32).reshape(-1).contiguous()
    if indptr.dim() != 1 or indptr.shape[0] < 1 or cols.dim() != 1 \
            or cols.shape != vals.shape:
        raise ValueError("spmv_csr takes indptr[R + 1], cols[nnz], vals[nnz]")
    if cols.device.type == "cpu":
        return spmv_csr_ref(indptr, cols, vals, x)
    check_cuda("spmv_csr", (indptr, torch.int32), (cols, torch.int32),
               (vals, torch.float32), (x, torch.float32))
    n_r, nnz = indptr.shape[0] - 1, cols.shape[0]
    y = torch.empty(n_r, dtype=torch.float32, device=cols.device)
    blocks = max(1, cdiv(nnz, _CSR_BLOCK))
    carry = torch.empty(blocks, dtype=torch.float32, device=cols.device)
    cross = torch.empty(blocks, dtype=torch.int32, device=cols.device)
    launch("spmv_csr", cols.device, indptr.data_ptr(), n_r, cols.data_ptr(),
           vals.data_ptr(), nnz, x.data_ptr(), x.shape[0], y.data_ptr(),
           carry.data_ptr(), cross.data_ptr())
    return y
