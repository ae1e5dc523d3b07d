"""Public wrapper of the ELL SpMV (the associative-array matvec under
``graphulo.table_spmv``) and the host COO -> ELL conversion. A CUDA tensor
goes to the hand kernel (``csrc/spmv_ell.cu``); a CPU tensor to the plain
version."""
import numpy as np
import torch

from ..common import check_cuda, launch
from .ref import spmv_ell_ref


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
