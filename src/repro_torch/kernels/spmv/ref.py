"""Plain PyTorch versions of the ELL and CSR SpMVs (what the CUDA kernels
are held against).

Columns outside ``x`` follow the JAX wrapper ``spmv_ell`` (its kernel pads
``x`` with zeros to the block width and masks columns past it, so any
column >= len(x) adds 0), not the JAX ``spmv_ell_ref``, which clips such a
column to ``x[-1]``.
"""
import torch


def spmv_ell_ref(cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """y[r] = sum_k vals[r,k] * x[cols[r,k]]; entries with col < 0 or
    col >= len(x) dropped."""
    n_x = x.shape[0]
    valid = (cols >= 0) & (cols < n_x)
    xp = torch.cat([x, x.new_zeros(1)])  # invalid columns read the 0
    xi = xp[torch.where(valid, cols, n_x).long()]
    return torch.where(valid, vals * xi, 0.0).sum(dim=1)


def spmv_csr_ref(indptr: torch.Tensor, cols: torch.Tensor,
                 vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[r] = sum over e in [indptr[r], indptr[r+1]) of vals[e] *
    x[cols[e]]: float32 [len(indptr) - 1]; entries with col < 0 or
    col >= len(x) dropped, duplicate columns accumulate."""
    n_rows, n_x = indptr.shape[0] - 1, x.shape[0]
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=cols.device),
        (indptr[1:] - indptr[:-1]).long(), output_size=cols.shape[0])
    valid = (cols >= 0) & (cols < n_x)
    xp = torch.cat([x, x.new_zeros(1)])  # invalid columns read the 0
    terms = torch.where(valid, vals * xp[torch.where(valid, cols, n_x).long()],
                        0.0)
    y = torch.zeros(n_rows, dtype=torch.float32, device=cols.device)
    return y.index_add_(0, rows, terms)
