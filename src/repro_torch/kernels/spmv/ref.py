"""Plain PyTorch version of the ELL SpMV (what the CUDA kernel is held
against).

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
