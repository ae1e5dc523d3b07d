from .ops import csr_from_coo, ell_from_coo, spmv_csr, spmv_ell
from .ref import spmv_csr_ref, spmv_ell_ref

__all__ = ["csr_from_coo", "ell_from_coo", "spmv_csr", "spmv_csr_ref",
           "spmv_ell", "spmv_ell_ref"]
