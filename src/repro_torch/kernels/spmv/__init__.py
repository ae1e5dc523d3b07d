from .ops import ell_from_coo, spmv_ell
from .ref import spmv_ell_ref

__all__ = ["ell_from_coo", "spmv_ell", "spmv_ell_ref"]
