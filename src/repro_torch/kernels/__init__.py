"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref.py``). A wrapper launches its kernel for a CUDA tensor and
runs the plain version for a CPU tensor. (``sorted_search`` stays the
subpackage's name here; its wrapper of the same name is
``kernels.sorted_search.sorted_search``.)"""
from .common import I32_MAX, LAUNCHES, reset_launches
from .flash_attention import flash_attention
from .merge_rank import merge_sorted
from .segment_reduce import segment_sum
from .spmv import csr_from_coo, ell_from_coo, spmv_csr, spmv_ell

__all__ = ["I32_MAX", "LAUNCHES", "csr_from_coo", "ell_from_coo",
           "flash_attention", "merge_sorted", "reset_launches", "segment_sum",
           "spmv_csr", "spmv_ell"]
