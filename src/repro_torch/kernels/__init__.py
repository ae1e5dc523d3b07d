"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref.py``). A wrapper launches its kernel for a CUDA tensor and
runs the plain version for a CPU tensor."""
from .common import I32_MAX, LAUNCHES, reset_launches

__all__ = ["I32_MAX", "LAUNCHES", "reset_launches"]
