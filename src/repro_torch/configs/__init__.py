"""The architecture registry: the JAX package's ``configs/`` copied as data
(``ModelConfig`` here is the port's, whose ``dtype`` is a torch dtype)."""
from .registry import (ARCH_IDS, SHAPES, all_cells, get_config, get_reduced,
                       shapes_for)

__all__ = ["ARCH_IDS", "SHAPES", "all_cells", "get_config", "get_reduced",
           "shapes_for"]
