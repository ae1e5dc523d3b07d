"""The D4M vertex keys ``v%08d`` and their reading back. The edges come
from a generator of their own, ``generators/<generator>.py``, that a
configuration names.
"""
from __future__ import annotations

import numpy as np

MAX_VERTICES = 10 ** 8  # eight digits in ``v%08d``


def vertex_names(n: int) -> np.ndarray:
    """The keys ``v%08d`` of vertices 0..n-1 as an object array of str,
    built from digits without formatting one string at a time. Fixed width,
    so string order is numeric order."""
    if n > MAX_VERTICES:
        raise ValueError(f"{n} vertices do not fit eight digits")
    ids = np.arange(n, dtype=np.int64)
    chars = np.empty((n, 9), np.uint8)
    chars[:, 0] = ord("v")
    for k in range(8):
        chars[:, 8 - k] = ord("0") + (ids // 10 ** k) % 10
    return chars.view("S9").ravel().astype("U9").astype(object)


def name_index(names: np.ndarray) -> dict:
    """str -> vertex number, to read the program's answers back."""
    return {s: i for i, s in enumerate(names)}
