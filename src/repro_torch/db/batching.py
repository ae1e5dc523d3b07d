"""Ingest batching by cumulative character count (paper §V).

"Both Julia and Matlab D4M ingest in batches with approximately 500,000
characters in each batch by default, which has previously been selected to
give the best performance." — we keep the same knob and the same default, so
the paper's batch-size/graph-size crossover (scale 13-14 fits in one batch)
is reproducible in the benchmark.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

DEFAULT_CHAR_BUDGET = 500_000


def triple_chars(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Per-triple character cost (string lengths, as the JVM connector sees)."""
    lens = np.frompyfunc(len, 1, 1)
    n = lens(rows.astype(object)).astype(np.int64)
    n += lens(cols.astype(object)).astype(np.int64)
    if vals.dtype.kind in "OUS":
        n += lens(vals.astype(object)).astype(np.int64)
    else:
        n += 8  # numeric payload serialized width
    return n


def batch_slices(char_costs: np.ndarray,
                 char_budget: int = DEFAULT_CHAR_BUDGET) -> Iterator[slice]:
    """Contiguous slices whose summed char cost is ~budget each."""
    if len(char_costs) == 0:
        return
    cum = np.cumsum(char_costs)
    start = 0
    base = 0
    for i in range(len(cum)):
        if cum[i] - base > char_budget and i > start:
            yield slice(start, i)
            start = i
            base = cum[i - 1]
    yield slice(start, len(cum))


def batch_triples(rows, cols, vals, char_budget: int = DEFAULT_CHAR_BUDGET
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    costs = triple_chars(rows, cols, vals)
    for sl in batch_slices(costs, char_budget):
        yield rows[sl], cols[sl], vals[sl]
