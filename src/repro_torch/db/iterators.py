"""Server-side iterator analogues (Accumulo combiners, paper §III/§VI).

Accumulo attaches combiner iterators to tables (the D4M 2.0 degree table
uses a summing combiner). Here an iterator is a *dedup policy applied during
minor compaction* (`kvstore.tablet_insert`) plus, for dense accumulators,
the `degree_update` fused segment-sum. Graphulo-style server-side GraphBLAS
(the paper's future work) maps to `repro.kernels.spmv` applied shard-side.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class IteratorSpec:
    name: str
    combiner: str   # one of kvstore.COMBINERS
    doc: str


VERSIONING = IteratorSpec("versioning", "last",
                          "Accumulo default: latest write wins.")
SUM_COMBINER = IteratorSpec("sum", "sum",
                            "Summing combiner (D4M 2.0 degree tables).")
MIN_COMBINER = IteratorSpec("min", "min", "Min combiner.")
MAX_COMBINER = IteratorSpec("max", "max", "Max combiner.")

BY_NAME = {s.name: s for s in
           (VERSIONING, SUM_COMBINER, MIN_COMBINER, MAX_COMBINER)}
