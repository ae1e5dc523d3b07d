"""Reference connector — the paper's comparison baseline.

The paper benchmarks D4M.jl against Matlab-D4M driving the same Java
connector; the performance gap comes from host-side triple handling. Our
baseline is the equivalent 'straightforward implementation': an unsorted
append log with linear-scan queries, single-stream ingest, no routing, no
sorted runs, no kernels. The optimized connector (`connector.Table`) and
this one expose the same API, so the Fig. 3 / Fig. 4 benchmarks run both.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.assoc import Assoc
from ..core.dictionary import StringDict
from . import batching


class NaiveTable:
    def __init__(self, name: str, char_budget: int = batching.DEFAULT_CHAR_BUDGET):
        self.name = name
        self.keydict = StringDict()
        self.valdict: Optional[StringDict] = None
        self.rows = np.zeros(0, np.int32)
        self.cols = np.zeros(0, np.int32)
        self.vals = np.zeros(0, np.float32)
        self.char_budget = char_budget

    def nnz(self) -> int:
        return len(self.rows)

    def put(self, a: Assoc) -> None:
        self.put_triple(*a.triples())

    def put_triple(self, rows, cols, vals) -> None:
        rows = np.asarray(rows, object)
        cols = np.asarray(cols, object)
        vals = np.asarray(vals)
        for br, bc, bv in batching.batch_triples(rows, cols, vals,
                                                 self.char_budget):
            rid = self.keydict.encode(br)
            cid = self.keydict.encode(bc)
            if bv.dtype.kind in "OUS":
                if self.valdict is None:
                    self.valdict = StringDict()
                v = self.valdict.encode(bv.astype(object)).astype(np.float32) + 1
            else:
                v = bv.astype(np.float32)
            # unsorted append (no routing, no compaction)
            self.rows = np.concatenate([self.rows, rid])
            self.cols = np.concatenate([self.cols, cid])
            self.vals = np.concatenate([self.vals, v])

    putTriple = put_triple

    def __getitem__(self, key) -> Assoc:
        rsel, csel = key
        mask = np.ones(len(self.rows), bool)
        for sel, ids in ((rsel, self.rows), (csel, self.cols)):
            if sel is None or sel == ":" or (isinstance(sel, slice)
                                             and sel == slice(None)):
                continue
            from ..core.assoc import split_str
            toks = split_str(sel) if isinstance(sel, str) else [str(t) for t in sel]
            want = [self.keydict.get(t) for t in toks]
            mask &= np.isin(ids, [w for w in want if w >= 0])  # linear scan
        r, c, v = self.rows[mask], self.cols[mask], self.vals[mask]
        if len(r) == 0:
            return Assoc()
        rows = self.keydict.decode(r)
        cols = self.keydict.decode(c)
        vals = (self.valdict.decode(v.astype(np.int64) - 1)
                if self.valdict is not None else v.astype(np.float64))
        return Assoc(rows, cols, vals)
