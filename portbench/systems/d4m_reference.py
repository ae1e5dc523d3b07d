"""The plain reference of the D4M edge tables, in PyTorch and NumPy, beside
``d4m.py``.

It holds what a D4M 2.0 store must hold after a stream of puts, worked out
from the triples the benchmark made, in the order they were acknowledged:
``Tedge`` keeps the last value put at each (row, col) (Accumulo's
versioning iterator), ``TedgeT`` is its transpose, and ``TedgeDeg`` sums one
per triple put into a vertex's out- and in-degree. A read answers with every
entry of ``Tedge`` whose row (or column) is in the selector's vertex set or
inclusive vertex range. Vertices are the numbers behind the keys ``v%08d``:
the keys are fixed width, so a key range is a number range.

It imports nothing of the program and takes nothing the program made.
"""
from __future__ import annotations

import numpy as np
import torch

_LOW = (1 << 32) - 1


def _pack(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    return (rows.to(torch.int64) << 32) | cols.to(torch.int64)


class EdgeReference:
    """Built from the acknowledged triples, concatenated in put order
    (``rows``, ``cols`` vertex numbers, ``vals`` float32), on ``device``."""

    def __init__(self, rows: torch.Tensor, cols: torch.Tensor,
                 vals: torch.Tensor, n_vertices: int):
        key, order = torch.sort(_pack(rows, cols), stable=True)
        last = torch.ones_like(key, dtype=torch.bool)
        last[:-1] = key[1:] != key[:-1]
        self.key = key[last]
        self.val = vals[order][last]
        tkey, t_order = torch.sort(((self.key & _LOW) << 32) | (self.key >> 32))
        self.tkey = tkey
        self.tval = self.val[t_order]
        self.out_deg = torch.bincount(rows.to(torch.int64),
                                      minlength=n_vertices)
        self.in_deg = torch.bincount(cols.to(torch.int64),
                                     minlength=n_vertices)
        self._host = None

    # ---------------------------------------------------------- contents
    def table_wrong(self, rows, cols, vals, transpose: bool = False) -> int:
        """Entries by which a table's contents (vertex numbers, any order)
        differ from ``Tedge`` (or ``TedgeT``): each missing or extra entry
        counts one, a wrong value two (its entry missing, another extra)."""
        ref_key, ref_val = ((self.tkey, self.tval) if transpose
                            else (self.key, self.val))
        dev = ref_key.device
        got_key = _pack(torch.as_tensor(rows, device=dev),
                        torch.as_tensor(cols, device=dev))
        got_val = torch.as_tensor(vals, dtype=torch.float32, device=dev)
        got_key, order = torch.sort(got_key)
        got_val = got_val[order]
        if len(ref_key) == 0 or len(got_key) == 0:
            return len(ref_key) + len(got_key)
        first = torch.ones_like(got_key, dtype=torch.bool)
        first[1:] = got_key[1:] != got_key[:-1]
        idx = torch.searchsorted(ref_key, got_key).clamp(max=len(ref_key) - 1)
        good = first & (ref_key[idx] == got_key) & (ref_val[idx] == got_val)
        return int(len(ref_key) + len(got_key) - 2 * int(good.sum()))

    def degree_wrong(self, out_deg: np.ndarray, in_deg: np.ndarray) -> int:
        """Vertices whose out- or in-degree differs from the count of
        triples put (arrays indexed by vertex number)."""
        dev = self.out_deg.device
        bad = ((torch.as_tensor(out_deg, device=dev) != self.out_deg)
               | (torch.as_tensor(in_deg, device=dev) != self.in_deg))
        return int(bad.sum())

    # ------------------------------------------------------------- reads
    def _csr(self):
        if self._host is None:
            n = len(self.out_deg)
            key = self.key.cpu().numpy()
            tkey = self.tkey.cpu().numpy()
            rows = key >> 32
            tcols = tkey >> 32
            self._host = {
                "row": (key, self.val.cpu().numpy(),
                        np.searchsorted(rows, np.arange(n + 1))),
                "col": (tkey, self.tval.cpu().numpy(),
                        np.searchsorted(tcols, np.arange(n + 1))),
            }
        return self._host

    def answer(self, axis: str, ids=None, lo=None, hi=None):
        """(keys, vals) of a read, keys ``row << 32 | col`` sorted."""
        key, val, ptr = self._csr()[axis]
        if ids is not None:
            starts, ends = ptr[ids], ptr[np.asarray(ids) + 1]
            idx = np.concatenate([np.arange(s, e) for s, e in
                                  zip(starts, ends)] or [np.zeros(0, int)])
        else:
            idx = np.arange(ptr[lo], ptr[hi + 1])
        key, val = key[idx], val[idx]
        if axis == "col":  # stored (col, row): swap back
            key = ((key & _LOW) << 32) | (key >> 32)
        order = np.argsort(key, kind="stable")
        return key[order], val[order]

    @staticmethod
    def same_answer(want, rows, cols, vals) -> bool:
        """A read's answer (vertex numbers, any order) equals ``want``."""
        key = (np.asarray(rows, np.int64) << 32) | np.asarray(cols, np.int64)
        order = np.argsort(key, kind="stable")
        return (np.array_equal(key[order], want[0])
                and np.array_equal(np.asarray(vals, np.float64)[order],
                                   want[1].astype(np.float64)))
