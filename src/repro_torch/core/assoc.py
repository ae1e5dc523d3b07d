"""Associative arrays — the paper's core data structure (paper §II).

An :class:`Assoc` maps pairs of string keys to string or numeric values,
behaves like a sparse matrix over sorted-unique key sets, and supports the
composable indexing and algebra from the paper:

    A['alice,', :]          row query            A['alice,bob,', :]
    A['al*,', :]            prefix query         A['alice,:,bob,', :]  range
    A[1:2, :]               positional           A == 47.0             filter
    A + B   A - B   A & B   A | B   A * B        (results are Assocs)

Conventions (matching D4M/D4M.jl):
  * A string selector's **last character is the delimiter** — 'a,b,' is the
    list ['a', 'b'].
  * String values are dictionary-encoded: ``val`` holds sorted-unique value
    strings and the numeric payload stores 1-based ids into it.
  * Arithmetic on string-valued arrays operates on the logical pattern
    (``logical()`` is applied first), as in D4M.
  * Duplicate (row, col) construction entries collapse with ``func``
    (default: numeric sum — MATLAB ``sparse()`` semantics; strings: min).
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple, Union

import numpy as np

from . import sparsegemm as sg

__all__ = ["Assoc", "split_str"]


def split_str(s: str) -> np.ndarray:
    """Split a D4M-style delimited string; the last char is the delimiter."""
    if len(s) == 0:
        return np.zeros(0, dtype=object)
    sep = s[-1]
    parts = s.split(sep)[:-1]
    return np.asarray(parts, dtype=object)


def _as_key_array(x) -> np.ndarray:
    """Normalize row/col constructor input to an object array of str."""
    if isinstance(x, str):
        return split_str(x)
    if isinstance(x, (int, float)):
        return np.asarray([str(x)], dtype=object)
    arr = np.asarray(x, dtype=object)
    if arr.ndim == 0:
        arr = arr[None]
    return np.asarray([str(e) for e in arr.ravel()], dtype=object)


def _as_val_array(x) -> Tuple[np.ndarray, bool]:
    """Normalize values; returns (array, is_numeric)."""
    if isinstance(x, str):
        return split_str(x), False
    if isinstance(x, (int, float, np.integer, np.floating)):
        return np.asarray([x], dtype=np.float64), True
    arr = np.asarray(x)
    if arr.ndim == 0:
        arr = arr[None]
    if arr.dtype.kind in "ifub":
        return arr.astype(np.float64).ravel(), True
    return np.asarray([str(e) for e in arr.ravel()], dtype=object), False


def _condense(keys: np.ndarray, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Drop unreferenced keys; remap indices. keys sorted unique."""
    used = np.unique(idx)
    return keys[used], np.searchsorted(used, idx)


class Assoc:
    """Sparse associative array over sorted-unique string key sets."""

    __hash__ = object.__hash__  # __eq__ is a query operator, keep hashable

    def __init__(self, row="", col="", val=1.0, func: Optional[str] = None):
        rows = _as_key_array(row)
        cols = _as_key_array(col)
        vals, numeric = _as_val_array(val)
        if len(rows) == 0 or len(cols) == 0 or len(vals) == 0:
            rows = np.zeros(0, dtype=object)
            cols = np.zeros(0, dtype=object)
            vals = np.zeros(0, dtype=np.float64) if numeric else np.zeros(0, object)
        n = max(len(rows), len(cols), len(vals))
        if len(rows) not in (1, n) or len(cols) not in (1, n) or len(vals) not in (1, n):
            raise ValueError(
                f"length mismatch: rows={len(rows)} cols={len(cols)} vals={len(vals)}"
            )
        if n and len(rows) == 1:
            rows = np.repeat(rows, n)
        if n and len(cols) == 1:
            cols = np.repeat(cols, n)
        if n and len(vals) == 1:
            vals = np.repeat(vals, n)

        if numeric:
            keep = vals != 0.0
            rows, cols, vals = rows[keep], cols[keep], vals[keep]
            n = len(rows)

        self.row, r = np.unique(rows, return_inverse=True)
        self.col, c = np.unique(cols, return_inverse=True)
        if numeric:
            self.val = None
            v = vals
        else:
            self.val, vi = np.unique(vals, return_inverse=True)
            v = (vi + 1).astype(np.float64)  # 1-based ids, D4M style
        func = func or ("sum" if numeric else "min")
        r, c, v = sg.coalesce(r.astype(np.int64), c.astype(np.int64), v, func)
        self.r, self.c, self.v = r, c, v
        if not numeric:
            self._condense_vals()
        else:
            self._drop_zeros()
        self._condense_keys()

    # ------------------------------------------------------------- internals
    @classmethod
    def _from_parts(cls, row, col, val, r, c, v) -> "Assoc":
        a = cls.__new__(cls)
        a.row, a.col, a.val = row, col, val
        a.r, a.c, a.v = r.astype(np.int64), c.astype(np.int64), v.astype(np.float64)
        a._condense_keys()
        if a.val is None:
            a._drop_zeros()
        else:
            a._condense_vals()
        return a

    def _drop_zeros(self) -> None:
        keep = self.v != 0.0
        if not keep.all():
            self.r, self.c, self.v = self.r[keep], self.c[keep], self.v[keep]
            self._condense_keys(force=True)

    def _condense_keys(self, force: bool = False) -> None:
        if len(self.r) == 0:
            self.row = self.row[:0]
            self.col = self.col[:0]
            return
        if force or len(np.unique(self.r)) != len(self.row):
            self.row, self.r = _condense(self.row, self.r)
        if force or len(np.unique(self.c)) != len(self.col):
            self.col, self.c = _condense(self.col, self.c)

    def _condense_vals(self) -> None:
        if self.val is None:
            return
        ids = self.v.astype(np.int64) - 1
        used = np.unique(ids)
        if len(used) != len(self.val):
            self.val = self.val[used]
            self.v = (np.searchsorted(used, ids) + 1).astype(np.float64)

    # ------------------------------------------------------------ properties
    @property
    def shape(self) -> Tuple[int, int]:
        return (len(self.row), len(self.col))

    def nnz(self) -> int:
        return len(self.v)

    def is_numeric(self) -> bool:
        return self.val is None

    def triples(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(row_strs, col_strs, values) — values str array in string mode."""
        rows = self.row[self.r]
        cols = self.col[self.c]
        if self.val is None:
            return rows, cols, self.v.copy()
        return rows, cols, self.val[self.v.astype(np.int64) - 1]

    find = triples

    def getval(self) -> np.ndarray:
        return self.v.copy() if self.val is None else self.val.copy()

    def logical(self) -> "Assoc":
        """Pattern of the array: every stored entry becomes 1.0 (numeric)."""
        return Assoc._from_parts(
            self.row.copy(), self.col.copy(), None,
            self.r.copy(), self.c.copy(), np.ones(len(self.v)),
        )

    def to_dense(self) -> np.ndarray:
        d = np.zeros(self.shape)
        d[self.r, self.c] = self.v
        return d

    def transpose(self) -> "Assoc":
        order = np.lexsort((self.r, self.c))
        return Assoc._from_parts(
            self.col.copy(), self.row.copy(),
            None if self.val is None else self.val.copy(),
            self.c[order], self.r[order], self.v[order],
        )

    @property
    def T(self) -> "Assoc":
        return self.transpose()

    # ------------------------------------------------------------- indexing
    def _resolve(self, sel, keys: np.ndarray) -> np.ndarray:
        """Selector -> sorted array of indices into ``keys``."""
        n = len(keys)
        if sel is None or (isinstance(sel, slice) and sel == slice(None)):
            return np.arange(n, dtype=np.int64)
        if isinstance(sel, str) and sel == ":":
            return np.arange(n, dtype=np.int64)
        if isinstance(sel, slice):  # positional
            return np.arange(n, dtype=np.int64)[sel]
        if isinstance(sel, (int, np.integer)):
            return np.asarray([sel], dtype=np.int64)
        if isinstance(sel, str):
            toks = split_str(sel)
        else:
            arr = np.asarray(sel)
            if arr.dtype.kind in "iu":
                return arr.astype(np.int64).ravel()
            toks = np.asarray([str(t) for t in arr.ravel()], dtype=object)
        if len(toks) == 3 and toks[1] == ":":  # 'a,:,b,' range (inclusive)
            lo = np.searchsorted(keys, toks[0], side="left")
            hi = np.searchsorted(keys, toks[2], side="right")
            return np.arange(lo, hi, dtype=np.int64)
        out = []
        for t in toks:
            if t.endswith("*"):  # prefix glob
                pre = t[:-1]
                lo = np.searchsorted(keys, pre, side="left")
                hi = np.searchsorted(keys, pre + "￿", side="right")
                out.append(np.arange(lo, hi, dtype=np.int64))
            else:
                i = np.searchsorted(keys, t)
                if i < n and keys[i] == t:
                    out.append(np.asarray([i], dtype=np.int64))
        if not out:
            return np.zeros(0, dtype=np.int64)
        return np.unique(np.concatenate(out))

    def __getitem__(self, key) -> "Assoc":
        if not isinstance(key, tuple) or len(key) != 2:
            raise TypeError("Assoc indexing is 2-D: a[rows, cols]")
        rsel, csel = key
        ri = self._resolve(rsel, self.row)
        ci = self._resolve(csel, self.col)
        mask = np.isin(self.r, ri) & np.isin(self.c, ci)
        return Assoc._from_parts(
            self.row.copy(), self.col.copy(),
            None if self.val is None else self.val.copy(),
            self.r[mask], self.c[mask], self.v[mask],
        )

    # ----------------------------------------------------- value comparisons
    def _value_mask(self, op, other) -> "Assoc":
        if isinstance(other, str):
            if self.val is None:
                vals = np.asarray([str(x) for x in self.v], dtype=object)
            else:
                vals = self.val[self.v.astype(np.int64) - 1]
            mask = op(vals, other)
        else:
            if self.val is not None:
                raise TypeError("numeric comparison on string-valued Assoc")
            mask = op(self.v, other)
        return Assoc._from_parts(
            self.row.copy(), self.col.copy(),
            None if self.val is None else self.val.copy(),
            self.r[mask], self.c[mask], self.v[mask],
        )

    def __eq__(self, other):  # noqa: D105 — D4M query operator
        if isinstance(other, Assoc):
            return self._elementwise_equal(other)
        return self._value_mask(lambda a, b: a == b, other)

    def __ne__(self, other):
        if isinstance(other, Assoc):
            raise TypeError("use same_as() for structural comparison")
        return self._value_mask(lambda a, b: a != b, other)

    def __gt__(self, other):
        return self._value_mask(lambda a, b: a > b, other)

    def __ge__(self, other):
        return self._value_mask(lambda a, b: a >= b, other)

    def __lt__(self, other):
        return self._value_mask(lambda a, b: a < b, other)

    def __le__(self, other):
        return self._value_mask(lambda a, b: a <= b, other)

    def _elementwise_equal(self, other: "Assoc") -> "Assoc":
        ar, ac, av = self.triples()
        br, bc, bv = other.triples()
        mine = {(r, c): v for r, c, v in zip(ar, ac, av)}
        keep_r, keep_c = [], []
        for r, c, v in zip(br, bc, bv):
            w = mine.get((r, c))
            if w is not None and w == v:
                keep_r.append(r)
                keep_c.append(c)
        if not keep_r:
            return Assoc()
        return Assoc(np.asarray(keep_r, object), np.asarray(keep_c, object), 1.0)

    def same_as(self, other: "Assoc") -> bool:
        """Structural equality (keys, pattern, values)."""
        if self.shape != other.shape or self.nnz() != other.nnz():
            return False
        a, b = self.triples(), other.triples()
        return all(np.array_equal(x, y) for x, y in zip(a, b))

    # -------------------------------------------------------------- algebra
    def _numeric(self) -> "Assoc":
        return self if self.val is None else self.logical()

    def _aligned_coo(self, other: "Assoc"):
        a, b = self._numeric(), other._numeric()
        urow, ra, rb = sg.union_keys(a.row, b.row)
        ucol, ca, cb = sg.union_keys(a.col, b.col)
        r = np.concatenate([ra[a.r], rb[b.r]])
        c = np.concatenate([ca[a.c], cb[b.c]])
        v = np.concatenate([a.v, b.v])
        both = np.concatenate([np.ones(len(a.v)), np.ones(len(b.v))])
        return urow, ucol, r, c, v, both

    def __add__(self, other: "Assoc") -> "Assoc":
        urow, ucol, r, c, v, _ = self._aligned_coo(other)
        r, c, v = sg.coalesce(r, c, v, "sum")
        return Assoc._from_parts(urow, ucol, None, r, c, v)

    def __sub__(self, other: "Assoc") -> "Assoc":
        b = other._numeric()
        neg = Assoc._from_parts(b.row.copy(), b.col.copy(), None, b.r, b.c, -b.v)
        return self + neg

    def __or__(self, other: "Assoc") -> "Assoc":
        urow, ucol, r, c, v, _ = self._aligned_coo(other)
        r, c, v = sg.coalesce(r, c, v, "max")
        return Assoc._from_parts(urow, ucol, None, r, c, v)

    def __and__(self, other: "Assoc") -> "Assoc":
        urow, ucol, r, c, v, cnt = self._aligned_coo(other)
        rm, cm, vm = sg.coalesce(r, c, v, "min")
        _, _, n = sg.coalesce(r, c, cnt, "sum")
        keep = n >= 2.0  # present in both operands
        return Assoc._from_parts(urow, ucol, None, rm[keep], cm[keep], vm[keep])

    def __mul__(self, other):
        if isinstance(other, (int, float, np.floating, np.integer)):
            a = self._numeric()
            return Assoc._from_parts(
                a.row.copy(), a.col.copy(), None, a.r, a.c, a.v * float(other)
            )
        a, b = self._numeric(), other._numeric()
        inner, ia, ib = sg.intersect_maps(a.col, b.row)
        if len(inner) == 0 or a.nnz() == 0 or b.nnz() == 0:
            return Assoc()
        # remap both operands into the shared inner index space
        amask = np.isin(a.c, ia)
        bmask = np.isin(b.r, ib)
        a_inner = np.searchsorted(ia, a.c[amask])
        b_inner = np.searchsorted(ib, b.r[bmask])
        order = np.lexsort((np.zeros(bmask.sum(), np.int64), b_inner))
        rr, cc, vv = sg.spgemm(
            (a.r[amask], a_inner, a.v[amask]),
            (b_inner[order], b.c[bmask][order], b.v[bmask][order]),
            len(inner),
        )
        return Assoc._from_parts(a.row.copy(), b.col.copy(), None, rr, cc, vv)

    __rmul__ = __mul__

    def sum(self, axis: Optional[int] = None, key: str = "sum"):
        """Numeric sum; axis=None -> scalar, 1 -> per-row, 0 -> per-col."""
        a = self._numeric()
        if axis is None:
            return float(a.v.sum())
        k = np.asarray([key], dtype=object)  # literal key, no delimiter split
        if axis == 1:
            tot = np.zeros(len(a.row))
            np.add.at(tot, a.r, a.v)
            return Assoc(a.row, k, tot)
        tot = np.zeros(len(a.col))
        np.add.at(tot, a.c, a.v)
        return Assoc(k, a.col, tot)

    # ------------------------------------------------------------- printing
    def __repr__(self) -> str:
        r, c, v = self.triples()
        lines = [f"Assoc {self.shape[0]}x{self.shape[1]} nnz={self.nnz()}"]
        for i in range(min(len(r), 16)):
            lines.append(f"  ({r[i]!r}, {c[i]!r}) -> {v[i]!r}")
        if len(r) > 16:
            lines.append(f"  ... {len(r) - 16} more")
        return "\n".join(lines)

    def printfull(self) -> str:
        r, c, _ = self.triples()
        out = [" " * 12 + " ".join(f"{k:>10}" for k in self.col)]
        d = self.to_dense() if self.val is None else None
        for i, rk in enumerate(self.row):
            cells = []
            for j in range(len(self.col)):
                if d is not None:
                    cells.append(f"{d[i, j]:>10g}" if d[i, j] else " " * 10)
                else:
                    m = (self.r == i) & (self.c == j)
                    cells.append(
                        f"{self.val[int(self.v[m][0]) - 1]:>10}" if m.any() else " " * 10
                    )
            out.append(f"{rk:>12}" + " ".join(cells))
        return "\n".join(out)
