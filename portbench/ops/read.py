"""``{"op": "read", "axis": "row"|"col", "select": "ids"|"range", ...}``: a
read of the ``Tedge`` table by row or by column, through the table's
``__getitem__``, each answer an ``Assoc`` on the host.

``ids`` reads ``count`` vertices, ``range`` the ``span`` vertices from
fraction ``at`` of the sorted preloaded vertices. Without a ``degree``,
``ids`` are a systematic sample of the vertices (rows: with out-edges,
``shard: "largest"`` only those of the shard that owns the most; columns:
with in-edges) ordered by degree: a variant's draws take evenly spaced
offsets into the strata, the same for every seed, so that every seed reads
the same spread of degrees, in another order. ``degree`` lists targets, one
variant each (the paper's Fig. 4 buckets): ``count`` vertices drawn from
the ``near`` whose out- (rows) or in-degree (columns) in the preloaded
graphs lies nearest the target.

The mix's ``pool`` read selectors are drawn in set-up (a multiple of the
variants), the variants in turn, permuted when the mix's ``order`` is
``"shuffle"`` (``"cycle"`` keeps them in turn); the window walks the pool
round and round. Every answer is compared with the reference as it stood
when the read was made: all of them where the window put nothing, else
those at a sample, drawn from the seed, of ``PREFIXES`` states.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

PREFIXES = 8


@dataclasses.dataclass(frozen=True)
class Selector:
    """One read: ``axis`` "row" or "col"; ``ids`` (vertex numbers) or the
    inclusive vertex range ``lo..hi``; ``key`` is what the client hands
    the table's ``__getitem__``."""
    axis: str
    key: tuple
    ids: Optional[np.ndarray] = None
    lo: Optional[int] = None
    hi: Optional[int] = None
    tag: str = ""


class Op:
    def __init__(self, specs, mix, cell, rng):
        if not mix.get("preload"):
            raise ValueError("a read mix needs a preloaded graph")
        self.cell = cell
        self.rng = rng
        self.answers = []  # (selector, puts acknowledged, answer)
        pre = cell.graphs[:mix["preload"]]
        u = np.concatenate([g[0] for g in pre])
        v = np.concatenate([g[1] for g in pre])
        n = len(cell.names)
        self.out_deg = np.bincount(u, minlength=n)
        self.in_deg = np.bincount(v, minlength=n)
        self.present = np.flatnonzero((self.out_deg + self.in_deg) > 0)
        self.pool = self._pool(specs, int(mix["pool"]), mix["order"])

    def _pool(self, specs, size, order) -> List[Selector]:
        variants = [(op, d) for op in specs for d in op.get("degree", [None])]
        if size % len(variants):
            raise ValueError(f"a pool of {size} does not split evenly over "
                             f"{len(variants)} variants")
        per = size // len(variants)
        # variant v's k-th draw takes stratum offset (k + 1/2) / per, the
        # same for every seed; the seed orders the draws
        draws = [[self._draw(op, d, (k + 0.5) / per) for k in
                  self.rng.permutation(per)] for op, d in variants]
        pool = [draws[i % len(variants)][i // len(variants)]
                for i in range(size)]
        if order == "shuffle":
            pool = [pool[i] for i in self.rng.permutation(len(pool))]
        elif order != "cycle":
            raise ValueError(f"unknown read order {order!r}")
        return pool

    def _draw(self, op: dict, degree, offset: float) -> Selector:
        axis, names = op["axis"], self.cell.names
        if op["select"] == "range":
            at = int(len(self.present) * float(op["at"]))
            lo = int(self.present[at])
            hi = int(self.present[min(at + int(op["span"]) - 1,
                                      len(self.present) - 1)])
            text = f"{names[lo]},:,{names[hi]},"
            return Selector(axis, _key(axis, text), lo=lo, hi=hi,
                            tag=f"{axis}_range")
        deg = self.out_deg if axis == "row" else self.in_deg
        cand = np.flatnonzero(deg > 0)
        count = int(op["count"])
        tag = f"{axis}_ids{count}"
        if op.get("shard") == "largest":
            shards, ids_cap = self.cell.num_shards, self.cell.id_capacity
            owner = np.minimum(cand * shards // ids_cap, shards - 1)
            cand = cand[owner == np.argmax(
                np.bincount(owner, minlength=shards))]
        if degree is not None:
            tag += f"_deg{degree}"
            # nearest in log degree; ties fall in a random order
            cand = self.rng.permutation(cand)
            dist = np.abs(np.log(deg[cand]) - np.log(degree))
            near = cand[np.argsort(dist, kind="stable")[:int(op["near"])]]
            ids = self.rng.choice(near, count, replace=False)
        else:
            cand = cand[np.argsort(deg[cand], kind="stable")]
            at = (np.arange(count) + offset) * len(cand) / count
            ids = cand[at.astype(np.int64)]
        if len(np.unique(ids)) < count:
            raise ValueError(f"{tag}: {len(cand)} vertices, {count} needed")
        ids = np.sort(ids)
        text = ",".join(names[ids]) + ","
        return Selector(axis, _key(axis, text), ids=ids, tag=tag)

    # ------------------------------------------------------------ window
    def warm(self) -> None:
        """The store's read path, then each read shape once."""
        self.cell.warm_reads()
        for sel in self.pool[:16]:
            self.cell.read(sel.key)

    def __iter__(self):
        while True:
            for sel in self.pool:
                yield sel.tag, (lambda sel=sel: self._read(sel))

    def _read(self, sel) -> int:
        a = self.cell.read(sel.key)
        self.answers.append((sel, len(self.cell.acked), a))
        return a.nnz()

    # ------------------------------------------------------------- check
    def collect(self) -> None:
        self.answers = [(sel, k, self.cell.numbers(*a.triples()))
                        for sel, k, a in self.answers]

    def judge(self) -> dict:
        if not self.answers:
            return {}
        states = sorted({k for _, k, _ in self.answers})
        if len(states) > PREFIXES:
            states = sorted(self.rng.choice(states, PREFIXES, replace=False))
        wrong = 0
        for k in states:
            ref = self.cell.reference(k)
            for sel, at, (r, c, v) in self.answers:
                if at == k:
                    want = ref.answer(sel.axis, ids=sel.ids, lo=sel.lo,
                                      hi=sel.hi)
                    wrong += not ref.same_answer(want, r, c, v)
        return {"answers_wrong": (wrong, 0)}


def _key(axis: str, text: str) -> tuple:
    return (text, ":") if axis == "row" else (":", text)
