"""Dynamic tablet map: row-range → tablet → owning shard (Accumulo model).

A copy of the JAX package's ``repro.db.tablets`` (numpy only): the same
calls give the same splits, ids, owners and float64 loads in both
packages, and the manifest record is the same dict.

``ShardedTable`` routes rows with the static ``shard_of`` (uniform range
pre-split) unless it runs with ``dynamic_tablets=True``. Real traffic is
Zipfian: one hot key range saturates a shard while its peers idle.
Accumulo's answer is *tablets* — contiguous row ranges that SPLIT when hot
and MIGRATE between tablet servers to balance load. This module is the map
of that state:

  * ``splits``     — sorted interior boundary keys; tablet ``i`` owns
                     ``[splits[i-1], splits[i])`` (first/last tablet
                     extend to 0 / ``id_capacity``);
  * ``tablet_ids`` — STABLE identity per tablet. A split keeps the left
                     half's id and mints a fresh one for the right; a
                     move never changes ids. WAL frames tag batches with
                     the tablet id, so "replay only my tablets' suffix"
                     is a well-defined filter at ANY log point;
  * ``owners``     — physical shard currently serving each tablet;
  * ``loads``      — decayed ingest/query entry counts per tablet, the
                     split/rebalance policy signal.

``TabletMap.uniform`` reproduces ``shard_of`` exactly (same boundaries,
owner ``i`` for tablet ``i``), so enabling ``dynamic_tablets`` changes
nothing until the first split. The map round-trips through the snapshot
manifest (format 3, ``lsm.manifest``) and splits/moves journal as WAL
meta frames, so recovery rebuilds the exact topology.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class TabletMap:
    """Mutable row-range partition with stable tablet identities."""

    def __init__(self, splits: np.ndarray, tablet_ids: np.ndarray,
                 owners: np.ndarray, id_capacity: int, num_shards: int,
                 next_id: int, loads: Optional[np.ndarray] = None):
        self.splits = np.asarray(splits, np.int64)
        self.tablet_ids = np.asarray(tablet_ids, np.int32)
        self.owners = np.asarray(owners, np.int32)
        self.id_capacity = int(id_capacity)
        self.num_shards = int(num_shards)
        self.next_id = int(next_id)
        self.loads = (np.zeros(len(self.tablet_ids), np.float64)
                      if loads is None else np.asarray(loads, np.float64))
        if len(self.splits) != len(self.tablet_ids) - 1:
            raise ValueError("splits must have one fewer entry than tablets")
        if (np.diff(self.splits) <= 0).any():
            raise ValueError("splits must be strictly increasing")

    # ------------------------------------------------------------ factory
    @classmethod
    def uniform(cls, num_shards: int, id_capacity: int) -> "TabletMap":
        """One tablet per shard with the SAME boundaries as ``shard_of``:
        tablet ``s`` owns ``[ceil(s*cap/S), ceil((s+1)*cap/S))`` — the id
        ranges the static hash already assigns, so a fresh dynamic table
        routes identically to a static one until the first split."""
        s = np.arange(1, num_shards, dtype=np.int64)
        splits = -(-(s * id_capacity) // num_shards)  # ceil
        return cls(splits, np.arange(num_shards, dtype=np.int32),
                   np.arange(num_shards, dtype=np.int32),
                   id_capacity, num_shards, next_id=num_shards)

    # ------------------------------------------------------------ lookup
    @property
    def n(self) -> int:
        return len(self.tablet_ids)

    def tablet_of(self, ids: np.ndarray) -> np.ndarray:
        """Tablet INDEX (not id) per row id."""
        return np.searchsorted(self.splits, np.asarray(ids, np.int64),
                               side="right")

    def owner_of(self, ids: np.ndarray) -> np.ndarray:
        """Owner shard per row id (the dynamic ``shard_of``)."""
        return self.owners[self.tablet_of(ids)].astype(np.int32)

    def index_of(self, tablet_id: int) -> int:
        idx = np.flatnonzero(self.tablet_ids == np.int32(tablet_id))
        if len(idx) != 1:
            raise KeyError(f"unknown tablet id {tablet_id}")
        return int(idx[0])

    def ranges(self) -> Tuple[np.ndarray, np.ndarray]:
        """(lo[T], hi[T]) row-range bounds per tablet."""
        lo = np.concatenate([[0], self.splits])
        hi = np.concatenate([self.splits, [self.id_capacity]])
        return lo, hi

    def range_of(self, tablet_id: int) -> Tuple[int, int]:
        i = self.index_of(tablet_id)
        lo, hi = self.ranges()
        return int(lo[i]), int(hi[i])

    def segments(self, lo: int, hi: int) -> List[Tuple[int, int, int]]:
        """Cover ``[lo, hi)`` with per-owner sub-ranges in KEY order,
        coalescing adjacent tablets that share an owner — a range scan
        issues one fused dispatch per segment and the concatenated
        results stay globally (row, col)-sorted."""
        lo, hi = max(int(lo), 0), min(int(hi), self.id_capacity)
        if hi <= lo:
            return []
        i0 = int(np.searchsorted(self.splits, lo, side="right"))
        i1 = int(np.searchsorted(self.splits, hi - 1, side="right"))
        t_lo, t_hi = self.ranges()
        out: List[Tuple[int, int, int]] = []
        for i in range(i0, i1 + 1):
            s = int(self.owners[i])
            a, b = max(lo, int(t_lo[i])), min(hi, int(t_hi[i]))
            if out and out[-1][0] == s and out[-1][2] == a:
                out[-1] = (s, out[-1][1], b)
            else:
                out.append((s, a, b))
        return out

    # ---------------------------------------------------------- mutation
    def split(self, tablet_id: int, key: int,
              new_id: Optional[int] = None) -> int:
        """Split a tablet at interior ``key``: the left half keeps
        ``tablet_id`` and its range becomes ``[lo, key)``; the right half
        ``[key, hi)`` gets a FRESH id (``new_id`` pins it during WAL
        replay) on the same owner. Metadata only — no data moves.
        Returns the right half's id."""
        i = self.index_of(tablet_id)
        lo, hi = self.ranges()
        if not int(lo[i]) < int(key) < int(hi[i]):
            raise ValueError(
                f"split key {key} outside tablet interior "
                f"({int(lo[i])}, {int(hi[i])})")
        nid = self.next_id if new_id is None else int(new_id)
        self.next_id = max(self.next_id, nid) + 1
        self.splits = np.insert(self.splits, i, np.int64(key))
        self.tablet_ids = np.insert(self.tablet_ids, i + 1, np.int32(nid))
        self.owners = np.insert(self.owners, i + 1, self.owners[i])
        half = self.loads[i] / 2.0
        self.loads[i] = half
        self.loads = np.insert(self.loads, i + 1, half)
        return nid

    def move(self, tablet_id: int, new_owner: int) -> int:
        """Reassign a tablet's owner shard; returns the OLD owner. The
        caller migrates the physical entries (``ShardedTable`` scans,
        clears, and re-routes the source shard)."""
        i = self.index_of(tablet_id)
        old = int(self.owners[i])
        self.owners[i] = np.int32(new_owner)
        return old

    def merge(self, tablet_id: int) -> int:
        """Merge a tablet with its RIGHT neighbor: the pair must share an
        owner (the caller moves one first otherwise), the left keeps its
        id and absorbs the right's range and load. Metadata only — both
        halves already live on the same shard. Returns the retired right
        tablet's id."""
        i = self.index_of(tablet_id)
        if i + 1 >= self.n:
            raise ValueError(f"tablet {tablet_id} has no right neighbor")
        if self.owners[i] != self.owners[i + 1]:
            raise ValueError(
                "merge requires both tablets on one shard "
                f"({int(self.owners[i])} != {int(self.owners[i + 1])})")
        gone = int(self.tablet_ids[i + 1])
        self.splits = np.delete(self.splits, i)
        self.tablet_ids = np.delete(self.tablet_ids, i + 1)
        self.owners = np.delete(self.owners, i + 1)
        self.loads[i] += self.loads[i + 1]
        self.loads = np.delete(self.loads, i + 1)
        return gone

    # ------------------------------------------------------- load signal
    def record_load(self, tablet_idx: np.ndarray,
                    weight: float = 1.0) -> None:
        """Accumulate per-tablet load from one batch's tablet indices."""
        if len(tablet_idx) == 0:
            return
        self.loads += weight * np.bincount(
            np.asarray(tablet_idx), minlength=self.n).astype(np.float64)

    def touch_range(self, lo: int, hi: int) -> None:
        """Count a range scan against every tablet it intersects."""
        if hi <= lo:
            return
        i0 = int(np.searchsorted(self.splits, max(int(lo), 0), side="right"))
        i1 = int(np.searchsorted(self.splits, int(hi) - 1, side="right"))
        self.loads[i0:i1 + 1] += 1.0

    def shard_loads(self) -> np.ndarray:
        """Recorded load aggregated onto the owning shards, [S]."""
        return np.bincount(self.owners, weights=self.loads,
                           minlength=self.num_shards)

    def shard_balance(self) -> float:
        """max/mean per-shard load — 1.0 is perfectly balanced."""
        per = self.shard_loads()
        mean = per.mean()
        return float(per.max() / mean) if mean > 0 else 1.0

    def decay(self, factor: float = 0.5) -> None:
        """Exponential-decay the load signal so the policy tracks the
        RECENT workload instead of all history."""
        self.loads *= factor

    # ------------------------------------------------- warm-read probing
    def sample_shard_ids(self, shard: int, per_shard: int = 18) -> np.ndarray:
        """~``per_shard`` unique ids drawn from the ranges ``shard``
        owns. ``warm_reads`` uses this instead of a uniform id-space
        probe: under a skewed map the uniform probe can hand a
        narrow-range shard <= 8 ids (point-bucket shape only) and its
        query tile would compile lazily on the first real batch."""
        lo, hi = self.ranges()
        mine = np.flatnonzero(self.owners == np.int32(shard))
        if len(mine) == 0:
            return np.zeros(0, np.int32)
        widths = (hi[mine] - lo[mine]).astype(np.float64)
        total = widths.sum()
        out = []
        for i, w in zip(mine, widths):
            k = min(int(w), max(2, int(round(per_shard * w / total))))
            out.append(np.linspace(lo[i], hi[i] - 1, k).astype(np.int64))
        return np.unique(np.concatenate(out)).astype(np.int32)

    # ------------------------------------------------------- persistence
    def to_manifest(self) -> dict:
        """JSON-ready record for the snapshot manifest (format 3)."""
        return {
            "splits": [int(x) for x in self.splits],
            "tablet_ids": [int(x) for x in self.tablet_ids],
            "owners": [int(x) for x in self.owners],
            "id_capacity": self.id_capacity,
            "num_shards": self.num_shards,
            "next_id": self.next_id,
        }

    @classmethod
    def from_manifest(cls, d: dict) -> "TabletMap":
        return cls(np.asarray(d["splits"], np.int64),
                   np.asarray(d["tablet_ids"], np.int32),
                   np.asarray(d["owners"], np.int32),
                   d["id_capacity"], d["num_shards"], d["next_id"])

    # ----------------------------------------------------- device routing
    def device_routing(self, max_tablets: int):
        """(splits[max_tablets-1], owners[max_tablets]) int32 arrays for
        a mesh ingest step: splits pad with ``id_capacity`` (a sentinel
        no valid id reaches, so padded tablets are never selected) and
        owners pad with 0. Padding to a STATIC ``max_tablets`` means a
        split or move changes array VALUES, never shapes — a step built
        (or captured) for those shapes survives every rebalance."""
        if self.n > max_tablets:
            raise ValueError(
                f"{self.n} tablets exceed device budget {max_tablets}")
        splits = np.full(max_tablets - 1, self.id_capacity, np.int32)
        splits[:len(self.splits)] = self.splits.astype(np.int32)
        owners = np.zeros(max_tablets, np.int32)
        owners[:self.n] = self.owners
        return splits, owners
