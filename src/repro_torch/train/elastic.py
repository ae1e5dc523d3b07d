"""Elastic scaling + straggler/failure handling (the JAX package's
``train/elastic.py``).

The failure model is Accumulo-style at the data plane (re-route a dead
ingestor's key range, pull-based batches) and checkpoint-elastic at the
training plane. The data-plane pieces are numpy and copied here;
``elastic_restore`` re-shards onto a JAX mesh under ``ShardingRules`` and
waits for the launch and mesh tools (ROADMAP Queue 1 item 11i).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def elastic_restore(ckpt_dir: str, param_specs, mesh, rules,
                    step: Optional[int] = None):
    """Restore a checkpoint onto a resized mesh: not ported yet."""
    raise NotImplementedError(
        "elastic_restore needs a mesh and ShardingRules: ROADMAP Queue 1 "
        "item 11i (launch and mesh tools); checkpoint.restore restores "
        "onto one device")


def reassign_dead_ingestor(split_points: np.ndarray, dead: int) -> np.ndarray:
    """Accumulo tablet reassignment: merge the dead shard's key range into
    its neighbour by dropping its split point. split_points has S-1 entries
    for S shards; returns S-2 entries for S-1 shards."""
    s = len(split_points) + 1
    assert 0 <= dead < s
    drop = min(dead, len(split_points) - 1)
    return np.delete(split_points, drop)


class WorkQueue:
    """Straggler mitigation for ingest: batches are pulled, not pushed.

    A slow ingestor simply claims fewer batches; a dead one (never acks)
    has its in-flight batch re-queued after ``timeout_batches`` pulls by
    others."""

    def __init__(self, batches, timeout_batches: int = 8):
        self.pending = list(range(len(batches)))
        self.batches = batches
        self.inflight: dict = {}
        self.done: set = set()
        self.timeout = timeout_batches
        self.clock = 0

    def claim(self, worker: int):
        self.clock += 1
        # requeue timed-out in-flight work (dead worker)
        for bid, (w, t) in list(self.inflight.items()):
            if self.clock - t > self.timeout:
                del self.inflight[bid]
                self.pending.append(bid)
        if not self.pending:
            return None, None
        bid = self.pending.pop(0)
        self.inflight[bid] = (worker, self.clock)
        return bid, self.batches[bid]

    def ack(self, bid: int) -> None:
        self.inflight.pop(bid, None)
        self.done.add(bid)

    def complete(self) -> bool:
        return len(self.done) == len(self.batches)
