"""Elastic scaling + straggler/failure handling (the JAX package's
``train/elastic.py``).

The failure model is Accumulo-style at the data plane (re-route a dead
ingestor's key range, pull-based batches) and checkpoint-elastic at the
training plane: checkpoints hold global host arrays, so a run restarts on
any mesh whose axes divide the shapes, of another width than the one that
saved them (``elastic_restore``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.spec import (ShardingRules, flatten_up_to, local_block,
                           placements, tree_leaves, tree_unflatten)
from . import checkpoint


def elastic_restore(ckpt_dir: str, param_specs, mesh,
                    rules: ShardingRules, step: Optional[int] = None):
    """Restore a checkpoint onto an arbitrary (possibly resized) mesh:
    every rank reads the checkpoint's host arrays and keeps its block of
    each leaf as a DTensor placed as ``sharding_tree(param_specs, rules,
    mesh)`` places it, on the mesh's device type.
    Returns (tree, manifest), as ``checkpoint.restore`` does."""
    from torch.distributed.tensor import DTensor
    tree, manifest = checkpoint.restore(ckpt_dir, param_specs, step=step,
                                        device="cpu")
    dev = torch.device(mesh.device_type)
    out = []
    for s, full in zip(tree_leaves(param_specs),
                       flatten_up_to(param_specs, tree)):
        pl = placements(rules.pspec_for_shape(s.shape, s.axes, mesh), mesh)
        local = local_block(full, pl, mesh).contiguous().to(dev)
        out.append(DTensor.from_local(local, mesh, pl, run_check=False,
                                      shape=full.shape,
                                      stride=full.stride()))
    return tree_unflatten(param_specs, out), manifest


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
