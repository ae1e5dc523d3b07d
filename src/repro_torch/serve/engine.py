"""Batched serving engine: fixed-slot prefill + greedy decode over a request
queue, as the JAX package's ``serve/engine.py`` does it, on one device
(``"cuda"`` unless the caller passes ``device="cpu"``)."""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Union

import numpy as np
import torch

from ..kernels.common import resolve_device
from ..models.api import Model
from ..models.spec import tree_map


@dataclasses.dataclass
class Request:
    prompt: np.ndarray              # int32 [S]
    max_new: int = 16
    out: Optional[np.ndarray] = None


class Engine:
    """Fixed-batch engine: pads requests to slots (left padding with token
    0, not masked), prefills per batch, then decodes until every slot
    finishes or the cache is full (greedy argmax over ``vocab_padded``)."""

    def __init__(self, model: Model, params, batch_slots: int = 4,
                 max_len: int = 256,
                 device: Union[str, torch.device] = "cuda"):
        if model.cfg.family not in ("dense", "moe"):
            raise ValueError(f"Engine serves decoder-only transformer LMs "
                             f"(dense, moe), not {model.cfg.family!r}")
        self.device = resolve_device(device)
        self.model = model
        self.params = tree_map(lambda w: w.to(self.device), params)
        self.slots = batch_slots
        self.max_len = max_len

    def run(self, requests: List[Request]) -> dict:
        """Serve ``requests`` in batches of ``batch_slots``; fills each
        ``out``. Stats: tokens out, batches, and host-clock seconds of the
        whole run, of the prefills and of the decode steps (each ends in
        the copy of its tokens to the host, which waits for the device)."""
        stats = {"tokens_out": 0, "wall_s": 0.0, "batches": 0,
                 "prefill_s": 0.0, "decode_s": 0.0, "decode_steps": 0}
        t0 = time.perf_counter()
        for i in range(0, len(requests), self.slots):
            self._run_batch(requests[i:i + self.slots], stats)
            stats["batches"] += 1
        stats["wall_s"] = time.perf_counter() - t0
        stats["tok_per_s"] = stats["tokens_out"] / max(stats["wall_s"], 1e-9)
        return stats

    def _greedy(self, logits: torch.Tensor) -> np.ndarray:
        return logits[:, -1, :].argmax(-1).to(torch.int32).cpu().numpy()

    def _run_batch(self, batch: List[Request], stats: dict) -> None:
        b = len(batch)
        plen = max(len(r.prompt) for r in batch)
        toks = np.zeros((self.slots, plen), np.int32)
        for j, r in enumerate(batch):
            toks[j, plen - len(r.prompt):] = r.prompt  # left-pad
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device),
                          "max_len": self.max_len})
        new = self._greedy(logits)
        stats["prefill_s"] += time.perf_counter() - t0
        outs = [[int(new[j])] for j in range(b)]
        max_new = max(r.max_new for r in batch)
        pos = plen
        t0 = time.perf_counter()
        for _ in range(max_new - 1):
            if pos >= self.max_len:
                break
            token = torch.from_numpy(new[:, None]).to(self.device)
            logits, cache = self.model.decode(
                self.params, {"token": token, "cache": cache, "pos": pos})
            new = self._greedy(logits)
            stats["decode_steps"] += 1
            for j in range(b):
                if len(outs[j]) < batch[j].max_new:
                    outs[j].append(int(new[j]))
            pos += 1
        stats["decode_s"] += time.perf_counter() - t0
        for j, r in enumerate(batch):
            r.out = np.asarray(outs[j], np.int32)
            stats["tokens_out"] += len(r.out)
