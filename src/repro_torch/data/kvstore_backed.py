"""TokenStore: the KV-store-backed training data pipeline.

The port's counterpart of ``repro.data.kvstore_backed``: the same corpus
and the same generator give the same documents and batches in both
packages. The store lives on ``device`` (the card by default); there a
document read is one fused point read of the LSM engine (the batched
fence search, then the row merge while a read's candidate width stays
<= 256 — a longer document takes the engine's wide-row sort).
"""
from __future__ import annotations

from typing import List, Union

import numpy as np
import torch

from ..db.kvstore import ShardedTable


class TokenStore:
    """Documents stored as (doc_id, position) -> token in a ShardedTable.

    Row id   = doc id (range-partitioned over shards -> documents spread
               across 'tablet servers' like Accumulo rows),
    Col id   = position,
    Value    = token id (float32 payload; exact below 2**24).
    """

    def __init__(self, num_shards: int = 4, capacity_per_shard: int = 1 << 20,
                 max_docs: int = 1 << 16, use_pallas: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        self.store = ShardedTable(
            "tokens", num_shards=num_shards,
            capacity_per_shard=capacity_per_shard,
            batch_cap=1 << 16, id_capacity=max_docs, use_pallas=use_pallas,
            device=device)
        self.doc_lens: List[int] = []

    def ingest(self, docs: List[np.ndarray]) -> None:
        for doc in docs:
            doc_id = len(self.doc_lens)
            n = len(doc)
            self.store.insert(
                np.full(n, doc_id, np.int32),
                np.arange(n, dtype=np.int32),
                doc.astype(np.float32),
            )
            self.doc_lens.append(n)

    def num_docs(self) -> int:
        return len(self.doc_lens)

    def get_doc(self, doc_id: int) -> np.ndarray:
        _, pos, tok = self.store.query_rows(
            np.asarray([doc_id], np.int32),
            max_return=max(self.doc_lens[doc_id], 1))
        order = np.argsort(pos)
        return tok[order].astype(np.int32)

    def sample_batch(self, batch: int, seq_len: int,
                     rng: np.random.Generator) -> np.ndarray:
        """[batch, seq_len] token batch via row queries (wraps short docs)."""
        out = np.zeros((batch, seq_len), np.int32)
        docs = rng.integers(0, self.num_docs(), batch)
        for i, d in enumerate(docs):
            toks = self.get_doc(int(d))
            if len(toks) >= seq_len:
                s = rng.integers(0, len(toks) - seq_len + 1)
                out[i] = toks[s:s + seq_len]
            else:
                reps = -(-seq_len // max(len(toks), 1))
                out[i] = np.tile(toks, reps)[:seq_len]
        return out
