"""LM data pipeline on the D4M data plane.

Training corpora are ingested as (doc, position) -> token triples into the
sharded KV store; batch assembly is a row query per document. This makes
the store's ingest/query throughput literally the training-input
throughput. A copy of the JAX package's ``repro.data.tokens``: the same
seed gives the same corpus.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .kvstore_backed import TokenStore  # re-export

__all__ = ["TokenStore", "synthetic_corpus"]


def synthetic_corpus(n_docs: int, doc_len: int, vocab: int,
                     seed: int = 0) -> List[np.ndarray]:
    """Zipf-distributed token documents (power-law, like the graph bench)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    p = 1.0 / ranks
    p /= p.sum()
    return [rng.choice(vocab, size=doc_len, p=p).astype(np.int32)
            for _ in range(n_docs)]
