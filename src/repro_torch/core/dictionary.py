"""String interning: the host-side boundary between D4M string keys and
device-side int32 ids.

Accumulo stores byte-string keys; TPUs do not handle variable-length data.
All strings are dictionary-encoded here, once, at the host boundary — the
device-side store (``repro_torch.db.kvstore``) only ever sees dense int32 ids.
This is the TPU-native analogue of the JVM/JavaCall string-marshalling layer
whose overhead the paper measures.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, List

import numpy as np


class StringDict:
    """Bidirectional string <-> int32 id mapping (ids are dense, 0-based)."""

    def __init__(self, strings: Iterable[str] = ()):  # noqa: D107
        self._to_id: dict = {}
        self._to_str: List[str] = []
        if strings:
            self.encode(np.asarray(list(strings), dtype=object))

    def __len__(self) -> int:
        return len(self._to_str)

    def encode(self, strs: np.ndarray) -> np.ndarray:
        """Intern every string; returns int32 ids (allocates new ids).

        Vectorized via np.unique: the Python-level intern loop touches only
        the *unique* strings of the batch (power-law batches repeat hub
        keys constantly). This is the paper's own observation — string-array
        handling dominates connector overhead — applied at the one host
        boundary where strings still exist (DESIGN §2).
        """
        if len(strs) == 0:
            return np.zeros(0, dtype=np.int32)
        uniq, inv = np.unique(np.asarray(strs, dtype=object), return_inverse=True)
        to_id = self._to_id
        to_str = self._to_str
        uids = np.empty(len(uniq), dtype=np.int32)
        for i, s in enumerate(uniq):
            j = to_id.get(s)
            if j is None:
                j = len(to_str)
                to_id[s] = j
                to_str.append(s)
            uids[i] = j
        return uids[inv]

    def lookup(self, strs: np.ndarray) -> np.ndarray:
        """Ids for already-interned strings; -1 where unknown (no alloc)."""
        to_id = self._to_id
        return np.fromiter(
            (to_id.get(s, -1) for s in strs), dtype=np.int32, count=len(strs)
        )

    def decode(self, ids: np.ndarray) -> np.ndarray:
        arr = np.asarray(self._to_str, dtype=object)
        return arr[np.asarray(ids)]

    def get(self, s: str) -> int:
        return self._to_id.get(s, -1)

    @classmethod
    def from_strings(cls, strings) -> "StringDict":
        """Rebuild with ids assigned by POSITION (id i = strings[i]).

        The ``__init__`` path interns via ``encode`` — which dedups through
        ``np.unique`` and therefore assigns ids in *sorted* order. Recovery
        must preserve the original allocation order, so it uses this.
        """
        d = cls()
        d._to_str = list(strings)
        d._to_id = {s: i for i, s in enumerate(d._to_str)}
        return d

    # -- persistence (checkpoint manifest / restart path) -------------------
    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._to_str, f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "StringDict":
        with open(path) as f:
            return cls.from_strings(json.load(f))
