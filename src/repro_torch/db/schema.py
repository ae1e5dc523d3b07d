"""D4M 2.0 schema (paper ref [11]): edge table + transpose + degree table.

The degree table is maintained *at ingest time* by the combiner analogue
(``kvstore.degree_update``), exactly like attaching a summing iterator to
TedgeDeg in Accumulo. Queries use it for planning: find vertices of a given
degree (the paper's Fig. 4 query-selection procedure) and size query buffers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.assoc import Assoc
from .connector import DBserver, delete as _delete
from .kvstore import degree_update


class DegreeTable:
    """Dense out/in-degree accumulator over the server's vertex-id space:
    ``out_deg`` and ``in_deg`` are float32 ``[id_capacity]`` tensors on the
    server's device.

    ``update`` adds through the segment-sum kernel under the server's
    ``use_pallas``, like every other kernel route of the port. (The JAX
    ``DegreeTable`` always takes its plain scatter-add, because its kernel
    runs in interpret mode on the CPU and is slow there.) Both compute the
    same function: a sum of 1.0s is exact in float32 for counts below
    2^24 in any order, so the degrees are equal bit for bit."""

    def __init__(self, server: DBserver, name: str):
        self.server = server
        self.name = name
        cap = server.id_capacity
        self.out_deg = torch.zeros(cap, dtype=torch.float32,
                                   device=server.device)
        self.in_deg = torch.zeros_like(self.out_deg)
        server.tables[name] = self

    def update(self, rid: np.ndarray, cid: np.ndarray) -> None:
        dev = self.out_deg.device
        use_pallas = self.server.use_pallas
        for attr, ids in (("out_deg", rid), ("in_deg", cid)):
            ids = torch.as_tensor(np.asarray(ids, np.int32), device=dev)
            ones = torch.ones(ids.shape[0], dtype=torch.float32, device=dev)
            setattr(self, attr, degree_update(getattr(self, attr), ids, ones,
                                              use_pallas=use_pallas))

    def degrees(self, vertices) -> Assoc:
        ids = self.server.resolve_selector_plan(vertices).filter_ids()
        if ids is None:
            ids = np.arange(len(self.server.keydict), dtype=np.int32)
        out = self.out_deg.cpu().numpy()[ids]
        ind = self.in_deg.cpu().numpy()[ids]
        keys = self.server.keydict.decode(ids)
        rows = np.concatenate([keys, keys])
        cols = np.asarray(["OutDeg"] * len(ids) + ["InDeg"] * len(ids), object)
        vals = np.concatenate([out, ind])
        return Assoc(rows, cols, vals)

    def vertices_with_degree(self, target: float, kind: str = "out",
                             tol: float = 10 ** 0.5) -> np.ndarray:
        """Vertex names whose degree is within a factor ``tol`` of target
        (the paper buckets query vertices by degree decade)."""
        deg = (self.out_deg if kind == "out" else self.in_deg).cpu().numpy()
        n = len(self.server.keydict)
        deg = deg[:n]
        hit = np.flatnonzero((deg >= target / tol) & (deg < target * tol))
        return self.server.keydict.decode(hit.astype(np.int32))

    def state_arrays(self) -> dict:
        """``out_deg`` and ``in_deg`` as numpy copies (the JAX
        ``DegreeTable``'s two vectors)."""
        return {k: getattr(self, k).to("cpu", copy=True).numpy()
                for k in ("out_deg", "in_deg")}

    def load_state(self, arrays: dict) -> None:
        """Load ``out_deg`` and ``in_deg`` (numpy, ``[id_capacity]``, e.g.
        a JAX ``DegreeTable``'s) as copies on this table's device."""
        for k in ("out_deg", "in_deg"):
            cur = getattr(self, k)
            got = np.shape(arrays.get(k))
            if got != tuple(cur.shape):
                raise ValueError(f"degree vector {k!r} has shape {got}, "
                                 f"this table needs {tuple(cur.shape)}")
            setattr(self, k, torch.tensor(np.asarray(arrays[k]),
                                          dtype=torch.float32,
                                          device=cur.device))


class EdgeSchema:
    """The full D4M 2.0 bundle: Tedge / TedgeT / TedgeDeg with auto-upkeep."""

    def __init__(self, server: DBserver, base: str):
        self.server = server
        self.pair = server[f"{base}_Tedge", f"{base}_TedgeT"]
        self.deg = DegreeTable(server, f"{base}_TedgeDeg")

    def put(self, a: Assoc) -> None:
        self.put_triple(*a.triples())

    def put_triple(self, rows, cols, vals) -> None:
        self.pair.put_triple(rows, cols, vals)
        rid = self.server.keydict.lookup(np.asarray(rows, object))
        cid = self.server.keydict.lookup(np.asarray(cols, object))
        self.deg.update(rid, cid)

    def __getitem__(self, key) -> Assoc:
        return self.pair[key]

    def nnz(self) -> int:
        return self.pair.nnz()

    def delete(self) -> None:
        _delete(self.pair)
        self.server.drop(self.deg.name)
