"""The one traffic generator: it reads a mix (``traffic/<mix>.json``) and
yields the client's operations. A new mix is a new data file; a new kind of
operation is a new handler, ``ops/<op>.py``; a new way of offering them is a
new loop, ``loops/<loop>.py``. None of them needs this code changed.

A mix's keys:

* ``loop``: the module under ``loops/`` that drives the operations through
  the window (``"closed"``), with the keys it reads itself (``clients``).
* ``graphs``: how many ingestor graphs the run prepares (graph ``g`` is the
  ``g``-th drawn from the seed).
* ``preload``: how many of them set-up loads before the window (reads need
  a store to read); the puts of the window start at the next graph.
* ``ops``: the operations, each ``{"op": <name>, ...}``. The handler
  ``ops/<name>.py`` reads the op's other keys, and the mix's own keys that
  it names (``read``: ``pool``, ``order``). The ops of one name make one
  stream.
* ``weights`` (optional): ``{<name>: n}``, n operations of that stream in
  each round, the streams in the order their names first appear in
  ``ops``; 1 each by default. A mix of puts and reads interleaves them so.

A handler module has one class, ``Op(specs, mix, cell, rng)``: ``warm()``
runs once in set-up, iterating it yields ``(tag, call)`` with ``call()``
doing one operation and returning the entries it moved, ``collect()`` takes
the program's outputs to the host once the window has closed, and
``judge()`` then returns its numbers compared, ``{name: (value, limit)}``.
"""
from __future__ import annotations

import importlib
from typing import Iterator

import numpy as np


def load_op(name: str):
    return importlib.import_module(f"portbench.ops.{name}")


class Traffic:
    def __init__(self, mix: dict, cell, seed: int):
        self.mix = mix
        self.rng = np.random.default_rng(seed)
        groups = {}
        for spec in mix["ops"]:
            groups.setdefault(spec["op"], []).append(spec)
        weights = mix.get("weights", {})
        self.streams = [(name, int(weights.get(name, 1)),
                         load_op(name).Op(specs, mix, cell, self.rng))
                        for name, specs in groups.items()]

    @property
    def kinds(self) -> set:
        return {name for name, _, _ in self.streams}

    def warm(self) -> None:
        for _, _, op in self.streams:
            op.warm()

    def ops(self) -> Iterator[tuple]:
        """(kind, tag, call) in rounds: each stream's weight of its
        operations in turn, for as long as the loop asks."""
        its = [(name, weight, iter(op)) for name, weight, op in self.streams]
        while True:
            for name, weight, it in its:
                for _ in range(weight):
                    tag, call = next(it)
                    yield name, tag, call

    def collect(self) -> None:
        for _, _, op in self.streams:
            op.collect()

    def judge(self) -> dict:
        checks = {}
        for _, _, op in self.streams:
            checks.update(op.judge())
        return checks
