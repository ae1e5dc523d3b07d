"""``{"op": "put", "triples": n}``: the graphs' triples in order, ``n`` a
call, from the first graph that set-up did not preload to the last. The
stream never wraps: once the mix's graphs are spent, the next operation
fails, and the run with it, rather than put the same triples again into a
store that has stopped growing. A faster program wants a mix with more
graphs."""
from __future__ import annotations


class Op:
    def __init__(self, specs, mix, cell, rng):
        (spec,) = specs
        self.cell = cell
        self.step = int(spec["triples"])
        self.first = int(mix.get("preload", 0))
        self._spans = self._stream()

    def _stream(self):
        for g in range(self.first, len(self.cell.graphs)):
            n = len(self.cell.graphs[g][0])
            for lo in range(0, n, self.step):
                yield g, lo, min(lo + self.step, n)

    def warm(self) -> None:
        """The store's write path, then one put of the stream, acknowledged
        like the window's."""
        self.cell.warm_puts()
        self.cell.put(*self.cell.request(*next(self._spans)))

    def __iter__(self):
        for span in self._spans:
            req = self.cell.request(*span)  # made before the clock
            yield f"g{span[0]}", (lambda req=req: self.cell.put(*req))
        yield "spent", self._spent

    def _spent(self):
        raise RuntimeError(
            f"the mix's {len(self.cell.graphs)} graphs are spent: the "
            f"window put every triple they hold; give the mix more graphs")

    def collect(self) -> None:
        """The tables' contents are the system's to compare."""

    def judge(self) -> dict:
        return {}
