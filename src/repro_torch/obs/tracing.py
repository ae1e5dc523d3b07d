"""Per-op span tracing: nested wall-time spans in a bounded ring buffer,
a slow-op log, trace-context propagation, a flight recorder for slow
ops, and Chrome-trace / plain-JSON export.

    with span("flush", table="t", shard=3):
        ...
        with span("host_sync", table="t"):
            ...

Spans record host wall time. Under JAX async dispatch that means a
"dispatch" span measures enqueue cost and a "host_sync" span measures the
device round-trip — which is exactly the split the fused read path is
designed around (one dispatch + one sync per query batch).

Trace context: the root span of each nesting (depth 0) allocates a trace
id (``t<hex>``); every child span inherits it, so one connector-level op
(insert/query/scan/compaction) shares a single id from connector through
kvstore, engine, and WAL. `current_trace()` exposes the active id so
histograms can attach exemplars linking latency buckets back to traces.

Flight recorder: when a ROOT span exceeds `slow_threshold_s`, its full
span tree (root + all descendants, in completion order) is captured into
a bounded ring — `flight_recordings()` — so a slow query can be explained
after the fact without re-running under a profiler.

Disabled mode hands back a shared no-op context manager: the only cost at
a call site is one attribute check and one function call.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque


class _NullSpan:
    """Shared do-nothing context manager for the disabled path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tracer", "name", "labels", "t0", "ts", "depth", "parent",
                 "trace")

    def __init__(self, tracer, name, labels):
        self.tracer = tracer
        self.name = name
        self.labels = labels

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        self.depth = len(stack)
        if stack:
            self.parent = stack[-1].name
            self.trace = stack[-1].trace
        else:
            self.parent = None
            self.trace = "t%06x" % next(tr._trace_seq)
            tr._local.tree = []
        stack.append(self)
        self.ts = time.time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        tr = self.tracer
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        rec = {"name": self.name, "ts": self.ts, "dur": dur,
               "depth": self.depth, "parent": self.parent,
               "trace": self.trace, "tid": threading.get_ident()}
        if self.labels:
            rec["labels"] = self.labels
        tr._ring.append(rec)
        if dur >= tr.slow_threshold_s:
            tr._slow.append(rec)
        tree = getattr(tr._local, "tree", None)
        if tree is not None:
            tree.append(rec)
            if self.depth == 0:
                if dur >= tr.slow_threshold_s:
                    tr._flight.append({"trace": self.trace, "root": rec,
                                       "spans": tree})
                tr._local.tree = None
        return False


class Tracer:
    def __init__(self, capacity: int = 8192, slow_threshold_s: float = 0.050,
                 slow_capacity: int = 256, flight_capacity: int = 64,
                 enabled: bool = True):
        self.enabled = enabled
        self.slow_threshold_s = slow_threshold_s
        self._ring = deque(maxlen=capacity)
        self._slow = deque(maxlen=slow_capacity)
        self._flight = deque(maxlen=flight_capacity)
        self._trace_seq = itertools.count(1)
        self._local = threading.local()

    def _stack(self):
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **labels):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, labels)

    def current_trace_id(self):
        """Trace id of the innermost open span on this thread, or None."""
        st = getattr(self._local, "stack", None)
        return st[-1].trace if st else None

    # -- inspection / export ----------------------------------------------
    def spans(self):
        """Ring-buffer contents, oldest first."""
        return list(self._ring)

    def slow_ops(self):
        """Spans that exceeded slow_threshold_s, oldest first."""
        return list(self._slow)

    def flight_recordings(self):
        """Full span trees of root ops that exceeded slow_threshold_s,
        oldest first: {trace, root, spans} with spans in completion
        order (children before their parent)."""
        return list(self._flight)

    def clear(self):
        self._ring.clear()
        self._slow.clear()
        self._flight.clear()

    def export_json(self, path: str):
        with open(path, "w") as f:
            json.dump({"slow_threshold_s": self.slow_threshold_s,
                       "spans": self.spans(),
                       "slow_ops": self.slow_ops(),
                       "flight_recordings": self.flight_recordings()},
                      f, indent=1)

    def export_chrome(self, path: str):
        """chrome://tracing / Perfetto 'complete' (ph=X) events, one per
        span, ts/dur in microseconds."""
        events = []
        for rec in self._ring:
            events.append({
                "name": rec["name"], "cat": "repro.db", "ph": "X",
                "ts": rec["ts"] * 1e6, "dur": rec["dur"] * 1e6,
                "pid": 0, "tid": rec["tid"],
                "args": dict(rec.get("labels", {}),
                             depth=rec["depth"], parent=rec["parent"],
                             trace=rec.get("trace")),
            })
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f, indent=1)


# ------------------------------------------------------------------ globals
_DEFAULT = Tracer()


def default_tracer() -> Tracer:
    return _DEFAULT


def span(name: str, **labels):
    """Span on the process-global default tracer."""
    return _DEFAULT.span(name, **labels)


def current_trace():
    """Trace id of the innermost open span on the default tracer (this
    thread), or None when no span is open / tracing is disabled."""
    st = getattr(_DEFAULT._local, "stack", None)
    return st[-1].trace if st else None


def set_tracing(on: bool):
    _DEFAULT.enabled = bool(on)
