"""Dependency-free metrics registry: counters, gauges, and log-bucketed
HDR-style histograms with labeled series.

Design constraints:
  * p50/p90/p99/p999 without storing samples -> fixed log-spaced buckets.
  * labeled series (table=..., shard=..., op=...) under one metric name.
  * near-zero overhead when disabled: every mutator checks a single
    registry-level flag and returns immediately.
  * process-global default registry so instrumentation sites never need
    plumbing; tests and benchmarks may build private registries.

Histogram math: bucket edges grow by 2**(1/SUBBUCKETS) per bin (8
sub-buckets per octave), so any sample's bucket representative (the
geometric midpoint) is within ~4.4% relative error of the true value.
count/sum/min/max are tracked exactly, and quantile() clamps to
[min, max] so constant distributions report exact quantiles.
"""
from __future__ import annotations

import json
import math
import threading

from .tracing import current_trace as _current_trace

# ---------------------------------------------------------------- histogram
_SUBBUCKETS = 8                      # bins per octave (factor 2**(1/8))
_GROWTH = 2.0 ** (1.0 / _SUBBUCKETS)
_LOG_GROWTH = math.log(_GROWTH)
_LO = 1e-9                           # smallest resolvable sample (1 ns)
_NBINS = 512                         # covers _LO .. _LO*_GROWTH**512 ~ 2e10


def _bucket_index(x: float) -> int:
    if x <= _LO:
        return 0
    i = int(math.log(x / _LO) / _LOG_GROWTH) + 1
    return i if i < _NBINS else _NBINS - 1


def _bucket_rep(i: int) -> float:
    """Geometric midpoint of bucket i (representative value)."""
    if i <= 0:
        return _LO
    return _LO * _GROWTH ** (i - 0.5)


class Histogram:
    """Log-bucketed latency histogram. Units are the caller's (we use
    seconds everywhere in repro_torch.db)."""

    kind = "histogram"

    def __init__(self, registry: "Registry", name: str, labels: dict):
        self._reg = registry
        self.name = name
        self.labels = labels
        self.reset()

    def reset(self):
        self._buckets = [0] * _NBINS
        self._exemplars = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, x: float):
        if not self._reg.enabled:
            return
        x = float(x)
        i = _bucket_index(x)
        self._buckets[i] += 1
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        trace = _current_trace()
        if trace is not None:
            # latest exemplar per bucket: which op landed in this latency
            # band last -> join against the tracer's flight recordings
            self._exemplars[i] = (x, trace)

    def exemplars(self) -> dict:
        """{bucket_index: (value, trace_id)} — latest sample per bucket
        that was observed while a span was open."""
        return dict(self._exemplars)

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile from bucket counts, clamped to the exact
        [min, max] envelope. Returns nan when empty."""
        if self.count == 0:
            return math.nan
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for i, c in enumerate(self._buckets):
            seen += c
            if seen >= rank:
                return min(max(_bucket_rep(i), self.min), self.max)
        return self.max

    def percentiles(self) -> dict:
        return {"p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99), "p999": self.quantile(0.999)}

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def merge(self, other: "Histogram"):
        """Fold another histogram's state into this one (exact: same fixed
        bucket layout)."""
        for i, c in enumerate(other._buckets):
            if c:
                self._buckets[i] += c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self._exemplars.update(other._exemplars)

    def snapshot(self) -> dict:
        s = {"count": int(self.count), "sum": float(self.sum)}
        if self.count:
            s["min"] = float(self.min)
            s["max"] = float(self.max)
            s["mean"] = float(self.mean)
            s.update({k: float(v) for k, v in self.percentiles().items()})
            s["buckets"] = {str(i): int(c)
                            for i, c in enumerate(self._buckets) if c}
            if self._exemplars:
                s["exemplars"] = {str(i): {"value": float(v), "trace": t}
                                  for i, (v, t)
                                  in sorted(self._exemplars.items())}
        return s

    def load_snapshot(self, snap: dict):
        """Merge a snapshot() dict (e.g. from another process) into self."""
        self.count += int(snap.get("count", 0))
        self.sum += float(snap.get("sum", 0.0))
        if "min" in snap:
            self.min = min(self.min, float(snap["min"]))
        if "max" in snap:
            self.max = max(self.max, float(snap["max"]))
        for i, c in snap.get("buckets", {}).items():
            self._buckets[int(i)] += int(c)
        for i, ex in snap.get("exemplars", {}).items():
            self._exemplars[int(i)] = (float(ex["value"]), ex["trace"])


class Counter:
    kind = "counter"

    def __init__(self, registry: "Registry", name: str, labels: dict):
        self._reg = registry
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n=1):
        if self._reg.enabled:
            self.value += n

    def reset(self):
        self.value = 0

    def snapshot(self):
        v = self.value
        return int(v) if isinstance(v, (bool, int)) else float(v)


class Gauge:
    kind = "gauge"

    def __init__(self, registry: "Registry", name: str, labels: dict):
        self._reg = registry
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v):
        if self._reg.enabled:
            self.value = v

    def reset(self):
        self.value = 0.0

    def snapshot(self):
        v = self.value
        return int(v) if isinstance(v, (bool, int)) else float(v)


# ----------------------------------------------------------------- registry
def _series_key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Registry:
    """Get-or-create store of labeled metric series.

    A series is (name, labels) -> instrument; calling counter()/gauge()/
    histogram() twice with the same identity returns the same object, so
    instrumentation sites can cache or re-request freely. `enabled` is the
    single kill switch every mutator checks.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._series: dict = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: dict):
        key = _series_key(name, labels)
        inst = self._series.get(key)
        if inst is None:
            with self._lock:
                inst = self._series.get(key)
                if inst is None:
                    inst = cls(self, name, dict(labels))
                    self._series[key] = inst
        if not isinstance(inst, cls):
            raise TypeError(f"series {key!r} already registered as "
                            f"{inst.kind}, not {cls.kind.lower()}")
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    # -- bulk ops ----------------------------------------------------------
    def series(self, name: str = None, **label_filter):
        """All instruments matching name (prefix ignored if None) and the
        given label values."""
        out = []
        for inst in self._series.values():
            if name is not None and inst.name != name:
                continue
            if any(str(inst.labels.get(k)) != str(v)
                   for k, v in label_filter.items()):
                continue
            out.append(inst)
        return out

    def reset(self, name: str = None, **label_filter):
        for inst in self.series(name, **label_filter):
            inst.reset()

    def snapshot(self, name: str = None, **label_filter) -> dict:
        """JSON-ready {series_key: value-or-histogram-dict}, sorted."""
        out = {}
        for inst in self.series(name, **label_filter):
            out[_series_key(inst.name, inst.labels)] = inst.snapshot()
        return dict(sorted(out.items()))

    def aggregate(self, name: str, **label_filter):
        """Sum counters / merge histograms across all series of `name`
        matching the filter. Returns an int/float for counters, a merged
        snapshot dict for histograms, None if no series exist."""
        insts = self.series(name, **label_filter)
        if not insts:
            return None
        if insts[0].kind == "histogram":
            pooled = Histogram(self, name, {})
            for h in insts:
                pooled.merge(h)
            return pooled.snapshot()
        total = 0
        for c in insts:
            total += c.value
        return int(total) if isinstance(total, (bool, int)) else float(total)

    def dump(self, path: str, **label_filter):
        with open(path, "w") as f:
            json.dump(self.snapshot(**label_filter), f, indent=1,
                      sort_keys=True)


def merge_snapshots(snapshots) -> dict:
    """Merge per-process registry snapshot() dicts at the host: counters
    and gauges sum; histograms bucket-merge with recomputed percentiles."""
    reg = Registry()
    merged = {}
    for snap in snapshots:
        for key, val in snap.items():
            if isinstance(val, dict):        # histogram snapshot
                h = merged.get(key)
                if h is None:
                    h = merged[key] = Histogram(reg, key, {})
                h.load_snapshot(val)
            else:
                merged[key] = merged.get(key, 0) + val
    return {k: (v.snapshot() if isinstance(v, Histogram) else v)
            for k, v in sorted(merged.items())}


# ------------------------------------------------------------------ globals
_DEFAULT = Registry(enabled=True)


def default_registry() -> Registry:
    return _DEFAULT


def set_enabled(on: bool):
    """Toggle the process-global registry (and nothing else; the tracer has
    its own switch in repro_torch.obs.tracing)."""
    _DEFAULT.enabled = bool(on)
