"""Exporters over the metrics registry: Prometheus text exposition (with
OpenMetrics exemplars), a periodic JSONL emitter, a terminal/markdown
health report, and the debug-bundle writer behind
``DBserver.debug_bundle``.

Everything here is read-only over a Registry/Tracer — exporting never
mutates series, so it is safe to call from a signal handler, a bench
epilogue, or a monitoring thread while the storage path is live.

CLI (reads a registry dump produced by ``Registry.dump`` /
``ingest_bench --metrics-out``):

    python -m repro_torch.obs.export --metrics METRICS_ingest.json            # md
    python -m repro_torch.obs.export --metrics M.json --format term
    python -m repro_torch.obs.export --metrics M.json --prometheus out.prom
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import threading
import time
import zipfile

from .metrics import (_GROWTH, _LO, Histogram, Registry, default_registry)
from .tracing import default_tracer


# ------------------------------------------------------- prometheus text
def _escape_label(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace(
        "\n", r"\n")


def _label_str(labels: dict, extra: dict = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape_label(items[k])}"'
                     for k in sorted(items))
    return "{" + inner + "}"


def _fmt(x: float) -> str:
    if x != x:                                   # NaN
        return "NaN"
    if x == math.inf:
        return "+Inf"
    return repr(int(x)) if float(x).is_integer() and abs(x) < 1e15 \
        else repr(float(x))


def prometheus_text(reg: Registry = None) -> str:
    """Render the registry in Prometheus/OpenMetrics text exposition.

    Counters get a ``_total`` suffix; histograms expose cumulative
    ``_bucket{le=...}`` lines over the non-empty log buckets plus
    ``_sum``/``_count``, and buckets that hold an exemplar carry the
    OpenMetrics ``# {trace_id="..."} value`` suffix linking the latency
    band to a span trace id.
    """
    reg = reg if reg is not None else default_registry()
    by_name: dict = {}
    for inst in reg.series():
        by_name.setdefault(inst.name, []).append(inst)
    lines = []
    for name in sorted(by_name):
        insts = sorted(by_name[name],
                       key=lambda i: _label_str(i.labels))
        kind = insts[0].kind
        lines.append(f"# TYPE {name} {kind}")
        for inst in insts:
            if kind == "counter":
                lines.append(f"{name}_total{_label_str(inst.labels)} "
                             f"{_fmt(inst.value)}")
            elif kind == "gauge":
                lines.append(f"{name}{_label_str(inst.labels)} "
                             f"{_fmt(inst.value)}")
            else:
                ex = inst.exemplars()
                cum = 0
                for i, c in enumerate(inst._buckets):
                    if not c:
                        continue
                    cum += c
                    le = _LO * _GROWTH ** i
                    line = (f"{name}_bucket"
                            f"{_label_str(inst.labels, {'le': repr(le)})} "
                            f"{cum}")
                    if i in ex:
                        v, trace = ex[i]
                        line += (f' # {{trace_id="{trace}"}} '
                                 f"{_fmt(v)}")
                    lines.append(line)
                lines.append(f"{name}_bucket"
                             f"{_label_str(inst.labels, {'le': '+Inf'})} "
                             f"{inst.count}")
                lines.append(f"{name}_sum{_label_str(inst.labels)} "
                             f"{_fmt(inst.sum)}")
                lines.append(f"{name}_count{_label_str(inst.labels)} "
                             f"{inst.count}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------- jsonl emitter
class JsonlEmitter:
    """Append one registry snapshot per line to a JSONL file, either on
    demand (`emit_once`) or from a daemon thread every `interval_s`."""

    def __init__(self, path: str, reg: Registry = None,
                 interval_s: float = 15.0):
        self.path = path
        self.reg = reg if reg is not None else default_registry()
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = None

    def emit_once(self):
        rec = {"ts": time.time(), "metrics": self.reg.snapshot()}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
        return rec

    def start(self):
        if self._thread is not None:
            return self

        def loop():
            while not self._stop.wait(self.interval_s):
                self.emit_once()

        self._stop.clear()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="obs-jsonl-emitter")
        self._thread.start()
        return self

    def stop(self, final_emit: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s)
            self._thread = None
        if final_emit:
            self.emit_once()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


# ---------------------------------------------------------- health report
def _parse_series_key(key: str):
    """Invert metrics._series_key: 'name{k=v,...}' -> (name, {k: v})."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels = {}
    for part in rest.rstrip("}").split(","):
        if part:
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


def registry_from_snapshot(snap: dict) -> Registry:
    """Rebuild a Registry from a snapshot() dict (ints -> counters,
    floats -> gauges, dicts -> histograms). Lossy only in that integer
    gauges come back as counters — reads via ``.value`` are unaffected."""
    reg = Registry()
    for key, val in snap.items():
        name, labels = _parse_series_key(key)
        if isinstance(val, dict):
            reg.histogram(name, **labels).load_snapshot(val)
        elif isinstance(val, float):
            reg.gauge(name, **labels).set(val)
        else:
            reg.counter(name, **labels).inc(val)
    return reg


def health_report(snapshot: dict = None, fmt: str = "md") -> str:
    """Render a registry snapshot as a health report.

    Sections: derived health gauges, counters (summed across label sets),
    and latency histograms (count/p50/p99/max, seconds). `fmt` is
    "md" (GitHub-flavored tables) or "term" (aligned plain text).
    """
    snap = snapshot if snapshot is not None else \
        default_registry().snapshot()
    gauges, counters, hists = [], {}, []
    for key, val in sorted(snap.items()):
        name, labels = _parse_series_key(key)
        if isinstance(val, dict):
            hists.append((name, labels, val))
        elif isinstance(val, float) or name.endswith(
                ("_ratio", "_rate", "_occupancy", "_amplification",
                 "_bytes", "_entries", "_runs", "_shapes", "_debt")):
            gauges.append((key, val))
        else:
            agg = counters.setdefault(name, 0)
            counters[name] = agg + val

    def table(header, rows):
        if fmt == "md":
            out = ["| " + " | ".join(header) + " |",
                   "|" + "|".join("---" for _ in header) + "|"]
            out += ["| " + " | ".join(str(c) for c in row) + " |"
                    for row in rows]
            return "\n".join(out)
        widths = [max(len(str(x)) for x in [h] + [r[i] for r in rows])
                  for i, h in enumerate(header)]
        out = ["  ".join(str(h).ljust(w) for h, w in zip(header, widths))]
        out += ["  ".join(str(c).ljust(w) for c, w in zip(row, widths))
                for row in rows]
        return "\n".join(out)

    def head(text):
        return f"### {text}" if fmt == "md" else f"== {text} =="

    parts = [head("Health gauges")]
    if gauges:
        parts.append(table(("gauge", "value"),
                           [(k, f"{v:.6g}") for k, v in gauges]))
    else:
        parts.append("(none)")
    parts.append(head("Counters (summed across labels)"))
    parts.append(table(("counter", "total"), sorted(counters.items())))
    parts.append(head("Latency histograms (s)"))
    rows = []
    for name, labels, h in hists:
        if not h.get("count"):
            continue
        rows.append((_series_label(name, labels), h["count"],
                     f"{h.get('p50', float('nan')):.3e}",
                     f"{h.get('p99', float('nan')):.3e}",
                     f"{h.get('max', float('nan')):.3e}",
                     len(h.get("exemplars", {}))))
    parts.append(table(("series", "count", "p50", "p99", "max",
                        "exemplars"), rows))
    return "\n\n".join(parts) + "\n"


def _series_label(name, labels):
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


# ----------------------------------------------------------- debug bundle
def write_debug_bundle(path: str, reg: Registry = None, tracer=None,
                       extra: dict = None) -> str:
    """One-stop diagnostic archive (zip): registry snapshot + Prometheus
    text + slow traces / flight recordings, plus any `extra` sections
    (JSON-serializable, one member per key). This is the engine under
    ``DBserver.debug_bundle`` and the bench debug-bundle artifact."""
    reg = reg if reg is not None else default_registry()
    tracer = tracer if tracer is not None else default_tracer()
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("metrics.json",
                    json.dumps(reg.snapshot(), indent=1, sort_keys=True))
        zf.writestr("prometheus.txt", prometheus_text(reg))
        zf.writestr("slow_traces.json", json.dumps(
            {"slow_threshold_s": tracer.slow_threshold_s,
             "slow_ops": tracer.slow_ops(),
             "flight_recordings": tracer.flight_recordings()}, indent=1))
        for name, payload in (extra or {}).items():
            zf.writestr(f"{name}.json",
                        json.dumps(payload, indent=1, sort_keys=True))
    return path


# -------------------------------------------------------------------- cli
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Render a metrics registry dump as a health report "
                    "or Prometheus exposition.")
    ap.add_argument("--metrics", required=True,
                    help="registry snapshot JSON (Registry.dump output)")
    ap.add_argument("--format", choices=("md", "term"), default="md")
    ap.add_argument("--prometheus", metavar="PATH",
                    help="also write Prometheus text exposition here")
    ap.add_argument("--out", metavar="PATH",
                    help="write the report here instead of stdout")
    args = ap.parse_args(argv)
    with open(args.metrics) as f:
        snap = json.load(f)
    if "tables" in snap and "aggregate" in snap:
        ap.error(f"{args.metrics} is a DBserver.dump_metrics() view, not a "
                 "raw registry snapshot — feed it Registry.dump() output "
                 "(e.g. metrics.json from DBserver.debug_bundle)")
    if args.prometheus:
        with open(args.prometheus, "w") as f:
            f.write(prometheus_text(registry_from_snapshot(snap)))
    report = health_report(snap, fmt=args.format)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report)
    else:
        sys.stdout.write(report)
    summary = os.environ.get("GITHUB_STEP_SUMMARY")
    if summary and args.format == "md":
        with open(summary, "a") as f:
            f.write("\n## Health report\n\n" + report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
