"""repro_torch.obs — lightweight, dependency-free observability.

Metrics (counters / gauges / log-bucketed histograms with labeled series)
plus nested wall-time span tracing with ring-buffer retention and
Chrome-trace export. See src/repro/db/README.md "Observability" for the
metric catalog and span taxonomy used by the database stack.
"""
from .metrics import (Counter, Gauge, Histogram, Registry, default_registry,
                      merge_snapshots, set_enabled)
from .tracing import (Tracer, current_trace, default_tracer, set_tracing,
                      span)
from .export import (JsonlEmitter, health_report, prometheus_text,
                     write_debug_bundle)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "default_registry",
    "merge_snapshots", "set_enabled",
    "Tracer", "current_trace", "default_tracer", "set_tracing", "span",
    "JsonlEmitter", "health_report", "prometheus_text",
    "write_debug_bundle",
]
