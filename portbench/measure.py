"""The yardstick's arithmetic: the H100's peak bandwidth, a kernel's bound,
and the reduction of a torch.profiler trace to device time.

``PEAK_BYTES_PER_S`` and ``bound_ms`` are copied from the port's
``chip_smoke.py``, and ``reduce_trace`` keeps its rule that only device-side
events count as device time (a host op's device time repeats that of the
kernels and copies it issued). It reads the profiler's raw events rather
than its ``events()`` tree, whose building takes minutes for the millions
of host ops a traced window of reads records.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 bandwidth
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(n_bytes: float) -> float:
    """The least time the card could take to move ``n_bytes`` of HBM."""
    return n_bytes / PEAK_BYTES_PER_S * 1e3


def _union(starts: np.ndarray, ends: np.ndarray):
    """Sorted, disjoint union of the intervals [starts, ends)."""
    if not len(starts):
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > e[:-1]
    last = np.append(np.flatnonzero(new)[1:] - 1, len(s) - 1)
    return s[new], e[last]


def _lookup(keys, values, q, inside=False):
    """``values`` at ``q`` in the sorted ``keys`` (-1 where absent); with
    ``inside``, whether ``q`` lies in [keys, values) of sorted disjoint
    intervals."""
    if not len(keys):
        return np.zeros(len(q), bool) if inside else np.full(len(q), -1)
    if inside:
        k = np.searchsorted(keys, q, side="right") - 1
        return (k >= 0) & (q >= 0) & (q < values[k.clip(min=0)])
    at = np.searchsorted(keys, q).clip(max=len(keys) - 1)
    return np.where(keys[at] == q, values[at], -1)


def reduce_trace(events, labels, window_label: str) -> dict:
    """Reduce a profiler's raw events (``kineto_results.events()``, times in
    ns) over the window that the host annotation ``window_label`` spans.

    Returns seconds: ``busy_s`` (the union of device events in the window),
    ``device_s`` (their sum), ``d2h_s`` (copies from device to host),
    ``in_label_s`` (device time of the kernels and copies launched while the
    host was inside each annotation in ``labels``), ``device_ops`` (device
    time by name, largest first) and ``idle_gaps`` (device idle time by the
    innermost annotation the host was in, largest first)."""
    from torch.autograd import DeviceType

    marks = set(labels) | {window_label}
    annot, launch_corr, launch_t = [], [], []
    d0, d1, dname, dcorr = [], [], [], []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name in marks:
                annot.append((e.start_ns(), e.end_ns(), name))
            if e.linked_correlation_id() == 0:
                launch_corr.append(e.correlation_id())
                launch_t.append(e.start_ns())
        elif name not in marks:  # a gpu_user_annotation spans idle gaps
            d0.append(e.start_ns())
            d1.append(e.end_ns())
            dname.append(name)
            dcorr.append(e.linked_correlation_id())
    win = [(s, t) for s, t, n in annot if n == window_label]
    if not win:
        return {}
    w0, w1 = win[0]
    d0, d1 = np.asarray(d0, np.int64), np.asarray(d1, np.int64)
    dur = (d1 - d0).astype(np.float64)
    inside = (d1 > w0) & (d0 < w1)
    b0, b1 = _union(np.maximum(d0[inside], w0), np.minimum(d1[inside], w1))
    by_name = defaultdict(float)
    for name, t in zip(dname, dur):
        by_name[name] += t
    d2h = sum(t for name, t in by_name.items()
              if "DtoH" in name or "Device -> Pinned" in name)

    # each device event at the time the host op that launched it started
    corr = np.asarray(launch_corr, np.int64)
    order = np.argsort(corr)
    corr, t_host = corr[order], np.asarray(launch_t, np.int64)[order]
    when = _lookup(corr, t_host, np.asarray(dcorr, np.int64))
    in_label = {}
    for label in labels:
        s, t = _union(np.asarray([a for a, _, n in annot if n == label],
                                 np.int64),
                      np.asarray([b for _, b, n in annot if n == label],
                                 np.int64))
        in_label[label] = float(
            dur[_lookup(s, t, when, inside=True)].sum()) / 1e9

    # idle gaps, each named by the innermost annotation open at its middle
    # (annotations on the host thread nest: one sweep with a stack)
    gaps = list(zip(np.append(w0, b1), np.append(b0, w1)))
    nested = sorted((a, -b, n) for a, b, n in annot if n != window_label)
    idle = defaultdict(float)
    stack, j = [], 0
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        while j < len(nested) and nested[j][0] <= mid:
            while stack and stack[-1][0] < nested[j][0]:
                stack.pop()
            stack.append((-nested[j][1], nested[j][2]))
            j += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        idle[stack[-1][1] if stack else "harness"] += (g1 - g0) / 1e9
    return {
        "busy_s": float((b1 - b0).sum()) / 1e9,
        "device_s": float(dur.sum()) / 1e9,
        "d2h_s": d2h / 1e9,
        "in_label_s": in_label,
        "device_ops": sorted(((k, v / 1e9) for k, v in by_name.items()),
                             key=lambda kv: -kv[1]),
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1]),
    }


# ---------------------------------------------------------------- readers
# shared by the metrics that read one quantity in cells that report
# different end-to-end metrics (``metrics/<name>.py`` imports it as
# ``read``)

def idle_pct(ctx):
    """Share of the traced window in which no operation ran on the card:
    one less the union of the profiler's device events over the window."""
    busy = ctx.trace.get("busy_s", 0.0)
    return 100.0 * (1.0 - busy / ctx.window_s) if busy > 0 else None


def plan_pct(ctx):
    """Share of the read wall in the connector's planning: the selector to
    a ``ReadPlan`` and ``Table._execute_plans`` less its calls into the
    store."""
    wall = ctx.latencies("read").sum()
    s = ctx.spans
    if not wall or "connector.plan" not in s:
        return None
    return 100.0 * (s["connector.plan"] + s.get("connector.execute", 0.0)
                    - s.get("store.read", 0.0)) / wall
