"""The benchmark's driver: it finds a cell's configuration, traffic mix and
metrics by the names in ``BENCHMARK.json``, sets the cell up, runs the mix's
loop for the window, reads the metrics and judges the outputs.

Nothing here is particular to one cell. A configuration file names its
system (``systems/<system>.py``, with its plain reference beside it); a
mix is a data file under ``traffic/`` that names its loop
(``loops/<loop>.py``) and its operations (``ops/<op>.py``); each metric is
a reader of its own, ``metrics/<metric>.py``, with one function
``read(ctx)`` that returns a number or None, and optionally ``SPANS``:
(label, path, attribute) of further calls a traced run times, the path an
attribute chain on the system's cell (``"server"``, ``"store._wal"``). The
metrics a cell reports are those whose ``workloads`` list it, or that list
no cells.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
WINDOW = "portbench.window"
# top-level module names a run may never load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def foreign_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def load_bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: the end-to-end ones with
    ``--trace 0``, the per-layer ones with ``--trace 1``."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def load_metric(name: str):
    """The module ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str):
    return load_metric(name).read


class Context:
    """What a metric reader reads: the window's operations (``ops``: kind,
    tag, entries, seconds), ``window_s``, ``setup_s``; in a traced run the
    harness's spans (``spans``: label -> seconds, ``span_bytes``: label ->
    bytes counted), the reduced device trace (``trace``) and the program's
    own counters and histogram sums over the window (``program``)."""

    def __init__(self, ops, window_s, setup_s, spans=None, span_bytes=None,
                 trace=None, program=None):
        self.ops = ops
        self.window_s = window_s
        self.setup_s = setup_s
        self.spans = spans or {}
        self.span_bytes = span_bytes or {}
        self.trace = trace or {}
        self._program = program or []

    def latencies(self, kind: str) -> np.ndarray:
        return np.asarray([o[3] for o in self.ops if o[0] == kind])

    def entries(self, kind: str) -> int:
        return sum(o[2] for o in self.ops if o[0] == kind)

    def program_sum(self, name: str, **labels) -> float:
        """The change over the window of the program's counter ``name``, or
        of its histogram's sum, over every series with these labels."""
        return sum(d for n, lab, d in self._program if n == name and all(
            str(lab.get(k)) == str(v) for k, v in labels.items()))


def _registry_values():
    from repro_torch.obs import default_registry
    out = {}
    for inst in default_registry().series():
        value = getattr(inst, "sum", None) if inst.kind == "histogram" \
            else inst.value
        if isinstance(value, (int, float)):
            out[id(inst)] = (inst.name, dict(inst.labels), float(value))
    return out


class Spans:
    """Wraps calls into the program's layers for a traced run: each call is
    a profiler annotation named by its label and adds its host seconds (and
    any bytes its counter reports) to the label's total. ``undo`` puts the
    program's own attributes back."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.bytes = defaultdict(int)
        self._undo = []

    def wrap(self, label, obj, attr, counter=None):
        if any(o is obj and a == attr for o, a, _ in self._undo):
            return  # timed once, whoever asks for it
        fn = getattr(obj, attr)
        record = torch.profiler.record_function
        seconds, nbytes = self.seconds, self.bytes

        def wrapper(*args, **kw):
            tok = counter[0](*args, **kw) if counter else None
            with record(label):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    seconds[label] += time.perf_counter() - t0
                    if counter:
                        nbytes[label] += counter[1](tok)
        had = attr in vars(obj)
        setattr(obj, attr, wrapper)
        self._undo.append((obj, attr, fn if had else None))

    def undo(self):
        for obj, attr, fn in reversed(self._undo):
            if fn is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, fn)
        self._undo = []


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _merge(base: dict, extra: dict) -> dict:
    """``base`` with ``extra``'s keys, nested groups merged key by key."""
    out = dict(base)
    for k, v in extra.items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t0: float, device: str = "cuda", overrides: dict = None,
             log=print) -> tuple:
    """Run one cell of ``BENCHMARK.json``; returns (result, checks)."""
    bench = load_bench()
    cell = find_cell(bench, workload)
    return run(cell["config"], cell["traffic"], seed, seconds, trace, t0,
               device=device, overrides=overrides, log=log, cell=cell)


def run(config: str, traffic: str, seed: int, seconds: float, trace: bool,
        t0: float, device: str = "cuda", overrides: dict = None, log=print,
        cell: dict = None) -> tuple:
    """Run a configuration under a traffic mix, each found by its name
    (the configuration's file through ``BENCHMARK.json``, or
    ``configs/<config>.json``); returns (result, checks). ``overrides``
    maps ``"config"`` and ``"mix"`` to keys merged over the files' (the
    CPU tests run a small copy of a cell this way)."""
    bench = load_bench()
    cell = cell or {"name": f"{config}.{traffic}", "config": config,
                    "traffic": traffic, "chips": 1}
    files = {c["name"]: c["file"] for c in bench["configs"]}
    path = ROOT / files.get(config, f"portbench/configs/{config}.json")
    with open(path) as f:
        cfg = json.load(f)
    with open(HERE / "traffic" / f"{traffic}.json") as f:
        mix = json.load(f)
    overrides = overrides or {}
    cfg = _merge(cfg, overrides.get("config", {}))
    mix = _merge(mix, overrides.get("mix", {}))
    dev = torch.device(device)
    system = importlib.import_module(f"portbench.systems.{cfg['system']}")
    loop = importlib.import_module(f"portbench.loops.{mix['loop']}")

    sut = system.Cell(cfg, mix, seed, dev)
    try:
        return _measure(bench, cell, sut, loop, mix, seconds, trace, t0,
                        dev, log)
    finally:
        sut.close()


def _measure(bench, cell, sut, loop, mix, seconds, trace, t0, dev,
             log):
    spans = Spans()
    prof = None
    if trace:
        for label, obj, attr, counter in sut.spans():
            spans.wrap(label, obj, attr, counter)
        for m in cell_metrics(bench, cell["name"], True):
            for label, path, attr in getattr(load_metric(m["name"]),
                                             "SPANS", ()):
                obj = sut
                for part in path.split("."):
                    obj = getattr(obj, part)
                spans.wrap(label, obj, attr)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    before = _registry_values()
    record = (torch.profiler.record_function if trace
              else contextlib.nullcontext)
    _sync(dev)
    start = time.perf_counter()
    setup_s = start - t0
    with record(WINDOW):
        ops, failed = loop.run(mix, sut.ops(), seconds, record,
                               lambda: _sync(dev), log)
        _sync(dev)
    window_s = time.perf_counter() - start
    after = _registry_values()
    spans.undo()
    reduced = None
    t_mark = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
        labels = set(spans.seconds) | {o[0] for o in ops}
        reduced = _reduce(prof, labels)
        prof = None
    trace_s = time.perf_counter() - t_mark
    peak = (int(torch.cuda.max_memory_allocated(dev))
            if dev.type == "cuda" else 0)
    program = [(name, labels, after[k][2] - value)
               for k, (name, labels, value) in before.items() if k in after]
    ctx = Context(ops, window_s, setup_s, spans=dict(spans.seconds),
                  span_bytes=dict(spans.bytes), trace=reduced,
                  program=program)
    metrics = {}
    for m in cell_metrics(bench, cell["name"], trace):
        value = load_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    t_mark = time.perf_counter()
    checks = sut.check()
    log(f"phases: setup {setup_s:.3f} s, window {window_s:.3f} s, "
        f"trace reduction {trace_s:.3f} s, check "
        f"{time.perf_counter() - t_mark:.3f} s", file=sys.stderr)
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(ops) + failed,
              "failed": failed, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = (reduced or {}).get("busy_s", 0.0)
        device["window_s"] = window_s
        if reduced:
            result["breakdown"] = {
                "device_ops": [list(x) for x in reduced["device_ops"][:10]],
                "idle_gaps": [list(x) for x in reduced["idle_gaps"][:10]]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks


def _reduce(prof, labels):
    from .measure import reduce_trace
    return reduce_trace(prof.profiler.kineto_results.events(), labels, WINDOW)
