"""BENCHMARK.json, the configurations, mixes and metric readers it names:
every entry parses, every name and unit keeps to its characters, and every
per-layer metric's cells report the end-to-end metric it moves."""
import json
import re

import pytest

from portbench import harness

BENCH = harness.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
CELL_NAMES = [c["name"] for c in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    script = BENCH["command"][1]
    assert any(script.startswith(p + "/") for p in BENCH["paths"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_entry_and_file(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and line(conf["source"])
    assert line(conf["why"]) and len(conf["reduced"]) <= 16
    assert conf["file"].startswith(BENCH["paths"][0] + "/")
    with open(harness.ROOT / conf["file"]) as f:
        cfg = json.load(f)
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    for key in conf["reduced"]:
        assert NAME.match(key) and key in cfg and key in cfg["reduced"]
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_workload_entry(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and line(cell["why"])
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    with open(harness.HERE / "traffic" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    assert mix["loop"] == "closed" and mix["clients"] == 1
    ends = [m["name"] for m in harness.cell_metrics(BENCH, cell["name"],
                                                    False)]
    assert "setup_s" in ends and len(ends) >= 2
    assert harness.cell_metrics(BENCH, cell["name"], True)


def test_names_are_unique_and_cells_ask_for_one_chip():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(c["chips"] == 4 for c in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry_and_reader(metric):
    end = metric in BENCH["end_to_end"]
    keys = {"name", "unit", "better", "source"} | (
        {"bound"} if end else {"layer", "moves"})
    assert keys <= set(metric) <= keys | {"workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(harness.load_reader(metric["name"]))
    for w in metric.get("workloads", []):
        assert w in CELL_NAMES
    if end:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        return
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert line(metric["layer"])
    moved = [m for m in BENCH["end_to_end"] if m["name"] == metric["moves"]]
    assert moved
    reporters = moved[0].get("workloads", CELL_NAMES)
    for w in metric.get("workloads", CELL_NAMES):
        assert w in reporters
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_setup_bound():
    (setup,) = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup["bound"] <= 0.25 and "workloads" not in setup
