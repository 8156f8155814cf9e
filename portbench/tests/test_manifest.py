"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json
import math
import re

import pytest

from portbench import common

BENCH = common.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    # A full check of 24 cells, compiles and 1,200 s spare included, fits 43,200 s.
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("portbench/")
    data = common.load_json(common.ROOT / config["file"])
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_files(name):
    cell, traffic, config = common.cell_files(name)
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and cell["traffic"] == name
    assert traffic["config"] == cell["config"]
    assert (common.BENCH_DIR / "entries" / f"{traffic['entry']}.py").exists()
    assert traffic["limits"], "every cell compares something"
    end_to_end = [m["name"] for m in common.metrics_of(name, "end_to_end", BENCH)]
    assert "setup_s" in end_to_end and len(end_to_end) >= 2
    if traffic["entry"] == "sample":
        assert traffic["throughput_metric"] in end_to_end
    assert common.metrics_of(name, "per_layer", BENCH)


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metrics(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metrics(metric):
    assert set(metric) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    # Every cell that lists the metric reports the end-to-end metric it moves.
    assert set(metric["workloads"]) <= set(moved.get("workloads", CELLS))
    assert hasattr(common.load_reader(metric["name"]), "read")
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_layers_are_named_alike():
    """Metrics of one layer give the same layer name, letter for letter."""
    by_key = {}
    for m in BENCH["per_layer"]:
        by_key.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_key.values())


def test_sub_seed_takes_any_whole_number():
    seeds = {common.sub_seed(s, "x") for s in (0, 1, 2**31 + 5, 2**40, 10**15)}
    assert len(seeds) == 5 and all(0 <= s < 2**63 for s in seeds)


def test_check_numbers():
    ok, checks = common.check_numbers({"a": 1e-6, "b": 0.0}, {"a": 1e-4, "b": 0})
    assert ok and list(checks) == ["a", "b"]
    assert not common.check_numbers({"a": math.nan}, {"a": 1.0})[0]
    assert not common.check_numbers({"a": 2.0}, {"a": 1.0})[0]
    assert not common.check_numbers({}, {"a": 1.0})[0]
