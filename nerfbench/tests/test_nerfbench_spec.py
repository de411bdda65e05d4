"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

from __future__ import annotations

import json
import math
import re

import pytest

from nerfbench import counts, harness, scene

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_benchmark()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units():
    assert set(BENCH) == KEYS["top"]
    assert len((harness.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["command"][:2] == ["python3", "nerfbench/run.py"] and BENCH["paths"] == ["nerfbench"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        for e in BENCH[group]:
            assert set(e) <= KEYS[group] and set(e) >= KEYS[group] - {"workloads"}, (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher"), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert _line(e[key]), (e["name"], key)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] == 1 and _line(w["why"])


def test_bounds_and_metrics_of_every_cell():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= set(WORKLOADS)
    for w in WORKLOADS:
        cell_e2e, per_layer = harness.cell_metrics(BENCH, w)
        names = {m["name"] for m in cell_e2e}
        assert "setup_s" in names and len(names) >= 2 and per_layer, w
        for m in per_layer:
            assert m["moves"] in names, (w, m["name"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_found_by_name(workload):
    cell = harness.entry(BENCH["workloads"], workload)
    config = harness.load_config(BENCH, cell["config"])
    traffic = harness.load_traffic(cell["traffic"])
    assert traffic["kind"] in harness.KINDS
    assert set(harness.check.load_limits(workload))
    _, per_layer = harness.cell_metrics(BENCH, workload)
    for m in per_layer:
        assert callable(harness.metric_reader(m["name"]))
    assert sum(math.prod(s) for s in scene.param_shapes(config).values()) == config["params"]
    assert counts.flops(cell["config"])["sample_matmuls"]


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_files_state_their_sources(name):
    entry = harness.entry(BENCH["configs"], name)
    config = harness.load_config(BENCH, name)
    assert entry["file"].startswith("nerfbench/") and entry["reduced"] == config["reduced"] == []
    assert _line(config["source"]) and config["assumed"] and config["name"] == name
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    json.dumps(config)
