"""Whole runs at a tiny size on the CPU, the card check skipped: the result
line, the reference against the program's plain path, a cell added as
files alone, and no result without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch
from conftest import tiny_config, tiny_run, tiny_traffic

from nerfbench import harness

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]
# the program's plain path against the float32 reference on the CPU: bf16
# compute and gathers move a loss by ~1e-3 and a leaf norm by ~1e-2 at this
# size (loose enough for any seed, tight enough to catch a missing term)
TRAIN = {"first_loss_gap": 1e-2, "loss_gap": 1e-2, "count_gap": 0.0, "grad_gap": 5e-2, "update_gap": 5e-2}
SERVE = {"view_rmse": 1e-4, "view_max_gap": 1e-3}


@pytest.mark.parametrize("workload", ["kplanes.train.early", "cobafa.train.early", "kplanes.serve.views"])
def test_reference_agrees_with_the_plain_path(workload):
    result = tiny_run(workload, limits=SERVE if "serve" in workload else TRAIN)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1


@pytest.mark.parametrize("tracing", [False, True])
def test_result_line(tracing):
    result = tiny_run("kplanes.serve.views", tracing=tracing, limits=SERVE)
    keys = list(result)
    assert keys[: len(REQUIRED)] == REQUIRED and keys[-1] == "checks"
    assert set(keys) == set(REQUIRED) | {"checks"} | ({"breakdown"} if tracing else set())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    bench = harness.load_benchmark()
    e2e, per_layer = harness.cell_metrics(bench, "kplanes.serve.views")
    if tracing:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(result["metrics"]) <= {m["name"] for m in per_layer}
        assert "serve.fallback_rays" in result["metrics"]  # a counter, read on any device
    else:
        assert set(result["metrics"]) == {m["name"] for m in e2e}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


def test_a_cell_added_as_files(tmp_path, monkeypatch):
    """A new traffic mix, per-layer metric, limits and cell are files and
    entries alone."""
    traffic = dict(tiny_traffic("serve_views"), views=1, users="a dummy mix")
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "dummy_views.json").write_text(json.dumps(traffic))
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "dummy.views.py").write_text("def read(r):\n    return float(r.counters['views'])\n")
    (tmp_path / "limits").mkdir()
    (tmp_path / "limits" / "kplanes.dummy.json").write_text(json.dumps({"limits": SERVE}))
    config_file = tmp_path / "tiny_kplanes.json"
    config_file.write_text(json.dumps(tiny_config("kplanes")))
    monkeypatch.setattr(harness, "TRAFFIC", tmp_path / "traffic")
    monkeypatch.setattr(harness, "METRICS", tmp_path / "metrics")
    monkeypatch.setattr(harness.check, "LIMITS", tmp_path / "limits")
    bench = harness.load_benchmark()
    bench["configs"] = [dict(bench["configs"][0], file=str(config_file))]
    bench["workloads"] = [{"name": "kplanes.dummy", "config": "kplanes", "traffic": "dummy_views", "chips": 1,
                           "why": "a dummy"}]
    bench["end_to_end"] = [dict(m, workloads=["kplanes.dummy"]) if "workloads" in m else m
                           for m in bench["end_to_end"] if m.get("workloads") != ["kplanes.train.early",
                                                                                   "cobafa.train.early"]]
    bench["per_layer"] = [{"name": "dummy.views", "unit": "views", "better": "higher", "source": "host_clock",
                           "layer": "serving", "moves": "serve_s_per_view", "workloads": ["kplanes.dummy"]}]
    result = harness.run_cell("kplanes.dummy", 3, 0.1, True, torch.device("cpu"), 0.0, bench)
    assert result["correct"] and result["metrics"] == {"dummy.views": {"value": 2.0, "unit": "views"}}


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload", "kplanes.train.early",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, env=env, cwd=harness.REPO, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
