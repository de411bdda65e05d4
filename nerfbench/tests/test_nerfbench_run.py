"""Whole runs at a tiny size on the CPU, the card check skipped: the result
line, the reference against the program's plain path, a cell and a field
kind added as files alone, the same served work at every seed, and no
result without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import tiny, tiny_config, tiny_run, tiny_traffic

from nerfbench import counts, harness
from nerfbench.reference import nerf as reference

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


# the vanilla NeRF field of `tinynerf_tpu_torch/models/vanilla.py`, a field
# kind that the benchmark's own files do not have
VANILLA_FIELD = '''"""The vanilla NeRF field: posenc(x) into an MLP whose last layer's
output is the feature vector."""

from nerfbench.reference.nerf import mlp, mlp_shapes, posenc

CONTROL = None
TINY = {"train": {"field_scale": 0.125}, "field": {"mlp": [60] + [32] * 10}, "sigma_decoder": [32, 64, 1],
        "rgb_decoder": {"dims": [83, 64, 64, 64, 64, 3]}}


def param_shapes(config):
    return mlp_shapes("field.mlp", config["field"]["mlp"])


def features(config, params, x, prec, dropout_seed=None, rows=None):
    field = config["field"]
    return [mlp(params, "field.mlp", len(field["mlp"]) - 1, [posenc(x, field["n_freqs"])], prec)]


def extra_loss(config, params):
    return None
'''


def vanilla_config(train: dict) -> dict:
    """train()'s vanilla widths: posenc(10) -> 8 x 256, the shared decoders."""
    return {
        "name": "vanilla", "method": "vanilla", "params": 0,
        "field": {"kind": "vanilla", "n_freqs": 10, "mlp": [60] + [256] * 10},
        "sigma_decoder": [256, 64, 1], "rgb_decoder": {"n_freqs": 8, "dims": [307, 64, 64, 64, 64, 3]},
        "init": {"field.mlp": {"linear": "he"}, "sigma_decoder.mlp": {"linear": "torch"},
                 "rgb_decoder.mlp": {"linear": "torch"}},
        "train": dict(train, method="vanilla", field_scale=1.0),
        "optimizer": {"lr": 1e-3, "lr_tables": 1e-3, "b1": 0.9, "b2": 0.999, "eps": 1e-15, "weight_decay": 1e-5,
                      "tables": []},
        "compute": "bf16",
    }


def test_a_field_kind_added_as_files(tmp_path, monkeypatch):
    """A configuration of a field kind the benchmark does not have (its
    field file, configuration, counts, limits, traffic and cell) is files
    and entries alone, and runs correct."""
    for d in ("fields", "configs", "counts", "limits", "traffic"):
        (tmp_path / d).mkdir()
    (tmp_path / "traffic" / "train_early.json").write_text(json.dumps(tiny_traffic("train_early")))
    (tmp_path / "fields" / "vanilla.py").write_text(VANILLA_FIELD)
    (tmp_path / "counts" / "peaks.json").write_text((counts.HERE / "peaks.json").read_text())
    monkeypatch.setattr(reference, "FIELDS", tmp_path / "fields")
    monkeypatch.setattr(counts, "HERE", tmp_path / "counts")
    monkeypatch.setattr(harness, "TRAFFIC", tmp_path / "traffic")
    monkeypatch.setattr(harness.check, "LIMITS", tmp_path / "limits")
    config = tiny(vanilla_config(harness.load_config(harness.load_benchmark(), "kplanes")["train"]))
    assert config["field"]["mlp"][1] == 32 and config["params"] == 31684
    (tmp_path / "configs" / "vanilla.json").write_text(json.dumps(config))
    matmuls = [[60, 32]] + [[32, 32]] * 9 + [[32, 64], [64, 1], [32, 64], [64, 64], [64, 64], [64, 64], [64, 3]]
    (tmp_path / "counts" / "vanilla.json").write_text(json.dumps({"sample_matmuls": matmuls,
                                                                  "direction_matmuls": [[51, 64]]}))
    (tmp_path / "limits" / "vanilla.train.early.json").write_text(json.dumps({"limits": TRAIN}))
    bench = harness.load_benchmark()
    bench["configs"] = [{"name": "vanilla", "source": "https://arxiv.org/abs/2003.08934",
                         "file": str(tmp_path / "configs" / "vanilla.json"), "reduced": [], "why": "a test"}]
    cell = "vanilla.train.early"
    bench["workloads"] = [{"name": cell, "config": "vanilla", "traffic": "train_early", "chips": 1, "why": "a test"}]
    bench["end_to_end"] = [dict(m, workloads=[cell]) if "workloads" in m else m for m in bench["end_to_end"]
                           if m.get("workloads") != ["kplanes.serve.views"]]
    bench["per_layer"] = [dict(harness.entry(bench["per_layer"], "train.step_mfu"), workloads=[cell])]
    for tracing in (False, True):
        result = harness.run_cell(cell, 5, 0.2, tracing, torch.device("cpu"), 0.0, bench)
        assert result["correct"], result["checks"]
        names = {"train.step_mfu"} if tracing else {"setup_s", "train_rays_per_s", "peak_device_gb"}
        assert set(result["metrics"]) == names and result["failed"] == 0


SERVE_CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]
               if harness.load_traffic(w["traffic"])["kind"] == "serve"]


@pytest.mark.parametrize("workload", SERVE_CELLS)
def test_served_work_is_the_same_at_every_seed(workload):
    """The served views do not depend on the seed, so neither do the rays,
    the packed samples and the rays re-rendered densely; the seed still
    draws the parameters, so the pixels differ."""
    bench = harness.load_benchmark()
    cell = harness.entry(bench["workloads"], workload)
    config = tiny_config(cell["config"])
    # a packed cap of one sample a ray, so that some rays fall back at this size
    traffic = dict(tiny_traffic(cell["traffic"]), packed_samples_per_ray=1)
    runs = [harness.KINDS["serve"](config, traffic, seed, 0.5, True, torch.device("cpu"), 0.0)
            for seed in (3, 2**31 + 11)]
    (_, _, w0, c0, _, _), (_, _, w1, c1, _, _) = runs
    assert c0 == c1 and c0["fallback_rays"] > 0
    assert w0["view_index"] == w1["view_index"]
    assert not np.array_equal(w0["images"][0], w1["images"][0])


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload", "kplanes.train.early",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, env=env, cwd=harness.REPO, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
