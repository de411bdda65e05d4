"""One run of one cell: the cell's files found by the names in
BENCHMARK.json, the inputs made from the seed, set-up, the measured (or
traced) window, the comparison with the reference, and the result line.

A configuration is `configs/<name>.json` (as BENCHMARK.json's `file`
says), with its field `fields/<kind>.py` and its scene
`scenes/<scene_type>.py` (as the configuration names them); a traffic
mix `traffic/<name>.json` (its `kind` picks the training or the serving
loop of `cells.py`); a per-layer metric `metrics/<name>.py`
(`read(reading)` -> a number or None); a cell's limits
`limits/<workload>.json`.  Adding a cell, a configuration, a field kind,
a scene type, a mix or a metric adds files and entries; no code here
names one.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import cells, check, scene, trace
from .reference import nerf as reference

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
TRAFFIC = HERE / "traffic"
METRICS = HERE / "metrics"
# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "tinynerf_tpu")


def load_benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def entry(entries: List[dict], name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


def load_config(bench: dict, name: str) -> dict:
    with open(REPO / entry(bench["configs"], name)["file"]) as f:
        return json.load(f)


def load_traffic(name: str) -> dict:
    with open(TRAFFIC / f"{name}.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, workload: str):
    """(end-to-end, per-layer) metric entries that the cell reports."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per_layer


def metric_reader(name: str):
    return reference.module_at(METRICS / f"{name}.py").read


@dataclass
class Reading:
    """What a per-layer reader reads: the cell's files, the traced window's
    host seconds, its trace summary (None without one) and the harness's
    counters (training: steps, samples per step, update_ms; serving: views,
    rays, packed_samples, fallback_rays)."""

    config_name: str
    config: dict
    traffic: dict
    window_s: float
    trace: Optional[trace.TraceSummary]
    counters: dict = field(default_factory=dict)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def power_limit(device: torch.device) -> str:
    """The card's power limit as nvidia-smi gives it, which every number of
    the run is read beside."""
    if device.type != "cuda":
        return "none (cpu)"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout
        return out.splitlines()[device.index or 0].strip()
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"not read ({type(exc).__name__})"


def _train(config, traffic, seed, seconds, tracing, device, t_start):
    world = reference.scene_of(config)
    pool = world.training_pool(seed, traffic, device)
    params0 = scene.make_params(config, seed, device)
    loop = cells.TrainLoop(config, traffic, seed, device, pool, params0)
    checked = cells.train_setup(loop, params0)
    del params0
    setup_s = time.perf_counter() - t_start
    loop.trace = tracing
    with trace.profiled(tracing, device) as prof:
        w = loop.window(n_steps=traffic["trace_steps"]) if tracing else loop.window(seconds=seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del loop
    free_device()
    summary = trace.summarize(prof) if prof is not None else None
    grid, mean = world.occupancy_grid(traffic["occupancy"], config["train"]["occupancy_res"], device)
    ref = reference.train_steps(config, scene.make_params(config, seed, device), pool, grid, mean, checked["steps"],
                                prec=config["compute"])
    values = {"setup_s": setup_s, "train_rays_per_s": w["rays"] / w["seconds"], "peak_device_gb": peak / 1e9}
    counters = {"steps": w["steps"], "samples": w["samples"], "update_ms": w["update_ms"]}
    return values, check.train_numbers(checked, ref), w, counters, summary, peak


def _serve(config, traffic, seed, seconds, tracing, device, t_start):
    world = reference.scene_of(config)
    rays_o, rays_d = world.served_rays(traffic, device)
    loop = cells.ServeLoop(config, traffic, device, cells.HostViews(rays_o, rays_d),
                           scene.make_params(config, seed, device))
    loop.window(n_views=traffic["warmup_views"])
    setup_s = time.perf_counter() - t_start
    loop.trace = tracing
    with trace.profiled(tracing, device) as prof:
        w = loop.window(n_views=traffic["trace_views"]) if tracing else loop.window(seconds=seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del loop
    free_device()
    summary = trace.summarize(prof) if prof is not None else None
    rng = np.random.default_rng(scene.stream_seed(seed, 3))
    picks = rng.choice(w["views"], size=min(traffic["check_views"], w["views"]), replace=False)
    params = scene.make_params(config, seed, device)
    grid, mean = world.occupancy_grid(traffic["occupancy"], config["train"]["occupancy_res"], device)
    refs, images = [], []
    for k in sorted(int(k) for k in picks):
        v = w["view_index"][k]
        o = torch.from_numpy(rays_o[v].reshape(-1, 3)).to(device)
        d = torch.from_numpy(rays_d[v].reshape(-1, 3)).to(device)
        refs.append(reference.render_view(config, params, o, d, grid, mean, prec=config["compute"])
                    .cpu().numpy().reshape(rays_o[v].shape))
        images.append(w["images"][k])
    values = {"setup_s": setup_s, "serve_s_per_view": w["seconds"] / w["views"], "peak_device_gb": peak / 1e9}
    counters = {k: w[k] for k in ("views", "rays", "packed_samples", "fallback_rays")}
    return values, check.serve_numbers(images, refs), w, counters, summary, peak


KINDS = {"train": _train, "serve": _serve}


def run_cell(workload: str, seed: int, seconds: float, tracing: bool, device: torch.device,
             t_start: float, bench: Optional[dict] = None) -> dict:
    """The result line's object for one run of `workload`."""
    bench = bench if bench is not None else load_benchmark()
    cell = entry(bench["workloads"], workload)
    return run_loaded(bench, cell, load_config(bench, cell["config"]), load_traffic(cell["traffic"]),
                      check.load_limits(workload), seed, seconds, tracing, device, t_start)


def run_loaded(bench: dict, cell: dict, config: dict, traffic: dict, limits: Dict[str, float], seed: int,
               seconds: float, tracing: bool, device: torch.device, t_start: float) -> dict:
    """`run_cell` on files already read (the tests give small ones)."""
    workload = cell["name"]
    values, numbers, w, counters, summary, peak = KINDS[traffic["kind"]](
        config, traffic, seed, seconds, tracing, device, t_start)
    checks = check.judge(numbers, limits)
    e2e, per_layer = cell_metrics(bench, workload)
    metrics: Dict[str, dict] = {}
    if tracing:
        reading = Reading(cell["config"], config, traffic, w["seconds"], summary, counters)
        for m in per_layer:
            value = metric_reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak), "power_limit": power_limit(device)}
    result = {"correct": all(c["ok"] for c in checks.values()), "attempted": w.get("steps", w.get("views")),
              "failed": w["failed"], "metrics": metrics, "device": dev}
    if tracing and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return result


def check_lines(result: dict) -> List[str]:
    return [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in result["checks"].items()]
