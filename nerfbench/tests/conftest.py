"""Small cells for the CPU tests: the configurations at a tiny field scale
(the program's `field_scale`, the same structure), a few small views and
short loops; and the fixture of the tests that need a card."""

from __future__ import annotations

import copy
import math
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from nerfbench import harness, scene  # noqa: E402
from nerfbench.reference import nerf as reference  # noqa: E402


def tiny(config: dict) -> dict:
    """`config` at the tiny size: small batches and grids, and the field's
    own tiny sizes (its field file's `TINY`: a group's keys replaced, any
    other top-level value replaced whole)."""
    config = copy.deepcopy(config)
    config["train"].update(batch_size=64, n_samples=32, occupancy_res=16, occupancy_update_every=2,
                           eval_samples_per_ray=8)
    for key, value in reference.field_of(config).TINY.items():
        config[key] = dict(config[key], **value) if isinstance(value, dict) else value
    config["params"] = sum(math.prod(s) for s in scene.param_shapes(config).values())
    return config


def tiny_config(name: str) -> dict:
    return tiny(harness.load_config(harness.load_benchmark(), name))


def tiny_traffic(name: str) -> dict:
    traffic = harness.load_traffic(name)
    if traffic["kind"] == "train":
        traffic.update(views=2, res=24, warmup_steps=6, trace_steps=4, flush_every=2)
    else:
        traffic.update(ring_poses=4, views=2, res=24, chunk=64, packed_samples_per_ray=8, trace_views=2)
    return traffic


def tiny_run(workload: str, seed: int = 12345678901, tracing: bool = False, limits=None) -> dict:
    """One run of `workload`'s cell on the CPU at the tiny size (the card
    check skipped), judged by `limits` (default: the cell's own)."""
    bench = harness.load_benchmark()
    cell = harness.entry(bench["workloads"], workload)
    if limits is None:
        limits = harness.check.load_limits(workload)
    return harness.run_loaded(bench, cell, tiny_config(cell["config"]), tiny_traffic(cell["traffic"]), limits,
                              seed, 0.5, tracing, torch.device("cpu"), 0.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the program's kernels have no CPU mode)")
    return torch.device("cuda", 0)
