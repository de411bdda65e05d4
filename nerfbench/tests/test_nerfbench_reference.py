"""The reference's outputs at a tiny size on the CPU, pinned bit for bit:
three training steps (losses, counts, each leaf's first gradient norm and
change) and a served view's pixels, of every configuration in
`data/reference_tiny.json`.  A change to how the reference finds its field
and scene must leave them as they are."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import pytest
import torch
from conftest import tiny_config

from nerfbench import scene
from nerfbench.reference import nerf as reference

PINNED = Path(__file__).resolve().parent / "data" / "reference_tiny.json"
SEED = 20260418
RES = 24


def outputs(name: str) -> dict:
    """The pinned quantities of configuration `name` at the tiny size, on
    two views' rays of the ring rule (the "all" state for training, the
    "shell" state for the served view)."""
    cpu = torch.device("cpu")
    config = tiny_config(name)
    world = reference.scene_of(config)
    res_grid = config["train"]["occupancy_res"]
    o, d = scene.pinhole_rays(torch.from_numpy(scene.ring_poses(SEED, 0, 2, 4.0)), RES, 0.6911112070083618)
    pool = (o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous(),
            world.spheres_rgb(o, d).reshape(-1, 3).contiguous())
    params = scene.make_params(config, SEED, cpu)
    grid, mean = world.occupancy_grid("all", res_grid, cpu)
    steps = [(scene.stream_seed(SEED, 1000 + k), 256) for k in range(3)]
    train = reference.train_steps(config, params, pool, grid, mean, steps, prec=config["compute"])
    grid, mean = world.occupancy_grid("shell", res_grid, cpu)
    view = reference.render_view(config, params, pool[0][: RES * RES], pool[1][: RES * RES], grid, mean,
                                 prec=config["compute"])
    return {"train": train, "view_sha256": hashlib.sha256(view.numpy().tobytes()).hexdigest(),
            "view_sum": float(view.double().sum())}


@pytest.mark.parametrize("name", sorted(json.loads(PINNED.read_text())))
def test_reference_outputs_are_pinned(name):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # a parallel CPU reduction sums in another order
    try:
        got = outputs(name)
    finally:
        torch.set_num_threads(threads)
    assert got == json.loads(PINNED.read_text())[name]
