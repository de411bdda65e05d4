#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, at the cell's
own size on the card, one JSON line per seed:

    python3 nerfbench/calibrate.py --workload <name> --seeds 1,2,3 [--out FILE]

Per seed, against the float32 reference: the program as the configuration
states it (the lower reading); the control one precision below bfloat16
(the field file's `CONTROL`: the program with those field options, its
float8 gathers, where the field has that path; else, `CONTROL` None, the
reference with float8_e4m3fn tables and products); and, for a training
cell, the planted fault of half the batch left out (the reference, its mean
over the other half).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from nerfbench import cells, check, harness, scene  # noqa: E402
from nerfbench.reference import nerf as reference  # noqa: E402

REFERENCE_CONTROL = "reference, float8_e4m3fn tables and products"


def program_train(config, traffic, seed, device, pool, field_kw=None) -> dict:
    params0 = scene.make_params(config, seed, device)
    loop = cells.TrainLoop(config, traffic, seed, device, pool, params0, field_kw)
    out = cells.checked_steps(loop, params0)
    del loop, params0
    harness.free_device()
    return out


def train_seed(config, traffic, seed, device) -> dict:
    world = reference.scene_of(config)
    pool = world.training_pool(seed, traffic, device)
    grid, mean = world.occupancy_grid(traffic["occupancy"], config["train"]["occupancy_res"], device)
    t0 = time.perf_counter()
    prog = program_train(config, traffic, seed, device, pool)
    t1 = time.perf_counter()
    params = scene.make_params(config, seed, device)
    ref = reference.train_steps(config, params, pool, grid, mean, prog["steps"], prec=config["compute"])
    t2 = time.perf_counter()
    control_kw = reference.field_of(config).CONTROL
    if control_kw is not None:
        control = program_train(config, traffic, seed, device, pool, control_kw)
        control_kind = f"program, {control_kw}"
    else:
        control = reference.train_steps(config, params, pool, grid, mean, prog["steps"], prec="fp8")
        control_kind = REFERENCE_CONTROL
    half = reference.train_steps(config, params, pool, grid, mean, prog["steps"], prec=config["compute"],
                                 half_batch=True)
    return {"seed": seed, "program": check.train_numbers(prog, ref), "control": check.train_numbers(control, ref),
            "control_kind": control_kind, "half_batch": check.train_numbers(half, ref),
            "program_s": t1 - t0, "reference_s": t2 - t1, "loss": prog["loss"], "ref_loss": ref["loss"],
            "control_loss": control["loss"], "samples": prog["samples"], "rays_used": prog["rays_used"],
            "leaves": {k: [prog["grad_norm"][k], control["grad_norm"][k], ref["grad_norm"][k],
                           prog["update_norm"][k], control["update_norm"][k], ref["update_norm"][k]]
                       for k in ref["grad_norm"]}}


def serve_images(config, traffic, seed, device, views, picks, field_kw=None):
    from tinynerf_tpu_torch.train import InferStats

    loop = cells.ServeLoop(config, traffic, device, views, scene.make_params(config, seed, device), field_kw)
    stats = InferStats()
    for v in picks:
        loop.next_view = v
        loop.view(stats)
    out = list(stats.images), stats.fallback_rays / sum(stats.rays)
    del loop
    harness.free_device()
    return out


def serve_seed(config, traffic, seed, device) -> dict:
    world = reference.scene_of(config)
    rays_o, rays_d = world.served_rays(traffic, device)
    views = cells.HostViews(rays_o, rays_d)
    picks = list(range(traffic["check_views"]))
    t0 = time.perf_counter()
    images, fallback = serve_images(config, traffic, seed, device, views, picks)
    t1 = time.perf_counter()
    params = scene.make_params(config, seed, device)
    grid, mean = world.occupancy_grid(traffic["occupancy"], config["train"]["occupancy_res"], device)
    refs = [reference.render_view(config, params, torch.from_numpy(rays_o[v].reshape(-1, 3)).to(device),
                                  torch.from_numpy(rays_d[v].reshape(-1, 3)).to(device), grid, mean,
                                  prec=config["compute"]).cpu().numpy().reshape(rays_o[v].shape) for v in picks]
    t2 = time.perf_counter()
    control_kw = reference.field_of(config).CONTROL
    if control_kw is not None:
        control, _ = serve_images(config, traffic, seed, device, views, picks, control_kw)
        control_kind = f"program, {control_kw}"
    else:
        control = [reference.render_view(config, params, torch.from_numpy(rays_o[v].reshape(-1, 3)).to(device),
                                         torch.from_numpy(rays_d[v].reshape(-1, 3)).to(device), grid, mean,
                                         prec="fp8").cpu().numpy().reshape(rays_o[v].shape) for v in picks]
        control_kind = REFERENCE_CONTROL
    return {"seed": seed, "program": check.serve_numbers(images, refs), "control": check.serve_numbers(control, refs),
            "control_kind": control_kind, "program_s": t1 - t0, "reference_s": t2 - t1, "fallback_share": fallback,
            "mean_pixel": float(np.mean(refs))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = harness.load_benchmark()
    cell = harness.entry(bench["workloads"], args.workload)
    config = harness.load_config(bench, cell["config"])
    traffic = harness.load_traffic(cell["traffic"])
    fn = train_seed if traffic["kind"] == "train" else serve_seed
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = {"workload": args.workload, **fn(config, traffic, seed, device)}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
        harness.free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
