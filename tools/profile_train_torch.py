#!/usr/bin/env python3
"""Where the port's training time goes on one GPU (tinynerf_tpu_torch).

    python3 tools/profile_train_torch.py [--method vanilla|kplanes|cobafa]
        [--scene_type aabb|unbounded] [--march auto|dense|skip] [--steps 10] [--out profile.txt]

Builds the full-width trainer of `--method` (TrainConfig defaults: batch
2048 rays, 400 samples, cap 819,200, bf16 compute; the vanilla field's
posenc(10) into 10 layers of 256, K-Planes planes 129/257/513 x 3 x 32, or
Cobafa basis grids 32..128^3 and coefficients 64^3 x 6 with its 7-layer
field MLP; seeded random parameters) on the AABB or the unbounded marcher
(`--scene_type`: the disparity grid over the views' scene scale and the
Mip-360 contraction) on four generated 800x800 views of the spheres scene,
and profiles train steps in two occupancy states:

  * "early": the all-occupied grid a run starts from (every marched sample
    in the box is kept, so the cap holds ~1-2 buckets of rays);
  * "converged": the thin-shell grid a trained scene converges to (few
    samples per ray, so the bucket grows and the march dominates).

In each state the march is the one `train()`'s `MarchPolicy` picks at the
state's demand under `--march` (default "auto": dense early, the skip march
converged; its grid rebuilt from the state).  For each state it reports the
march, the host-clock time per step (synchronized), the device
time the profiler saw (sum of kernel times), the device's busy share of the
window, the kernels that took the most device time, and the share of the
port's own CUDA kernels (`csrc/*.cu`: the weights, the per-ray sum, the
sorts, the accumulation, the oct and quad builds and both skip march
kernels, by name), to stdout and, with --out, to a file.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch
from torch.profiler import ProfilerActivity, profile

from tinynerf_tpu_torch.data import RayPool
from tinynerf_tpu_torch.train import (
    MarchPolicy, TrainConfig, build_renderer, make_optimizer, make_train_step, pick_bucket,
)
from tinynerf_tpu_torch.utils import make_shell_occupancy, make_spheres_data
from tinynerf_tpu_torch.utils.device import card_line


# the port's hand-written kernels, by the names nvcc gives them in a trace
PORT_KERNELS = ("segscan_kernel", "weights_packed_bwd", "segment_sum_kernel", "weights_dense_kernel",
                "weights_dense_bwd", "radix_", "windowed_", "oct_accumulate", "oct_build", "oct_fold",
                "quad_build", "skip_march_kernel", "skip_march_unbounded")


def _kernel_table(prof):
    """(total device us, rows of (us, calls, name)) over the events that ran
    on the device; the CPU-side aten ops, which report their kernels' time
    as their own, are left out so nothing is counted twice."""
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            rows.append((ev.self_device_time_total, ev.count, ev.key))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), rows


def profile_state(name, step, n_steps: int, top: int, bucket: int, cap: int, march: str) -> str:
    for _ in range(3):  # warm up
        m = step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        m = step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n_steps
    fill = float(m["fill"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    dev_us, rows = _kernel_table(prof)
    lines = [
        f"{name}: {march} march, bucket {bucket} ({bucket * 2048} candidate rays), fill {fill:.3f} of "
        f"cap {cap}, {float(m['complete_frac']):.4f} of rays complete; "
        f"{wall * 1e3:.3f} ms/step host clock ({n_steps} steps); under the profiler "
        f"{prof_wall / n_steps * 1e3:.3f} ms/step, device kernels {dev_us / 1e3 / n_steps:.3f} ms/step, "
        f"device busy {dev_us / 1e6 / prof_wall:.1%}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
    ]
    for us, calls, key in rows[:top]:
        lines.append(f"  {us / 1e3 / n_steps:8.3f} ms/step {us / dev_us:6.1%} "
                     f"{calls // n_steps:4d}x  {key[:110]}")
    for name in PORT_KERNELS:
        mine = [(us, calls) for us, calls, key in rows if name in key]
        if mine:
            us = sum(u for u, _ in mine)
            lines.append(f"  port kernel {name}: {us / 1e3 / n_steps:.3f} ms/step, {us / dev_us:.1%} of "
                         f"device time, {sum(c for _, c in mine) / n_steps:g} launches/step")
    text = "\n".join(lines)
    print(text, flush=True)
    return text


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", choices=("vanilla", "kplanes", "cobafa"), default="kplanes")
    ap.add_argument("--scene_type", choices=("aabb", "unbounded"), default="aabb")
    ap.add_argument("--march", choices=("auto", "dense", "skip"), default="auto")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", type=Path, default=None, help="also write the report here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_torch: needs a CUDA device")
    card = card_line(torch.device("cuda"))
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    cfg = TrainConfig(method=args.method, scene_type=args.scene_type, march=args.march)
    pool = RayPool(make_spheres_data(n_views=4, res=800, seed=1), device="cuda")
    renderer = build_renderer(cfg, pool.scene_scale, pool.bg_color, device="cuda",
                              generator=torch.Generator().manual_seed(0))
    optimizer = make_optimizer(cfg, renderer)
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = [f"card: {card}; method {args.method}, scene type {args.scene_type}, "
              f"{sum(p.numel() for p in renderer.parameters())} parameters"]
    print(report[0])
    for name, occ in (("early", renderer.occupancy.init_state("cuda")),
                      ("converged", make_shell_occupancy(renderer.occupancy, device="cuda"))):
        # the bucket and march train() would settle on: demand measured on
        # one bucket-1 dense step
        probe = make_train_step(renderer, optimizer, cfg, n_cand=cfg.batch_size)
        m = probe(occ, *pool.arrays(), gen)
        demand = max(1.0, float(m["fill"]) * cfg.sample_cap / float(m["rays_used"]))
        bucket = pick_bucket(cfg, demand)
        march = MarchPolicy(renderer.supports_skip_march, cfg.march, renderer.skip_steps).pick(demand)
        grid = (renderer.skip_grid(occ),) if march == "skip" else ()
        step_fn = make_train_step(renderer, optimizer, cfg, n_cand=bucket * cfg.batch_size, march=march)
        torch.cuda.reset_peak_memory_stats()
        report.append(profile_state(
            name, lambda: step_fn(occ, *grid, *pool.arrays(), gen), args.steps, args.top, bucket,
            cfg.sample_cap, march))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n\n".join(report) + "\n")
    print(f"card: {card}")


if __name__ == "__main__":
    main()
