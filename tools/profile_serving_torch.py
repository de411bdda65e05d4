#!/usr/bin/env python3
"""Where the port's serving time goes on one GPU (tinynerf_tpu_torch).

    python3 tools/profile_serving_torch.py [--chunks 20] [--out profile.txt]

Builds the full-width K-Planes renderer (TrainConfig defaults, seeded random
parameters, the shell occupancy), takes the rays of one 800x800 view of the
generated spheres scene, and renders chunks of 2048 rays through the packed
path (cap 2048 x 64) and the dense path.  For each path it reports the
host-clock time per chunk (synchronized), the device time the profiler saw
(sum of kernel times), the device's busy share of the window, and the
kernels that took the most device time, to stdout and, with --out, to a
file.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tinynerf_tpu_torch.train import TrainConfig, build_renderer
from tinynerf_tpu_torch.utils import make_shell_occupancy, make_spheres_pose_set


def _kernel_table(prof, top: int):
    """(total device us, rows of (us, calls, name)) over the events that ran
    on the device (kernels, copies, memsets).  The CPU-side aten ops also
    report their kernels' time as their own and are left out, so nothing
    is counted twice."""
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            rows.append((ev.self_device_time_total, ev.count, ev.key))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), rows[:top]


def profile_path(name, fn, chunks, n_chunks: int, top: int) -> str:
    for o, d in chunks[:3]:  # warm up
        fn(o, d)
    torch.cuda.synchronize()
    work = chunks[:n_chunks]
    t0 = time.perf_counter()
    for o, d in work:
        fn(o, d)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / len(work)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for o, d in work:
            fn(o, d)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    dev_us, rows = _kernel_table(prof, top)
    lines = [
        f"{name}: {wall * 1e3:.3f} ms/chunk host clock ({len(work)} chunks of 2048 rays); "
        f"under the profiler {prof_wall / len(work) * 1e3:.3f} ms/chunk, "
        f"device kernels {dev_us / 1e3 / len(work):.3f} ms/chunk, "
        f"device busy {dev_us / 1e6 / prof_wall:.1%}",
    ]
    for us, calls, key in rows:
        lines.append(f"  {us / 1e3 / len(work):8.3f} ms/chunk {us / dev_us:6.1%} "
                     f"{calls // len(work):4d}x  {key[:110]}")
    text = "\n".join(lines)
    print(text, flush=True)
    return text


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=20)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", type=Path, default=None, help="also write the report here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving_torch: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    cfg = TrainConfig()
    pose_set = make_spheres_pose_set(n_views=1, res=800, seed=0)
    renderer = build_renderer(cfg, pose_set.scene_scale, pose_set.bg_color, device="cuda",
                              generator=torch.Generator().manual_seed(0))
    occ = make_shell_occupancy(renderer.occupancy, device="cuda")
    rays_o = torch.from_numpy(np.asarray(pose_set[0]["rays_o"]).reshape(-1, 3)).cuda()
    rays_d = torch.from_numpy(np.asarray(pose_set[0]["rays_d"]).reshape(-1, 3)).cuda()
    b = cfg.batch_size
    # the view's middle chunks cross the object (the first and last rows miss it)
    mid = rays_o.shape[0] // 2
    chunks = [(rays_o[k : k + b], rays_d[k : k + b])
              for k in range(mid - b * (args.chunks // 2), mid + b * (args.chunks // 2), b)]
    cap = cfg.batch_size * cfg.eval_samples_per_ray
    with torch.inference_mode():
        report = [
            f"card: {card}",
            profile_path("packed", lambda o, d: renderer.render_packed(occ, o, d, cap),
                         chunks, args.chunks, args.top),
            profile_path("dense", lambda o, d: renderer.render_dense(occ, o, d),
                         chunks, max(3, args.chunks // 4), args.top),
        ]
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n\n".join(report) + "\n")
    print(f"card: {card}")


if __name__ == "__main__":
    main()
