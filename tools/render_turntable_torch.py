#!/usr/bin/env python3
"""Render a turntable orbit from a trained checkpoint with the PyTorch/CUDA
port (tinynerf_tpu_torch): the port's counterpart of
`tools/render_turntable.py`.

    python3 tools/render_turntable_torch.py --ckpt runs/<exp>/ckpt_4096.pkl \\
        --method kplanes --out frames/ [--n_frames 60] [--res 400] [--device cpu]

Reads a checkpoint written by either package (`train/checkpoint.py`),
builds the orbit as the JAX tool does (`look_at_matrix` at `--radius`, the
camera `--elevation` a fraction of it, `CAMERA_ANGLE_X`), serves every
frame packed (the skip march where the renderer supports it, the dense
march otherwise), with the rays it flags re-rendered densely (`infer`),
and writes `frame_XXXX.png`.  It also prints the seconds per frame and the
fallback and incomplete ray counts (`InferStats`).  `main(argv)` returns
those numbers, the orbit's cameras and the float frames.  Runs on the card
unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def orbit_cameras(n_frames: int, radius: float, elevation: float) -> np.ndarray:
    """[n_frames, 4, 4] f32 camera-to-world matrices around the z axis."""
    from tinynerf_tpu_torch.utils.fixtures import look_at_matrix

    cams = []
    for i in range(n_frames):
        theta = 2 * np.pi * i / n_frames
        eye = radius * np.array([np.cos(theta), np.sin(theta), elevation])
        cams.append(look_at_matrix(eye).astype(np.float32))
    return np.stack(cams)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, required=True)
    ap.add_argument("--method", type=str, required=True, choices=["vanilla", "kplanes", "cobafa"])
    ap.add_argument("--scene_type", default="aabb", choices=["aabb", "unbounded"])
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--n_frames", type=int, default=60)
    ap.add_argument("--res", type=int, default=400)
    ap.add_argument("--radius", type=float, default=4.0)
    ap.add_argument("--elevation", type=float, default=0.5, help="camera height as a fraction of radius")
    ap.add_argument("--n_samples", type=int, default=400)
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--field_scale", type=float, default=1.0, help="the field_scale the checkpoint was trained at")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from tinynerf_tpu_torch.convert import load_params, occ_state_to_torch
    from tinynerf_tpu_torch.data import Intrinsics, NerfData, PoseSet
    from tinynerf_tpu_torch.train import TrainConfig, build_renderer, load_checkpoint
    from tinynerf_tpu_torch.train.loop import InferStats, infer, make_render_chunk_packed
    from tinynerf_tpu_torch.utils.device import card_line, resolve_device
    from tinynerf_tpu_torch.utils.fixtures import CAMERA_ANGLE_X

    device = resolve_device(args.device, "render_turntable_torch")
    card = card_line(device)
    step, state = load_checkpoint(Path(args.ckpt))
    cfg = TrainConfig(
        method=args.method, scene_type=args.scene_type, n_samples=args.n_samples,
        occupancy_res=int(np.asarray(state["occ_state"].grid).shape[0]), field_scale=args.field_scale,
    )
    renderer = build_renderer(cfg, scene_scale=1.0, bg_color=np.ones(3, np.float32), device=device)
    load_params(renderer, state["params"])
    occ_state = occ_state_to_torch(state["occ_state"], device)

    focal = args.res / (2.0 * np.tan(0.5 * CAMERA_ANGLE_X))
    K = Intrinsics(focal, focal, args.res / 2.0, args.res / 2.0, args.res, args.res)
    cameras = orbit_cameras(args.n_frames, args.radius, args.elevation)
    poses = PoseSet(NerfData(cameras=cameras, intrinsics=K))

    # packed serving (+ skip marching where supported); the rays it flags
    # fall back to the dense path inside infer()
    can_skip = renderer.supports_skip_march
    packed_fn = make_render_chunk_packed(
        renderer, args.chunk * cfg.eval_samples_per_ray, march="skip" if can_skip else "dense")
    grid_args = (renderer.skip_grid(occ_state),) if can_skip else ()
    stats = InferStats()
    out = Path(args.out)
    infer(renderer, occ_state, poses, list(range(args.n_frames)), out, "frame", chunk=args.chunk,
          packed_fn=packed_fn, grid_args=grid_args, stats=stats)
    rays = sum(stats.rays)
    result = {
        "card": card,
        "step": step,
        "frames": args.n_frames,
        "march": "skip" if can_skip else "dense",
        "seconds_per_frame": float(np.mean(stats.seconds)),
        "seconds": list(stats.seconds),
        "rays": rays,
        "fallback_rays": stats.fallback_rays,
        "incomplete_rays": stats.incomplete_rays,
        "fallback_share": stats.fallback_rays / max(rays, 1),
        "cameras": cameras,
        "images": stats.images,
    }
    print(f"{args.n_frames} frames written to {out} (checkpoint step {step})")
    print(f"{card}: {result['seconds_per_frame']:.4f} s/frame over {args.n_frames} frames of {args.res}x{args.res} "
          f"({result['march']} march, {cfg.eval_samples_per_ray} packed samples per ray, "
          f"{renderer.skip_steps} skip rounds); fallback {stats.fallback_rays} of {rays} rays "
          f"({result['fallback_share']:.4%}), incomplete {stats.incomplete_rays}")
    return result


if __name__ == "__main__":
    main()
