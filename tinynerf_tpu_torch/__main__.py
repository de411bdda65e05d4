"""Command line: `python -m tinynerf_tpu_torch`, with `train.py`'s flags.

`--render_only` renders the test split from the latest checkpoint in
`--output` (an experiment directory, written by either package) on
`--device` and reports metrics.  Training, nerfstudio data and the other
methods raise NotImplementedError naming the ROADMAP.md item.  Mesh and
sharding flags are accepted for compatibility and have no effect.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

from .data import PoseSet, parse_nerf_synthetic
from .train import TrainConfig, render_only
from .train.loop import TRAINING_NOT_PORTED


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="tinynerf_tpu_torch", description="Render a radiance field on a GPU"
    )
    parser.add_argument("--data", type=str, required=True, help="path to the data folder")
    parser.add_argument("--datatype", type=str, required=True, choices=["synthetic", "nerfstudio"])
    parser.add_argument("--output", type=str, required=True, help="output folder")
    parser.add_argument("--scene_type", type=str, default="aabb", choices=["aabb", "unbounded"])
    parser.add_argument("--method", type=str, required=True, choices=["vanilla", "kplanes", "cobafa"])
    parser.add_argument("--batch_size", type=int, default=2048)
    parser.add_argument("--n_samples", type=int, default=400, help="samples per ray")
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--eval_every", type=int, default=None)
    parser.add_argument("--eval_n", type=int, default=1)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--render_only", action="store_true",
                        help="render the test split from the latest checkpoint "
                             "in --output (an experiment dir) and report metrics")
    parser.add_argument("--checkpoint_every", type=int, default=0)
    parser.add_argument("--profile_start", type=int, default=None)
    parser.add_argument("--profile_count", type=int, default=5)
    parser.add_argument("--march", type=str, default="auto", choices=["auto", "dense", "skip"])
    parser.add_argument("--max_bucket", type=int, default=None)
    parser.add_argument("--eval_render", type=str, default="packed", choices=["packed", "dense"])
    parser.add_argument("--remat", type=str, default="auto", choices=["auto", "on", "off"])
    parser.add_argument("--shard_tables", action="store_true")
    parser.add_argument("--shard_bwd", action="store_true")
    parser.add_argument("--field_scale", type=float, default=1.0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on (cuda, or cpu for the "
                             "kernels' plain versions)")
    args = parser.parse_args(argv)

    if not args.render_only:
        raise NotImplementedError(TRAINING_NOT_PORTED)
    if args.datatype != "synthetic":
        raise NotImplementedError(
            "nerfstudio data is not ported yet (ROADMAP.md Queue 1, "
            "'Unbounded scenes and nerfstudio')"
        )
    test_set = PoseSet(parse_nerf_synthetic(Path(args.data), "test"))
    experiment_dir = Path(args.output)
    print(f"Experiment saved to {experiment_dir}")
    cfg = TrainConfig(
        method=args.method,
        scene_type=args.scene_type,
        output=experiment_dir,
        batch_size=args.batch_size,
        n_samples=args.n_samples,
        eval_every=args.eval_every,
        eval_n=args.eval_n,
        steps=args.steps,
        seed=int(os.environ.get("SEED", 0)),
        compute_dtype=args.dtype,
        checkpoint_every=args.checkpoint_every,
        profile_start=args.profile_start,
        profile_count=args.profile_count,
        march=args.march,
        eval_render=args.eval_render,
        max_bucket=args.max_bucket,
        remat_field=None if args.remat == "auto" else (args.remat == "on"),
        shard_tables=args.shard_tables,
        shard_bwd=args.shard_bwd,
        field_scale=args.field_scale,
    )
    render_only(cfg, test_set, device=args.device)


if __name__ == "__main__":
    main()
