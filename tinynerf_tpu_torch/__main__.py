"""Command line: `python -m tinynerf_tpu_torch`, with `train.py`'s flags.

Without `--render_only` it trains on `--device` (any `--method`, on
Blender-synthetic or nerfstudio data, AABB or unbounded scenes) in a new
experiment directory under `--output`, or, with `--resume`, continues the
experiment `--output` names.  With `--render_only` it renders the test
split from the latest checkpoint in `--output` (an experiment directory,
written by either package) and reports metrics.

Under `torchrun` it runs over the data-parallel group torchrun describes,
one process per device (`parallel.make_group`: NCCL over cuda:LOCAL_RANK,
gloo with `--device cpu`):

    torchrun --standalone --nproc_per_node N -m tinynerf_tpu_torch ... [--shard_tables [--shard_bwd]]

Rank 0 names the experiment directory and writes every file.
`--shard_tables` keeps the tables' Adam moments sharded over the ranks
(ZeRO-1) and `--shard_bwd` also splits the K-Planes backward's pullback; on
one rank both change nothing.  Without torchrun it is the one-device CLI.
"""

from __future__ import annotations

import argparse
import os
import uuid
from pathlib import Path

from .data import PoseSet, RayPool, parse_nerf_synthetic, parse_nerfstudio
from .parallel import make_group
from .train import TrainConfig, render_only, train


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="tinynerf_tpu_torch", description="Train or render a radiance field on a GPU"
    )
    parser.add_argument("--data", type=str, required=True, help="path to the data folder")
    parser.add_argument("--datatype", type=str, required=True, choices=["synthetic", "nerfstudio"])
    parser.add_argument("--output", type=str, required=True, help="output folder")
    parser.add_argument("--scene_type", type=str, default="aabb", choices=["aabb", "unbounded"])
    parser.add_argument("--method", type=str, required=True, choices=["vanilla", "kplanes", "cobafa", "instantngp"])
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
                        help="torch device to run on (cuda, or cpu for the "
                             "kernels' plain versions)")
    args = parser.parse_args(argv)

    group = make_group(args.device)
    data_path = Path(args.data)
    parse = parse_nerf_synthetic if args.datatype == "synthetic" else parse_nerfstudio
    test_set = PoseSet(parse(data_path, "test"))
    output = Path(args.output)
    if args.resume or args.render_only:
        experiment_dir = output  # an existing experiment directory
    else:
        name = None
        if group.rank == 0:
            while True:
                name = f"{str(uuid.uuid4())[:8]}_{args.method}_{args.scene_type}_{args.n_samples}"
                if not (output / name).is_dir():
                    break
            (output / name).mkdir(parents=True)
        experiment_dir = output / group.broadcast_object(name)
    if group.rank == 0:
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
    if args.render_only:
        render_only(cfg, test_set, device=args.device, group=group)
        return
    # --eval without an explicit cadence evaluates 8 times over the run
    if args.eval and cfg.eval_every is None:
        cfg.eval_every = max(1, cfg.total_steps // 8)
    # over a group each rank moves only its shard of the pool to its device
    train(
        cfg, RayPool(parse(data_path, "train"), device="cpu" if group.grouped else args.device),
        PoseSet(parse(data_path, "val")), test_set,
        resume=args.resume, device=args.device, group=group,
    )


if __name__ == "__main__":
    main()
