#!/usr/bin/env python3
"""Quality run of the PyTorch/CUDA port (tinynerf_tpu_torch): train on a
generated analytic scene and report test PSNR; the port's counterpart of
`tools/quality_run.py`, with its flags, defaults, scene and output lines,
so that logs of the two compare.

    python3 tools/quality_run_torch.py [--method kplanes] [--steps 300]
        [--gather-dtype bfloat16|float8|float32] [--init-range 0,1]
        [--bwd-mode auto|sorted|scatter] [--eval-every 256] [--device cpu]

It writes the scene (`--scene spheres|blob`, `--n_train` views at `--res`,
two test views), maps the flags to the `TrainConfig` the JAX tool builds,
trains with `train()` and prints the JAX tool's `RESULT`, `TIME-TO-*dB`
and `TIMELINE` lines, and one more: `MARCH`, how many of the steps took the
skip march and the first that did.  The field options reach the field as
the JAX tool passes them, through a wrapper of the `make_model` that
`train/loop.py` calls (restored on return): `--gather-dtype` and
`--init-range` for K-Planes and Cobafa (Cobafa gathers f32 for anything but
bfloat16), `--bwd-mode` as the K-Planes field's `bwd_impl` ("sorted" is the
f32 table-gradient payload; "scatter" runs on CPU tensors only, so the port
refuses it on a card).  The JAX tool's `--lookup` (but its default, fused)
and `--fwd-mode fusedfine` pick TPU layouts of the same values, which the
port leaves out (ROADMAP.md Queue 1 item 4), so they are not offered.
`--matmul-precision` (highest, high or medium; not the JAX tool's) sets
`torch.set_float32_matmul_precision` for the run and restores it after:
"medium" lets f32 matmuls take bf16 passes, as a TPU's f32 matmuls do by
default.  `--output` keeps the experiment (checkpoint, renders, metrics) in a
directory of the caller's; by default a new temporary one.  `main(argv)`
returns the numbers it prints.  Runs on the card unless `--device cpu` is
given.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

# the fields that take the JAX tool's field options (the vanilla field none)
FIELD_OPTIONS = {"kplanes": ("gather_dtype", "init_range"), "cobafa": ("gather_dtype", "init_range")}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="kplanes")
    ap.add_argument("--scene_type", default="aabb", choices=["aabb", "unbounded"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--n_samples", type=int, default=128)
    ap.add_argument("--bwd-mode", default=None, choices=[None, "auto", "scatter", "sorted"],
                    help="kplanes table-gradient accumulation")
    ap.add_argument("--eval-every", type=int, default=None, help="eval cadence for the time-to-PSNR timeline")
    ap.add_argument("--eval-n", type=int, default=2)
    ap.add_argument("--gather-dtype", default=None, choices=[None, "bfloat16", "float32", "float8"])
    ap.add_argument("--res", type=int, default=100)
    ap.add_argument("--n_train", type=int, default=12)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--scene", default="spheres", choices=["blob", "spheres"])
    ap.add_argument("--occ_threshold", type=float, default=0.01, help="0 disables occupancy culling")
    ap.add_argument("--lr", type=float, default=None, help="None = method-dependent default")
    ap.add_argument("--lr-tables", type=float, default=None,
                    help="split lr for feature tables (None = same as --lr)")
    ap.add_argument("--tv", type=float, default=1e-4)
    ap.add_argument("--init-range", default=None, help="plane / grid init, e.g. '0,1' or '0.5,1.5'")
    ap.add_argument("--occ-interp", default=None, choices=[None, "nearest", "trilinear"],
                    help="occupancy query interp (reference: trilinear)")
    ap.add_argument("--decay-tables", action="store_true", help="weight-decay feature tables too")
    ap.add_argument("--no-fwd-clamp", action="store_true", help="unclamped truncated_exp forward")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--max-bucket", type=int, default=None, help="cap the bucket ladder")
    ap.add_argument("--march", default="auto", choices=["auto", "dense", "skip"])
    ap.add_argument("--field_scale", type=float, default=1.0)
    ap.add_argument("--output", type=Path, default=None, help="experiment directory (default: a new temp dir)")
    ap.add_argument("--matmul-precision", dest="matmul_precision", default=None,
                    choices=[None, "highest", "high", "medium"], help="torch's f32 matmul precision for the run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def make_config(args: argparse.Namespace, output: Path):
    """The `TrainConfig` of `tools/quality_run.py` for the same flags (and
    the port's `field_scale`)."""
    from tinynerf_tpu_torch.train import TrainConfig

    cfg = TrainConfig(
        method=args.method,
        scene_type=args.scene_type,
        output=output,
        batch_size=args.batch_size,
        n_samples=args.n_samples,
        steps=args.steps,
        occupancy_res=64,
        occupancy_threshold=args.occ_threshold,
        occupancy_interp=args.occ_interp or "nearest",
        decay_tables=args.decay_tables,
        lr_init=args.lr,
        lr_tables=args.lr_tables,
        tv_reg_alpha=args.tv,
        seed=args.seed,
        compute_dtype=args.dtype,
        eval_every=args.eval_every,
        eval_n=args.eval_n if args.eval_every else None,
        march=args.march,
        max_bucket=args.max_bucket,
        field_scale=args.field_scale,
    )
    if args.no_fwd_clamp:
        cfg.fwd_clamp = False
    return cfg


def main(argv=None) -> dict:
    args = parse_args(argv)

    import tinynerf_tpu_torch.train.loop as loop_mod
    from tinynerf_tpu_torch.data import PoseSet, RayPool, parse_nerf_synthetic
    from tinynerf_tpu_torch.train import train
    from tinynerf_tpu_torch.utils import make_synthetic_scene
    from tinynerf_tpu_torch.utils.device import card_line, resolve_device

    device = resolve_device(args.device, "quality_run_torch")
    card = card_line(device)
    root = Path(args.output) if args.output is not None else Path(tempfile.mkdtemp())
    scene = make_synthetic_scene(root / args.scene, n_train=args.n_train, n_test=2, res=args.res,
                                 kind=args.scene)
    cfg = make_config(args, root / "exp")

    field_kw = {}
    if args.gather_dtype:
        field_kw["gather_dtype"] = args.gather_dtype
    if args.init_range:
        lo, hi = (float(v) for v in args.init_range.split(","))
        field_kw["init_range"] = (lo, hi)
    orig = loop_mod.make_model

    def make_model(method, **mk_kw):
        kw = {k: v for k, v in field_kw.items() if k in FIELD_OPTIONS.get(method, ())}
        field, sd, rd = orig(method, **mk_kw, **kw)
        if args.bwd_mode and hasattr(field, "bwd_impl"):
            field.bwd_impl = args.bwd_mode
        return field, sd, rd

    print(f"scene={scene} output={cfg.output} device={device} ({card})")
    train_rays = RayPool(parse_nerf_synthetic(scene, "train"))
    test_set = PoseSet(parse_nerf_synthetic(scene, "test"))
    import torch

    precision = torch.get_float32_matmul_precision()
    loop_mod.make_model = make_model
    try:
        if args.matmul_precision:
            torch.set_float32_matmul_precision(args.matmul_precision)
        out = train(cfg, train_rays, test_set=test_set, eval_set=test_set if args.eval_every else None,
                    device=device)
    finally:
        loop_mod.make_model = orig
        torch.set_float32_matmul_precision(precision)

    psnrs = [m.psnr for m in out["test_metrics"]]
    ssims = [m.ssim for m in out["test_metrics"]]
    first_loss = out["train_metrics"][0].loss
    last_loss = out["train_metrics"][-1].loss
    dev = []
    if args.init_range:
        dev.append(f"init={args.init_range}")
    if args.occ_interp:
        dev.append(f"occ={args.occ_interp}")
    if args.decay_tables:
        dev.append("decay_tables")
    if args.no_fwd_clamp:
        dev.append("no_fwd_clamp")
    if args.lr is not None:
        dev.append(f"lr={args.lr}")
    if args.lr_tables is not None:
        dev.append(f"lr_tables={args.lr_tables}")
    if args.matmul_precision:
        dev.append(f"matmul={args.matmul_precision}")
    print(
        f"RESULT scene={args.scene} method={args.method} lookup=default "
        f"gather={args.gather_dtype or 'default'} dtype={args.dtype} steps={args.steps} "
        f"deviations=[{','.join(dev) or 'none'}] "
        f"loss {first_loss:.4f}->{last_loss:.5f} "
        f"test PSNR {np.mean(psnrs):.2f} dB  SSIM {np.mean(ssims):.3f} "
        f"rays/s/chip {out['rays_per_sec_per_chip']:.0f}"
    )
    timeline = out.get("eval_timeline") or []
    time_to = {}
    for thr in (28.0, 30.0, 32.0):
        hit = next((e for e in timeline if e["psnr"] >= thr), None)
        if hit:
            time_to[thr] = hit
            print(f"TIME-TO-{thr:.0f}dB: {hit['elapsed_s']:.1f} s (step {hit['step']}, psnr {hit['psnr']:.2f})")
    if timeline:
        print("TIMELINE " + " ".join(f"{e['step']}:{e['elapsed_s']:.0f}s:{e['psnr']:.2f}" for e in timeline))
    marches = out["march_steps"]
    print(f"MARCH skip {marches['skip']} of {marches['skip'] + marches['dense']} steps "
          f"(first skip step: {out['first_skip_step']})")
    losses = [m.loss for m in out["train_metrics"]]
    return {
        "card": card, "config": cfg, "output": cfg.output, "scene": scene,
        "first_loss": first_loss, "last_loss": last_loss, "losses": losses,
        "psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
        "rays_per_sec_per_chip": out["rays_per_sec_per_chip"], "elapsed_s": out["elapsed_s"],
        "timeline": timeline, "time_to": time_to,
        "march_steps": marches, "first_skip_step": out["first_skip_step"],
        "gather_dtype": getattr(out["renderer"].field, "gather_dtype", None),
        "bwd_impl": getattr(out["renderer"].field, "bwd_impl", None),
        "matmul_precision": args.matmul_precision or precision,
    }


if __name__ == "__main__":
    main()
