#!/usr/bin/env python3
"""Data-parallel K-Planes over N GPUs (tinynerf_tpu_torch), one process per
card, under torchrun:

    python3 -m torch.distributed.run --standalone --nproc_per_node N \
        tools/dp_scaling_torch.py [--steps 32] [--out build/dp_scaling]

Every rank builds `chip_smoke.py` phase 11's world on its card (full-width
K-Planes from seeded parameters, four generated 800x800 views, a 2048-ray
global batch drawn over them).  Over N > 1 ranks (NCCL), rank 0 takes the
ungrouped deterministic step (f32 compute) and every rank the grouped step
replicated, with shard_tables and with shard_tables + shard_bwd, each held
against it as phase 11 holds its steps (`chip_smoke._dp_compare`).  Then
`train()` runs `--steps` steps replicated and with shard_tables (bf16, the
TrainConfig defaults, the occupancy sweep at step 0 included): ms/step on
the host clock (synchronized), rays/s per chip through the loss and peak
device memory per rank.  With N = 1 there is no group and `train()` is the
one-card run, the baseline.  Each rank prints one JSON line (and writes it
to --out/N{N}_rank{r}.json); a rank whose steps disagree exits non-zero.
Needs CUDA devices.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch

import chip_smoke
from tinynerf_tpu_torch.parallel import make_group
from tinynerf_tpu_torch.train import TrainConfig, lr_schedule, train
from tinynerf_tpu_torch.utils.device import card_line


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--out", type=str, default="build/dp_scaling")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dp_scaling_torch: needs CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    group = make_group()  # NCCL over cuda:LOCAL_RANK; without a group, one card
    rec = {"world": group.world, "rank": group.rank, "device": torch.cuda.get_device_name(group.device),
           "card": card_line(group.device), "steps": {}, "train": {}}
    with tempfile.TemporaryDirectory() as tmp:
        cfg, pool, batch, renderer = chip_smoke._dp_world(tmp)
        if group.grouped:
            start = [p.detach().clone() for p in renderer.parameters()]
            ref = chip_smoke._dp_step(renderer, cfg, batch, start) if group.rank == 0 else None
            lr = float(lr_schedule(cfg)(0))
            for name, kw in chip_smoke.DP_VARIANTS.items():
                ours = chip_smoke._dp_step(renderer, dataclasses.replace(cfg, **kw), batch, start, group)
                rec["steps"][name] = dict(ms=ours["ms"])
                if ref is not None:
                    rec["steps"][name].update(chip_smoke._dp_compare(ours, ref, lr, cfg.adam_eps))
                del ours
            del ref, start
        del renderer
        for name, kw in (("replicated", {}), ("shard_tables", dict(shard_tables=True))):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tcfg = TrainConfig(method="kplanes", output=f"{tmp}/{name}", steps=args.steps, seed=0, **kw)
            out = train(tcfg, pool, device=group.device, group=group if group.grouped else None)
            torch.cuda.synchronize()
            losses = [m.loss for m in out["train_metrics"]]
            rec["train"][name] = dict(ms_per_step=out["elapsed_s"] / args.steps * 1e3,
                                      rays_per_sec_per_chip=out["rays_per_sec_per_chip"],
                                      peak_gb=torch.cuda.max_memory_allocated(group.device) / 1e9,
                                      loss_first=losses[0], loss_last=losses[-1])
            del out
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"N{group.world}_rank{group.rank}.json").write_text(json.dumps(rec))
    print(json.dumps(rec), flush=True)
    bad = [k for k, v in rec["steps"].items()
           if "loss_rel" in v and not (v["loss_rel"] <= chip_smoke.DP_LOSS_RTOL and v["grads_over"] == 0
                                       and v["params_over"] == 0)]
    group.barrier()
    if bad:
        raise SystemExit(f"dp_scaling_torch: the grouped steps {bad} disagree with the ungrouped step")


if __name__ == "__main__":
    main()
