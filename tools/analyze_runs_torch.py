#!/usr/bin/env python3
"""Same-cell RUN LENGTHS in the packed sample stream (tinynerf_tpu_torch):
the port's counterpart of `tools/analyze_runs.py`.

    python3 tools/analyze_runs_torch.py [--n_rays 4096] [--device cpu]

Consecutive samples of a ray that land in the same cell of a projected
plane (or of a voxel grid) could share one table-gather row and one
scatter row; merging such runs would cut the rows both pay for by at most
1 - runs / samples.  This replays the port's own march and compaction at
the benchmark's geometry (the JAX tool's: K-Planes, AABB, batch 2048, 400
samples, the 128^3 shell occupancy of `make_shell_occupancy`, `--n_rays`
rays from the sphere of radius 4 towards the origin, numpy
`default_rng(0)`): `NerfRenderer._march` with the train-time jitter (the
port's hash, keyed by the words of the JAX tool's `PRNGKey(0)`: the JAX
tool's jax.random draws cannot be repeated, so the totals differ from its
own by the jitter), then the valid samples in the packed ray-major order
of `core/renderer.py: compact`.  It counts, exactly: the runs per plane at
resolutions 129, 257 and 513 (`count_runs`, the align_corners cell of
each projection), and per voxel at 64 and 128, and prints the JAX tool's
table.  `main(argv)` returns the counts.  Runs on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

# the raw key data of the JAX tool's jax.random.PRNGKey(0), as the jitter's seed words
JITTER_WORDS = (0, 0)
PLANE_RES = (129, 257, 513)
VOXEL_RES = (64, 128)
PROJECTIONS = (((0, 1), "xy"), ((0, 2), "xz"), ((1, 2), "yz"))


def _runs(cell: np.ndarray, ray_id: np.ndarray) -> int:
    """Runs of equal cells within a ray, in stream order."""
    same = (cell[1:] == cell[:-1]) & (ray_id[1:] == ray_id[:-1])
    return int(cell.size - same.sum())


def count_runs(pts: np.ndarray, ray_id: np.ndarray) -> list:
    """Rows {kind, name, res, runs, samples} for the packed points `pts` [n,
    3] in [-1, 1] and their rays: each plane projection at PLANE_RES (the
    floor of the align_corners index), then voxels at VOXEL_RES."""
    n = int(pts.shape[0])
    rows = []
    for res in PLANE_RES:
        for axes, name in PROJECTIONS:
            ij = np.clip((pts[:, axes] + 1.0) * 0.5 * (res - 1), 0, res - 1)
            cell = np.floor(ij[:, 0]).astype(np.int64) * res + np.floor(ij[:, 1]).astype(np.int64)
            rows.append(dict(kind="plane", name=name, res=res, runs=_runs(cell, ray_id), samples=n))
    for res in VOXEL_RES:
        c = np.floor(np.clip((pts + 1.0) * 0.5 * (res - 1), 0, res - 1)).astype(np.int64)
        cell = (c[:, 0] * res + c[:, 1]) * res + c[:, 2]
        rows.append(dict(kind="voxel", name="vox", res=res, runs=_runs(cell, ray_id), samples=n))
    return rows


def packed_points(renderer, occ_state, rays_o, rays_d, jitter_words=JITTER_WORDS):
    """The march's valid samples in packed order: (points [n, 3] in [-1, 1],
    the ray of each), as `render_packed` lays them out with a cap that
    holds them all."""
    import torch

    from tinynerf_tpu_torch.core.renderer import compact

    words = torch.tensor(jitter_words, dtype=torch.int64, device=rays_o.device)
    with torch.no_grad():
        cpos, _, maskf = renderer._march(rays_o, rays_d, occ_state, words)
        maskb = maskf > 0.0
        is_pad, safe_idx, seg_ids = compact(maskb, maskb.numel())
        keep = ~is_pad
        pts = cpos.reshape(-1, 3)[safe_idx[keep]]
        return pts.cpu().numpy(), seg_ids[keep].cpu().numpy()


def print_table(rows: list) -> None:
    print(f"\n{'proj':>5} {'res':>5} {'runs/samples':>14} {'E[runlen]':>10} {'row reduction':>14}")
    for r in rows:
        if r["kind"] == "voxel" and r["res"] == VOXEL_RES[0]:
            print()
        label = f"{r['name']:>5} {r['res']:>5}" if r["kind"] == "plane" else f"  vox {r['res']:>4}"
        print(f"{label} {r['runs']:>7}/{r['samples']:<7} {r['samples'] / r['runs']:>9.2f} "
              f"{1 - r['runs'] / r['samples']:>13.1%}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_rays", type=int, default=4096)
    ap.add_argument("--field_scale", type=float, default=1.0, help="the field's size (the march ignores it)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from tinynerf_tpu_torch.train import TrainConfig, build_renderer
    from tinynerf_tpu_torch.utils import make_shell_occupancy
    from tinynerf_tpu_torch.utils.device import card_line, resolve_device

    device = resolve_device(args.device, "analyze_runs_torch")
    card = card_line(device)
    cfg = TrainConfig(method="kplanes", scene_type="aabb", batch_size=2048, n_samples=400, occupancy_res=128,
                      field_scale=args.field_scale)
    renderer = build_renderer(cfg, scene_scale=1.0, bg_color=np.ones(3, np.float32), device=device)
    occ_state = make_shell_occupancy(renderer.occupancy, device=device)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(args.n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = -4.0 * d
    pts, ray_id = packed_points(renderer, occ_state, torch.from_numpy(o).to(device), torch.from_numpy(d).to(device))
    n_samp = int(pts.shape[0])
    spr = np.bincount(ray_id, minlength=args.n_rays)
    print(f"{card}: rays={args.n_rays} surviving samples={n_samp} "
          f"(mean {n_samp / args.n_rays:.1f}/ray, max {spr.max()})")
    rows = count_runs(pts, ray_id)
    print_table(rows)
    return {"card": card, "rays": args.n_rays, "samples": n_samp, "max_per_ray": int(spr.max()), "rows": rows}


if __name__ == "__main__":
    main()
