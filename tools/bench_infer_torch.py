#!/usr/bin/env python3
"""Serving throughput of the PyTorch/CUDA port (tinynerf_tpu_torch):
rendered rays/s of the packed serving path, on the dense march and on the
skip march, against the dense path; the port's counterpart of
`tools/bench_infer.py`.

    python3 tools/bench_infer_torch.py [--method kplanes] [--chunk 8192]
        [--spr_cap 64] [--scene_type aabb] [--n 10] [--device cpu]

The JAX tool's setup at its full-width defaults: the field of `--method`
with seeded random parameters (`--field_scale` 1.0), 400 samples per ray,
the converged-like shell occupancy at 128^3 (`make_shell_occupancy`),
chunks of 8192 rays whose directions are numpy `default_rng(0)` normals
and whose origins sit at -4 d.  It times `--n` chunks per path after one
warm-up chunk, synchronized with `torch.cuda.synchronize()`, and prints
ms per chunk, rays/s, the share of rays the packed paths render (`ok`; the
rest would fall back to the dense path), the speedup of the faster packed
path over dense, and how many times each of the port's CUDA kernels
launched through its wrapper per path.  On the card a packed path's
timed chunks replay the CUDA graph that its warm-up chunk captured, which
launches through no wrapper: its counts are the warm-up's and the
capture's.  `main(argv)` returns those numbers.  Runs on the card unless
`--device cpu` is given (then the kernels' plain versions run and every
launch count is 0).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def bench_rays(n_chunks: int, chunk: int) -> tuple:
    """The JAX tool's rays: (origins, directions) [n_chunks, chunk, 3] f32."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(n_chunks, chunk, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return -4.0 * d, d


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="kplanes", choices=["vanilla", "kplanes", "cobafa"])
    ap.add_argument("--scene_type", default="aabb", choices=["aabb", "unbounded"])
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--spr_cap", type=int, default=64, help="packed eval capacity in samples per ray")
    ap.add_argument("--n", type=int, default=10, help="timed chunks")
    ap.add_argument("--n_samples", type=int, default=400)
    ap.add_argument("--occupancy_res", type=int, default=128)
    ap.add_argument("--field_scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from tinynerf_tpu_torch.ops import cuda_lib
    from tinynerf_tpu_torch.train import TrainConfig, build_renderer
    from tinynerf_tpu_torch.train.loop import make_render_chunk, make_render_chunk_packed
    from tinynerf_tpu_torch.utils import make_shell_occupancy
    from tinynerf_tpu_torch.utils.device import card_line, resolve_device, synchronize

    device = resolve_device(args.device, "bench_infer_torch")
    card = card_line(device)
    cfg = TrainConfig(method=args.method, scene_type=args.scene_type, batch_size=args.chunk,
                      n_samples=args.n_samples, occupancy_res=args.occupancy_res, field_scale=args.field_scale)
    renderer = build_renderer(cfg, scene_scale=1.0, bg_color=np.ones(3, np.float32), device=device,
                              generator=torch.Generator().manual_seed(0))
    occ_state = make_shell_occupancy(renderer.occupancy, device=device)
    o, d = bench_rays(args.n + 2, args.chunk)
    o_dev, d_dev = torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)
    print(f"{card}: {args.method} {args.scene_type}, chunks of {args.chunk} rays x {args.n_samples} samples, "
          f"packed cap {args.spr_cap}/ray, occupancy {args.occupancy_res}^3 shell", flush=True)

    def bench(name, fn, *extra) -> dict:
        before = cuda_lib.launch_counts()
        with torch.inference_mode():
            fn(occ_state, o_dev[0], d_dev[0], *extra)  # warm-up
            synchronize(device)
            t0 = time.perf_counter()
            outs = [fn(occ_state, o_dev[2 + i], d_dev[2 + i], *extra) for i in range(args.n)]
            synchronize(device)
            dt = (time.perf_counter() - t0) / args.n
        row = {"ms_per_chunk": dt * 1e3, "rays_per_s": args.chunk / dt,
               "launches": cuda_lib.launches_since(before)}
        print(f"{name:40s} {dt * 1e3:8.2f} ms/chunk  {row['rays_per_s'] / 1e3:9.1f}k rays/s", flush=True)
        if isinstance(outs[0], tuple):
            row["ok_share"] = float(torch.stack([out[1] for out in outs]).float().mean())
            print(f"{'':40s} ok: {row['ok_share'] * 100:.1f}% of rays (rest would fall back)", flush=True)
        print(f"{'':40s} launches: {_nonzero(row['launches'])}", flush=True)
        return row

    result = {"card": card, "dense": bench("dense (reference eval semantics)", make_render_chunk(renderer))}
    cap = args.chunk * args.spr_cap
    result["packed_dense"] = bench(f"packed dense-march (cap {args.spr_cap}/ray)",
                                   make_render_chunk_packed(renderer, cap, march="dense"))
    best = result["packed_dense"]["rays_per_s"]
    if renderer.supports_skip_march:
        grid = renderer.skip_grid(occ_state)
        result["packed_skip"] = bench(f"packed skip-march (cap {args.spr_cap}/ray)",
                                      make_render_chunk_packed(renderer, cap, march="skip"), grid)
        best = max(best, result["packed_skip"]["rays_per_s"])
    result["speedup"] = best / result["dense"]["rays_per_s"]
    print(f"\nserving speedup vs dense: {result['speedup']:.2f}x ({card})")
    return result


if __name__ == "__main__":
    main()
