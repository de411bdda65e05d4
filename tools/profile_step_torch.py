#!/usr/bin/env python3
"""Stage-by-stage timing of the port's train step at steady state
(tinynerf_tpu_torch): the port's counterpart of `tools/profile_step.py`.

    python3 tools/profile_step_torch.py [--bucket 16] [--method kplanes]
        [--march dense|skip] [--n 10] [--device cpu]

Times each stage of the packed render path alone, synchronized
(`torch.cuda.synchronize()`), at a candidate-ray bucket (`--bucket` x 2048
rays x 400 samples; at 16: 32,768 rays, 13,107,200 candidates, a cap of
819,200), behind the converged-like shell occupancy at 128^3
(`make_shell_occupancy`), with seeded random parameters and the JAX tool's
rays (numpy `default_rng(0)` directions, origins at -4 d), in the JAX
tool's order: march + contract; the occupancy query, with the valid
fraction; the compaction (`core/renderer.py:compact`, what
`render_packed` runs: a cumsum of ranks and one scatter, where the JAX
package takes `top_k`) and the position gather; the field forward and
forward + backward on the cap's samples; the sigma and rgb decoder
forwards, and both decoders' forward + backward; the packed weights
(kernel 1); the optimizer update (`FusedAdam`, on zero gradients); the
K-Planes TV gradient; `render_packed` forward and forward + backward.  With
`--march skip` first: the skip grid's build, the skip march alone (with
the samples it emitted and the share of rays it completed, jittered by the
words of the JAX tool's `PRNGKey(5)`), the skip front (march and
positions), its compaction, and `render_packed(skip)` forward + backward.
Each stage prints its ms per call and how many times each of the port's
CUDA kernels launched per call (`ops/cuda_lib.py`'s counters).  The stages
do not add up to a step: each runs alone and synchronized.  `main(argv)`
returns the stages.  Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

# the seed words of the JAX tool's jax.random.PRNGKey(5) (its raw key data),
# with which it jitters the skip march
SKIP_JITTER_WORDS = (0, 5)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bucket", type=int, default=16)
    ap.add_argument("--method", default="kplanes", choices=["vanilla", "kplanes", "cobafa"])
    ap.add_argument("--march", default="dense", choices=["dense", "skip"])
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--batch_size", type=int, default=2048)
    ap.add_argument("--n_samples", type=int, default=400)
    ap.add_argument("--occupancy_res", type=int, default=128)
    ap.add_argument("--field_scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from tinynerf_tpu_torch.core.renderer import compact
    from tinynerf_tpu_torch.core.skipmarch import skip_march
    from tinynerf_tpu_torch.ops import cuda_lib
    from tinynerf_tpu_torch.ops.segscan import compute_weights_packed
    from tinynerf_tpu_torch.train import TrainConfig, build_renderer, make_optimizer
    from tinynerf_tpu_torch.utils import make_shell_occupancy
    from tinynerf_tpu_torch.utils.device import card_line, resolve_device, synchronize

    device = resolve_device(args.device, "profile_step_torch")
    card = card_line(device)
    cfg = TrainConfig(method=args.method, batch_size=args.batch_size, n_samples=args.n_samples,
                      occupancy_res=args.occupancy_res, field_scale=args.field_scale)
    R = args.bucket * cfg.batch_size
    S = cfg.n_samples
    CAP = cfg.sample_cap
    total = R * S
    print(f"{card}: {args.method}, bucket={args.bucket}  rays={R}  samples/ray={S}  cap={CAP}  "
          f"candidates={total}", flush=True)

    renderer = build_renderer(cfg, 1.0, np.ones(3, np.float32), device=device,
                              generator=torch.Generator().manual_seed(0))
    optimizer = make_optimizer(cfg, renderer)
    params = optimizer.params
    occ_state = make_shell_occupancy(renderer.occupancy, device=device)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_o = torch.from_numpy(-4.0 * d).to(device)
    rays_d = torch.from_numpy(d).to(device)
    rgbs = torch.from_numpy(rng.uniform(size=(R, 3)).astype(np.float32)).to(device)
    marcher, contraction, field = renderer.marcher, renderer.contraction, renderer.field
    dt = renderer.compute_dtype
    stages = {}

    def timeit(name, fn, n=args.n):
        out = fn()  # warm-up
        synchronize(device)
        before = cuda_lib.launch_counts()
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        synchronize(device)
        ms = (time.perf_counter() - t0) / n * 1e3
        per_call = {k: v / n for k, v in cuda_lib.launches_since(before).items() if v}
        stages[name] = {"ms": ms, "launches_per_call": per_call}
        print(f"{name:42s} {ms:9.3f} ms   launches/call {per_call}", flush=True)
        return out

    def grads_of(loss_fn):
        return lambda: torch.autograd.grad(loss_fn(), params, allow_unused=True)

    def packed_loss(**kw):
        out = renderer.render_packed(occ_state, rays_o, rays_d, CAP, **kw)
        per_ray = torch.mean((out.rgb - rgbs) ** 2, dim=-1)
        return torch.sum(per_ray * out.ray_valid) / torch.clamp(torch.sum(out.ray_valid), min=1.0)

    result = {"card": card, "bucket": args.bucket, "rays": R, "samples_per_ray": S, "cap": CAP,
              "candidates": total, "stages": stages}
    if args.march == "skip":
        skip_grid = timeit("skip-grid build (per occ update)", lambda: renderer.skip_grid(occ_state))
        t_min, t_exit = marcher.entry_exit(rays_o, rays_d)
        k_idx, complete = timeit(f"skip-march scan (K={renderer.skip_steps})", lambda: skip_march(
            rays_o, rays_d, t_min, t_exit, marcher.step_size, cfg.n_samples, contraction.aabb,
            skip_grid, SKIP_JITTER_WORDS, renderer.skip_steps))
        result["skip_emitted"] = int((k_idx >= 0).sum())
        result["skip_complete_frac"] = float(complete.float().mean())
        print(f"   (emitted {result['skip_emitted']} samples; {result['skip_complete_frac']:.4f} complete)",
              flush=True)
        cpos_s, _, maskf_s, _ = timeit("skip front (scan + positions)", lambda: renderer._march_skip(
            rays_o, rays_d, skip_grid, SKIP_JITTER_WORDS))

        def compact_skip():
            is_pad, safe_idx, seg = compact(maskf_s > 0.0, min(CAP, R * renderer.skip_steps))
            return cpos_s.reshape(-1, 3)[safe_idx], seg, is_pad

        timeit("compaction (cumsum + scatter over R*K)", compact_skip)
        timeit("render_packed(skip) fwd+bwd", grads_of(lambda: packed_loss(
            march="skip", skip_grid=skip_grid, jitter_seed=SKIP_JITTER_WORDS)), n=max(3, args.n // 2))

    with torch.no_grad():
        def march_only():
            t, deltas = marcher(rays_o, rays_d)
            pos = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
            cpos, maskf = contraction(pos)
            return cpos, deltas, maskf

        cpos, deltas, maskin = timeit("march+contract (no occ)", march_only)
        maskf = timeit("occupancy query (R*S)", lambda: maskin * renderer.occupancy.query(occ_state, cpos))
        fill = float(maskf.sum()) / total
        result["valid_fraction"] = fill
        print(f"   (valid fraction {fill:.4f} -> {fill * total:.0f} valid samples)", flush=True)

        def compaction():
            is_pad, safe_idx, seg = compact(maskf > 0.0, min(CAP, total))
            return cpos.reshape(total, 3)[safe_idx], seg, is_pad, safe_idx

        cpos_cap, seg, is_pad, safe_idx = timeit("compaction (cumsum + scatter) + pos gather", compaction)
        feats = timeit("field fwd (CAP pts)", lambda: field.apply_pieces(cpos_cap, dt))
    timeit("field fwd+bwd (CAP pts)", grads_of(lambda: sum(
        torch.sum(y.float() ** 2) for y in field.apply_pieces(cpos_cap, dt))), n=max(3, args.n // 2))
    with torch.no_grad():
        sigma = timeit("sigma decoder fwd", lambda: renderer.sigma_decoder(feats, dt))
        dirs_cap = rays_d[torch.where(is_pad, 0, seg)]
        timeit("rgb decoder fwd", lambda: renderer.rgb_decoder(feats, dirs_cap, dt))
    feats_d = tuple(f.detach() for f in feats)
    timeit("decoders fwd+bwd", grads_of(lambda: torch.sum(renderer.sigma_decoder(feats_d, dt))
                                        + torch.sum(renderer.rgb_decoder(feats_d, dirs_cap, dt))),
           n=max(3, args.n // 2))
    with torch.no_grad():
        valid = 1.0 - is_pad.float()
        delta_cap = deltas.reshape(-1)[safe_idx].contiguous()
        timeit("packed weights fwd (segscan)", lambda: compute_weights_packed(
            sigma.float().contiguous(), delta_cap, valid, seg.to(torch.int32), 1e-4, n_segments=R))
    zero_grads = [torch.zeros_like(p) for p in params]
    timeit("optimizer update", lambda: optimizer.step(zero_grads))
    if args.method == "kplanes":
        timeit("TV reg grad", grads_of(field.loss_tv), n=max(3, args.n // 2))
    with torch.no_grad():
        timeit("render_packed fwd", lambda: renderer.render_packed(occ_state, rays_o, rays_d, CAP).rgb,
               n=max(3, args.n // 2))
    timeit("render_packed fwd+bwd", grads_of(packed_loss), n=max(3, args.n // 2))
    print(f"card: {card}")
    return result


if __name__ == "__main__":
    main()
