"""Serving entry points: build the renderer, render images in fixed ray chunks,
evaluate, and render from a checkpoint (`render_only`).

Counterpart of the serving subset of `tinynerf_tpu/train/loop.py`
(`build_renderer`, `make_render_chunk`, `make_render_chunk_packed`,
`infer`, `evaluate`, `render_only`).  Differences from the JAX module:

  * parameters live in the renderer's modules, so the chunk functions and
    `infer` take no `params` argument (`convert.load_params` fills them);
  * one device, named by the caller (`device`); no mesh, no sharding;
  * the packed path marches densely (`march="dense"`): skip marching
    (`core/skipmarch.py`) is not ported yet.  The JAX `render_only` picks
    skip marching when the scene allows it; both marches select the same
    sample set (the JAX package tests them equal to 1e-5).

Training (`train`, the optimizer, the occupancy update) is not ported yet
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..convert import load_params, occ_state_to_torch
from ..core.contraction import ContractionAABB
from ..core.marching import RayMarcherAABB
from ..core.occupancy import OccupancyGrid, OccupancyState
from ..core.renderer import NerfRenderer
from ..data.pipeline import PoseSet
from ..models.registry import make_model
from ..utils.image import save_png
from .checkpoint import latest_checkpoint, load_checkpoint
from .config import TrainConfig
from .metrics import EvalMetrics, eval_metrics

TRAINING_NOT_PORTED = (
    "training is not ported to tinynerf_tpu_torch yet "
    "(ROADMAP.md Queue 1, 'Single-GPU training')"
)


def build_renderer(
    cfg: TrainConfig, scene_scale: float, bg_color, device=None,
    generator: Optional[torch.Generator] = None,
) -> NerfRenderer:
    """Wire field/decoders/marcher/contraction/occupancy from config.
    Parameters are drawn from `generator` (default: seeded with cfg.seed)."""
    if cfg.scene_type != "aabb":
        raise NotImplementedError(
            f"scene_type {cfg.scene_type!r} is not ported yet (ROADMAP.md Queue 1, "
            "'Unbounded scenes and nerfstudio')"
        )
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    field_, sigma_dec, rgb_dec = make_model(
        cfg.method, fwd_clamp=cfg.fwd_clamp, field_scale=cfg.field_scale,
        generator=generator, device=device,
    )
    marcher = RayMarcherAABB(cfg.aabb, n_samples=cfg.n_samples, near=cfg.near)
    occupancy = OccupancyGrid.cube(
        cfg.occupancy_res, marcher.step_size, threshold=cfg.occupancy_threshold,
        decay=cfg.occ_decay, interp=cfg.occupancy_interp,
    )
    return NerfRenderer(
        field=field_,
        sigma_decoder=sigma_dec,
        rgb_decoder=rgb_dec,
        marcher=marcher,
        contraction=ContractionAABB(cfg.aabb),
        occupancy=occupancy,
        bg_color=tuple(float(c) for c in bg_color) if bg_color is not None else None,
        early_termination=cfg.early_termination,
        compute_dtype=torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32,
    )


def make_render_chunk(renderer: NerfRenderer) -> Callable:
    """Dense render of one ray chunk: fn(occ_state, rays_o, rays_d) -> rgb."""

    def render_chunk(occ_state, rays_o, rays_d):
        return renderer.render_dense(occ_state, rays_o, rays_d).rgb

    return render_chunk


def make_render_chunk_packed(renderer: NerfRenderer, cap: int) -> Callable:
    """Fixed-capacity packed render of one ray chunk (dense march), the
    serving path: fn(occ_state, rays_o, rays_d) -> (rgb [R, 3], ok [R] bool,
    n_samples).  ok=False rays overflowed the cap; `infer` re-renders
    exactly those through the dense path, so packed serving is exact."""

    def render(occ_state, rays_o, rays_d):
        out = renderer.render_packed(occ_state, rays_o, rays_d, cap)
        return out.rgb, out.ray_valid > 0.0, out.n_samples

    return render


@dataclass
class InferStats:
    """What `infer` did: per image its rendering (float, before the PNG's
    8-bit rounding), seconds on the host clock (synchronized) and ray count,
    and in total the packed samples and the rays re-rendered densely."""

    images: List[np.ndarray] = field(default_factory=list)
    seconds: List[float] = field(default_factory=list)
    rays: List[int] = field(default_factory=list)
    packed_samples: int = 0
    fallback_rays: int = 0


def _renderer_device(renderer: NerfRenderer) -> torch.device:
    return next(renderer.parameters()).device


def infer(
    renderer: NerfRenderer,
    occ_state: OccupancyState,
    dataset: PoseSet,
    indices: Sequence[int],
    folder: Path,
    name: str,
    chunk: int = 8192,
    render_chunk_fn: Optional[Callable] = None,
    packed_fn: Optional[Callable] = None,
    stats: Optional[InferStats] = None,
) -> List[np.ndarray]:
    """Render full images pose by pose in fixed-size ray chunks on the
    renderer's device and save `{name}_{i:04d}.png`.  With `packed_fn`, rays
    the packed buffer could not hold are re-rendered by `render_chunk_fn`
    (dense), padded to the same chunk shape."""
    if render_chunk_fn is None:
        render_chunk_fn = make_render_chunk(renderer)
    device = _renderer_device(renderer)
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    pad_d = torch.tensor([0.0, 0.0, 1.0], device=device)

    rendered: List[np.ndarray] = []
    for i in indices:
        t0 = time.perf_counter()
        item = dataset[i]
        K = dataset.img_intrinsics(i)
        rays_o = torch.from_numpy(np.asarray(item["rays_o"], np.float32).reshape(-1, 3))
        rays_d = torch.from_numpy(np.asarray(item["rays_d"], np.float32).reshape(-1, 3))
        n = rays_o.shape[0]
        n_pad = (-n) % chunk
        rays_o = torch.cat([rays_o.to(device), torch.zeros(n_pad, 3, device=device)])
        rays_d = torch.cat([rays_d.to(device), pad_d.expand(n_pad, 3)])
        with torch.inference_mode():
            # queue every chunk before reading any back (the host then waits
            # once per chunk for its overflow flags, not per launch)
            chunks = []
            for k in range(0, rays_o.shape[0], chunk):
                o_c, d_c = rays_o[k : k + chunk], rays_d[k : k + chunk]
                if packed_fn is not None:
                    chunks.append((*packed_fn(occ_state, o_c, d_c), o_c, d_c))
                else:
                    chunks.append((render_chunk_fn(occ_state, o_c, d_c), None, None, o_c, d_c))
            outs = []
            for rgb, ok, n_samples, o_c, d_c in chunks:
                if ok is not None:
                    bad = torch.nonzero(~ok).flatten()
                    nb = bad.numel()
                    if stats is not None:
                        stats.packed_samples += int(n_samples)
                        stats.fallback_rays += nb
                    if nb:
                        o_b = torch.zeros(chunk, 3, device=device)
                        d_b = pad_d.expand(chunk, 3).clone()
                        o_b[:nb], d_b[:nb] = o_c[bad], d_c[bad]
                        dense = render_chunk_fn(occ_state, o_b, d_b)
                        rgb = rgb.clone()
                        rgb[bad] = dense[:nb]
                outs.append(rgb)
            img = torch.cat(outs)[:n].reshape(K.h, K.w, 3).cpu().numpy()
        if stats is not None:
            stats.seconds.append(time.perf_counter() - t0)
            stats.rays.append(n)
            stats.images.append(img)
        rendered.append(img)
        save_png(img, folder / f"{name}_{i:04d}.png")
    return rendered


def evaluate(dataset: PoseSet, rendered: List[np.ndarray], indices: Sequence[int]) -> List[EvalMetrics]:
    if dataset.rgbs is None:
        raise ValueError("evaluate needs ground-truth images")
    return [eval_metrics(img, np.asarray(dataset[i]["rgbs"])) for i, img in zip(indices, rendered)]


def render_only(
    cfg: TrainConfig,
    pose_set: PoseSet,
    name: str = "render",
    device="cuda",
    stats: Optional[InferStats] = None,
) -> Optional[List[EvalMetrics]]:
    """Render `pose_set` from the latest checkpoint in cfg.output (the CLI's
    `--render_only`) on `device`.  Writes `{name}_{i:04d}.png` per pose and,
    with ground truth, `metrics_render.json`; returns the per-image metrics
    (None without ground truth)."""
    output = Path(cfg.output)
    ck = latest_checkpoint(output)
    if ck is None:
        raise FileNotFoundError(f"no checkpoint found under {output}")
    step, state = load_checkpoint(ck)
    print(f"Rendering from {ck} (step {step})")

    renderer = build_renderer(
        cfg, scene_scale=pose_set.scene_scale,
        bg_color=np.asarray(pose_set.bg_color) if pose_set.bg_color is not None else None,
        device=device,
    )
    load_params(renderer, state["params"])
    occ_state = occ_state_to_torch(state["occ_state"], device)
    if tuple(occ_state.grid.shape) != renderer.occupancy.size:
        raise ValueError(
            f"checkpoint occupancy grid {tuple(occ_state.grid.shape)} does not fit "
            f"occupancy_res={cfg.occupancy_res}"
        )
    packed_fn = None
    if cfg.eval_render == "packed":
        packed_fn = make_render_chunk_packed(renderer, cfg.batch_size * cfg.eval_samples_per_ray)
    indices = list(range(len(pose_set)))
    rendered = infer(
        renderer, occ_state, pose_set, indices, output, name,
        chunk=cfg.batch_size, render_chunk_fn=make_render_chunk(renderer),
        packed_fn=packed_fn, stats=stats,
    )
    if pose_set.rgbs is None:
        return None
    metrics = evaluate(pose_set, rendered, indices)
    with open(output / "metrics_render.json", "w") as f:
        json.dump([asdict(x) for x in metrics], f)
    psnrs = [m.psnr for m in metrics]
    print(f"rendered {len(metrics)} poses: psnr {np.mean(psnrs):.2f} "
          f"(min {np.min(psnrs):.2f}, max {np.max(psnrs):.2f})")
    return metrics

