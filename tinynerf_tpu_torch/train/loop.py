"""Training, inference and evaluation on one device.

Counterpart of `tinynerf_tpu/train/loop.py`: `build_renderer`, the
optimizer (`lr_schedule`, `_decay_mask`, the fused Adam), `make_train_step`,
`make_occupancy_update`, the bucket and march policies, `train`, and the
serving entry points (`make_render_chunk`, `make_render_chunk_packed`,
`infer`, `evaluate`, `render_only`).  Differences from the JAX module:

  * parameters live in the renderer's modules and the Adam state in the
    optimizer object, so the step and chunk functions take no `params`
    argument; checkpoints still hold both in the JAX layout (`convert.py`);
  * one device, named by the caller (`device`); no mesh, no sharding
    (`shard_tables` / `shard_bwd` raise);
  * PyTorch runs eagerly, so a "compiled step" is a closure, and the random
    streams are `torch.Generator`s seeded from (seed, step), so a resumed
    run continues its stream as the JAX one does with `fold_in`;
  * as in the JAX package, `render_only` serves with the skip march
    whenever the renderer supports it, and `train` switches to it through
    `MarchPolicy` once the demand estimate leaves ample round budget; the
    skip grid is rebuilt at every occupancy update and never checkpointed.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import (
    load_params,
    occ_state_to_numpy,
    occ_state_to_torch,
    param_tree,
    params_to_numpy,
    to_numpy,
    tree_leaves_with_path,
    tree_map,
    tree_map_with_path,
)
from ..core.contraction import ContractionAABB, ContractionMip360
from ..core.marching import RayMarcherAABB, RayMarcherUnbounded
from ..core.occupancy import OccupancyGrid, OccupancyState
from ..core.renderer import NerfRenderer
from ..data.pipeline import PoseSet, RayPool, sample_ray_batch
from ..models.registry import make_model
from ..utils.image import save_png
from .checkpoint import ScaleByAdamState, latest_checkpoint, load_checkpoint, save_checkpoint
from .config import TrainConfig
from .metrics import EvalMetrics, TrainMetrics, eval_metrics

MULTI_DEVICE_NOT_PORTED = (
    "shard_tables / shard_bwd need several devices, which the port does not "
    "drive yet (ROADMAP.md Queue 1, 'Multi-device')"
)


def build_renderer(
    cfg: TrainConfig, scene_scale: float, bg_color, device=None,
    generator: Optional[torch.Generator] = None,
) -> NerfRenderer:
    """Wire field/decoders/marcher/contraction/occupancy from config.
    Parameters are drawn from `generator` (default: seeded with cfg.seed).
    An unbounded scene spans its disparity grid over `scene_scale`."""
    if cfg.scene_type == "unbounded":
        marcher = RayMarcherUnbounded(cfg.n_samples, near=cfg.near, far=1e5, uniform_range=scene_scale)
        contraction = ContractionMip360(order=float("inf"))
    elif cfg.scene_type == "aabb":
        marcher = RayMarcherAABB(cfg.aabb, n_samples=cfg.n_samples, near=cfg.near)
        contraction = ContractionAABB(cfg.aabb)
    else:
        raise NotImplementedError(f"Unknown scene type {cfg.scene_type!r}.")
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    field_, sigma_dec, rgb_dec = make_model(
        cfg.method, fwd_clamp=cfg.fwd_clamp, field_scale=cfg.field_scale,
        generator=generator, device=device,
    )
    occupancy = OccupancyGrid.cube(
        cfg.occupancy_res, marcher.step_size, threshold=cfg.occupancy_threshold,
        decay=cfg.occ_decay, interp=cfg.occupancy_interp,
    )
    return NerfRenderer(
        field=field_,
        sigma_decoder=sigma_dec,
        rgb_decoder=rgb_dec,
        marcher=marcher,
        contraction=contraction,
        occupancy=occupancy,
        bg_color=tuple(float(c) for c in bg_color) if bg_color is not None else None,
        early_termination=cfg.early_termination,
        compute_dtype=torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32,
        skip_steps=min(cfg.effective_skip_steps, cfg.n_samples),
        # the JAX rule: only the wide vanilla MLP at caps whose activations
        # approach the device memory needs it
        remat_field=(cfg.remat_field if cfg.remat_field is not None
                     else cfg.method == "vanilla" and cfg.sample_cap > 2_000_000),
    )


def _decay_mask(tree: dict, table_keys=frozenset(), mlp_keys=frozenset({"mlp"})) -> dict:
    """Weight-decay mask over a JAX-layout parameter tree: decay MLP/linear
    weights, NOT the raw feature tables (`tinynerf_tpu/train/loop.py:
    _decay_mask`: under Adam a constant decay direction on a sparsely
    supervised table cell steps at the full learning rate and flattens the
    tables).  Field parameters must be declared in the field's table_keys or
    mlp_keys; decoder parameters always decay."""
    undeclared = set(tree["field"]) - set(table_keys) - set(mlp_keys)
    if undeclared:
        raise ValueError(
            f"field params {sorted(undeclared)} are not declared in the field's "
            f"table_keys={sorted(table_keys)} or mlp_keys={sorted(mlp_keys)}"
        )

    def mask(path, _):
        if path[0] == "field":
            return not any(k in table_keys for k in path[1:])
        return True

    return tree_map_with_path(mask, tree)


def lr_schedule(cfg: TrainConfig) -> Callable[[int], np.float32]:
    """Piecewise-constant learning rate with torch MultiStepLR semantics
    (gamma once PER MILESTONE OCCURRENCE, so milestones that collapse to one
    step compose), computed in f32 as optax's piecewise_constant_schedule:
    a boundary's scale applies from that count on."""
    steps = cfg.total_steps
    boundaries: Dict[int, float] = {}
    for m in cfg.lr_milestones:
        b = max(1, int(m * steps))
        boundaries[b] = boundaries.get(b, 1.0) * cfg.lr_gamma
    init = np.float32(cfg.effective_lr)

    def schedule(count: int) -> np.float32:
        v = init
        for b, scale in sorted(boundaries.items()):
            if count >= b:
                v = np.float32(np.float32(scale) * v)
        return v

    return schedule


class FusedAdam:
    """Adam with in-grad weight decay, the LR schedule and a split table
    learning rate in one pass over the parameters, in the JAX package's op
    order (`tinynerf_tpu/train/loop.py:_fused_adam`):

        g  += wd * p                      (decayed leaves)
        mu  = b1 mu + (1 - b1) g ;  nu = b2 nu + (1 - b2) g^2
        u   = -lr(count) * (mu / c1) / (sqrt(nu / c2) + eps) [* table ratio]
        p  += u

    with lr read at the pre-increment count and c1 = 1 - b1^count, c2 =
    1 - b2^count at the post-increment one.  The state is {count, mu, nu}
    with mu/nu in the parameters' JAX layout, so checkpoints keep the JAX
    format (`state` / `load_state`)."""

    def __init__(self, tree: dict, schedule, eps: float, weight_decay: float,
                 decay_tree: dict, table_ratio: float, table_tree: dict,
                 b1: float = 0.9, b2: float = 0.999):
        leaves = list(tree_leaves_with_path(tree))
        self.tree = tree
        self.paths = [path for path, _ in leaves]
        self.params = [t for _, t in leaves]
        decay = dict(tree_leaves_with_path(decay_tree))
        table = dict(tree_leaves_with_path(table_tree))
        self.decay = [bool(decay[path]) for path in self.paths]
        self.table = [bool(table[path]) for path in self.paths]
        self.schedule, self.eps, self.weight_decay = schedule, eps, weight_decay
        self.table_ratio, self.b1, self.b2 = table_ratio, b1, b2
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        lr = self.schedule(self.count)
        self.count += 1
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(self.count))
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(self.count))
        grads = list(grads)
        if self.weight_decay != 0.0:
            for i, dec in enumerate(self.decay):
                if dec:
                    grads[i] = grads[i] + self.weight_decay * self.params[i]
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, -float(lr))
        if self.table_ratio != 1.0:
            for i, tab in enumerate(self.table):
                if tab:
                    upd[i].mul_(self.table_ratio)
        torch._foreach_add_(self.params, upd)

    def as_tree(self, leaves: Sequence) -> dict:
        """`leaves` (aligned with the parameters) in the parameters' layout."""
        by_path = dict(zip(self.paths, leaves))
        return tree_map_with_path(lambda path, _: by_path[path], self.tree)

    def state(self) -> ScaleByAdamState:
        """{count, mu, nu} as numpy, in the JAX package's layout."""
        return ScaleByAdamState(
            count=np.asarray(self.count, np.int32),
            mu=self.as_tree([to_numpy(t) for t in self.mu]),
            nu=self.as_tree([to_numpy(t) for t in self.nu]),
        )

    def load_state(self, state) -> None:
        """Load {count, mu, nu} written by either package."""
        mu = dict(tree_leaves_with_path(state.mu))
        nu = dict(tree_leaves_with_path(state.nu))
        with torch.no_grad():
            for i, path in enumerate(self.paths):
                for dst, src in ((self.mu[i], mu[path]), (self.nu[i], nu[path])):
                    src = np.asarray(src, np.float32)
                    if tuple(src.shape) != tuple(dst.shape):
                        raise ValueError(f"optimizer state {path}: {src.shape} does not fit {tuple(dst.shape)}")
                    dst.copy_(torch.from_numpy(src.copy()))
        self.count = int(np.asarray(state.count))


def make_optimizer(cfg: TrainConfig, renderer: NerfRenderer) -> FusedAdam:
    """Adam + L2-in-grad weight decay (masked off the feature tables) + the
    piecewise-constant schedule + the split table lr, over the renderer's
    parameters, as `tinynerf_tpu/train/loop.py:make_optimizer`."""
    tree = param_tree(renderer)
    mask = _decay_mask(tree, renderer.field.table_keys, renderer.field.mlp_keys)
    decay_tree = tree_map(lambda _: True, tree) if cfg.decay_tables else mask
    lr_tables = cfg.effective_lr_tables
    if lr_tables is not None and lr_tables != cfg.effective_lr:
        ratio = lr_tables / cfg.effective_lr
        table_tree = tree_map(lambda m: not m, mask)
    else:
        ratio = 1.0
        table_tree = tree_map(lambda _: False, tree)
    return FusedAdam(tree, lr_schedule(cfg), cfg.adam_eps, cfg.weight_decay,
                     decay_tree, ratio, table_tree)


# ---------------------------------------------------------------- train step


def make_train_step(
    renderer: NerfRenderer,
    optimizer: FusedAdam,
    cfg: TrainConfig,
    n_cand: int,
    deterministic: bool = False,
    march: str = "dense",
) -> Callable:
    """One train step for `n_cand` candidate rays:
    fn(occ_state, pool_o, pool_d, pool_rgb, generator) -> metrics, a dict of
    device scalars (loss, rays_used, fill, complete_frac); with
    `march="skip"` the step takes the skip grid (`renderer.skip_grid`,
    rebuilt at each occupancy update) right after occ_state.  The step
    samples the batch and four seed words from `generator` (two for the
    sample jitter, two for a field's dropout mask), renders the packed path
    on the chosen march, takes the per-ray MSE
    over rays that fit the sample cap plus the K-Planes TV/L1 regularizers,
    and updates the parameters in place.

    `deterministic=True` (tests) takes the pool's first `n_cand` rays with no
    jitter and no dropout (the JAX step's `krender=None`), and adds the
    gradients (JAX layout, the update's input) to the metrics: the JAX
    package's seam for comparing steps.
    """
    cap = cfg.sample_cap
    field_ = renderer.field
    has_reg = cfg.method == "kplanes" and (cfg.tv_reg_alpha != 0.0 or cfg.l1_reg_alpha != 0.0)
    params = optimizer.params
    if march not in ("dense", "skip"):
        raise ValueError(f"unknown march {march!r}")
    use_skip = march == "skip"

    def step(occ_state, *rest):
        skip_grid = rest[0] if use_skip else None
        pool_o, pool_d, pool_rgb, *gen = rest[1:] if use_skip else rest
        generator = gen[0] if gen else None
        if deterministic:
            rays_o, rays_d, rgbs = pool_o[:n_cand], pool_d[:n_cand], pool_rgb[:n_cand]
            jitter_seed = dropout_seed = None
        else:
            rays_o, rays_d, rgbs = sample_ray_batch(generator, pool_o, pool_d, pool_rgb, n_cand)
            words = torch.randint(0, 2**32, (4,), generator=generator, device=pool_o.device)
            jitter_seed, dropout_seed = words[:2], words[2:]
        out = renderer.render_packed(occ_state, rays_o, rays_d, cap,
                                     jitter_seed=jitter_seed, dropout_seed=dropout_seed,
                                     march=march, skip_grid=skip_grid)
        per_ray_mse = torch.mean((out.rgb - rgbs) ** 2, dim=-1)
        num = torch.sum(per_ray_mse * out.ray_valid)
        den = torch.sum(out.ray_valid)
        loss = num * (1.0 / torch.clamp(den, min=1.0))
        if has_reg:
            reg = cfg.tv_reg_alpha * field_.loss_tv()
            if cfg.l1_reg_alpha != 0.0:
                reg = reg + cfg.l1_reg_alpha * field_.loss_l1()
            loss = loss + reg
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        optimizer.step(grads)
        metrics = {"loss": loss.detach(), "rays_used": den, "fill": out.n_samples.float() / cap,
                   "complete_frac": out.n_complete.float() / n_cand}
        if deterministic:
            metrics["grads"] = optimizer.as_tree(grads)
        return metrics

    return step


def make_occupancy_update(renderer: NerfRenderer) -> Callable:
    """fn(occ_state, generator) -> the state after one decay/confirm sweep."""

    def update(occ_state, generator=None):
        return renderer.occupancy.update(occ_state, renderer.sigma_fn, generator)

    return update


def make_render_chunk(renderer: NerfRenderer) -> Callable:
    """Dense render of one ray chunk: fn(occ_state, rays_o, rays_d) -> rgb."""

    def render_chunk(occ_state, rays_o, rays_d):
        return renderer.render_dense(occ_state, rays_o, rays_d).rgb

    return render_chunk


def make_render_chunk_packed(renderer: NerfRenderer, cap: int, march: str = "dense") -> Callable:
    """Fixed-capacity packed render of one ray chunk, the serving path, with
    the skip march when `march="skip"` (the skip grid is then the trailing
    argument): fn(occ_state, rays_o, rays_d, *grid) -> (rgb [R, 3], ok [R]
    bool, n_samples, n_complete).  ok=False rays overflowed the cap or
    exhausted the skip march's rounds; `infer` re-renders exactly those
    through the dense path, so packed serving is exact."""
    if march not in ("dense", "skip"):
        raise ValueError(f"unknown march {march!r}")

    def render(occ_state, rays_o, rays_d, *grid):
        out = renderer.render_packed(occ_state, rays_o, rays_d, cap, rgb_dir_branch="ray",
                                     march=march, skip_grid=grid[0] if grid else None)
        return out.rgb, out.ray_valid > 0.0, out.n_samples, out.n_complete

    return render


@dataclass
class InferStats:
    """What `infer` did: per image its rendering (float, before the PNG's
    8-bit rounding), seconds on the host clock (synchronized) and ray count;
    in total the packed samples, the rays re-rendered densely, and the rays
    whose skip march ran out of rounds (padding rays included); and
    `render_only`'s skip-grid build, seconds (synchronized)."""

    images: List[np.ndarray] = field(default_factory=list)
    seconds: List[float] = field(default_factory=list)
    rays: List[int] = field(default_factory=list)
    packed_samples: int = 0
    fallback_rays: int = 0
    incomplete_rays: int = 0
    skip_grid_seconds: float = 0.0


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
    grid_args: Tuple = (),
) -> List[np.ndarray]:
    """Render full images pose by pose in fixed-size ray chunks on the
    renderer's device and save `{name}_{i:04d}.png`.  With `packed_fn` (and
    its trailing `grid_args`), the rays it flags (cap overflow, skip-march
    rounds exhausted) are re-rendered by `render_chunk_fn` (dense), gathered
    over the image into chunks of the same shape (the JAX `infer` re-renders
    per packed chunk; every ray's value is the same either way)."""
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
                    chunks.append((*packed_fn(occ_state, o_c, d_c, *grid_args), o_c, d_c))
                else:
                    chunks.append((render_chunk_fn(occ_state, o_c, d_c), None, None, None, o_c, d_c))
            outs, bad_o, bad_d, bad_at = [], [], [], []
            for k, (rgb, ok, n_samples, n_complete, o_c, d_c) in enumerate(chunks):
                if ok is not None:
                    bad = torch.nonzero(~ok).flatten()
                    if stats is not None:
                        stats.packed_samples += int(n_samples)
                        stats.fallback_rays += bad.numel()
                        stats.incomplete_rays += o_c.shape[0] - int(n_complete)
                    if bad.numel():
                        bad_o.append(o_c[bad])
                        bad_d.append(d_c[bad])
                        bad_at.append(k * chunk + bad)
                outs.append(rgb)
            flat = torch.cat(outs)
            if bad_at:
                # the image's rays that the packed path flagged, re-rendered
                # densely in full chunks: one dense chunk per `chunk` such
                # rays, not one per packed chunk that flagged any
                o_b, d_b, at = torch.cat(bad_o), torch.cat(bad_d), torch.cat(bad_at)
                for a in range(0, at.numel(), chunk):
                    nb = min(chunk, at.numel() - a)
                    o_p = torch.zeros(chunk, 3, device=device)
                    d_p = pad_d.expand(chunk, 3).clone()
                    o_p[:nb], d_p[:nb] = o_b[a : a + nb], d_b[a : a + nb]
                    flat[at[a : a + nb]] = render_chunk_fn(occ_state, o_p, d_p)[:nb]
            img = flat[:n].reshape(K.h, K.w, 3).cpu().numpy()
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
    grid_args: Tuple = ()
    if cfg.eval_render == "packed":
        can_skip = renderer.supports_skip_march
        packed_fn = make_render_chunk_packed(
            renderer, cfg.batch_size * cfg.eval_samples_per_ray, march="skip" if can_skip else "dense")
        if can_skip:
            t0 = time.perf_counter()
            grid_args = (renderer.skip_grid(occ_state),)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            if stats is not None:
                stats.skip_grid_seconds = time.perf_counter() - t0
    indices = list(range(len(pose_set)))
    rendered = infer(
        renderer, occ_state, pose_set, indices, output, name,
        chunk=cfg.batch_size, render_chunk_fn=make_render_chunk(renderer),
        packed_fn=packed_fn, stats=stats, grid_args=grid_args,
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



# ------------------------------------------------------------------ bucket


def pick_bucket(cfg: TrainConfig, avg_samples_per_ray: float) -> int:
    """Largest candidate-ray bucket whose expected sample demand fits the cap
    (the reference's running samples/ray predictor, on the host)."""
    want = cfg.sample_cap * cfg.bucket_overfill / max(avg_samples_per_ray, 1.0) / cfg.batch_size
    bucket = min(cfg.ray_buckets)
    for b in sorted(cfg.ray_buckets):
        if b <= want:
            bucket = b
    if cfg.max_bucket is not None:
        bucket = min(bucket, cfg.max_bucket)
    return bucket


class BucketEstimator:
    """Running samples/ray estimate driving `pick_bucket`.  Each refresh
    reads two device scalars (a host sync), so refreshes come every
    `refresh_every` steps, and right after an occupancy update
    (`mark_occupancy_changed`), when demand jumps."""

    def __init__(self, cfg: TrainConfig, refresh_every: int = 8):
        self.cfg = cfg
        self.refresh_every = refresh_every
        self.avg_samples_per_ray = float(cfg.n_samples)
        self.just_refreshed = False
        self._since = 0
        self._force = False

    def mark_occupancy_changed(self) -> None:
        self._force = True

    def observe(self, fill, rays_used) -> None:
        """Feed one step's (fill, rays_used) scalars; reads them only when a
        refresh is due."""
        self._since += 1
        if not (self._force or self._since >= self.refresh_every):
            self.just_refreshed = False
            return
        self.just_refreshed = True
        fill_v, rays_v = float(fill), float(rays_used)
        if rays_v > 0:
            self.avg_samples_per_ray = max(1.0, fill_v * self.cfg.sample_cap / rays_v)
        self._since = 0
        self._force = False

    def bucket(self) -> int:
        return pick_bucket(self.cfg, self.avg_samples_per_ray)


class MarchPolicy:
    """Dense-vs-skip marching choice of `train` (`tinynerf_tpu/train/loop.py:
    MarchPolicy`).  The skip march engages once the demand estimate leaves
    ample round budget (avg samples/ray <= SKIP_DEMAND_FRACTION *
    skip_steps).  Rays that exhaust the budget leave the loss, and always
    excluding the densest rays would bias training, so `observe` watches
    complete_frac on every skip step, one step late (it reads the previous
    step's scalar, which has long been computed), and on a trip falls back
    to dense marching until the next occupancy update."""

    SKIP_DEMAND_FRACTION = 0.35
    COMPLETE_MIN = 0.995

    def __init__(self, supported: bool, mode: str, skip_steps: int):
        if mode not in ("auto", "dense", "skip"):
            raise ValueError(f"unknown march mode {mode!r}")
        self.can_skip = supported and mode != "dense"
        self.forced = mode == "skip"
        self.skip_steps = skip_steps
        self.suspended = False  # until the next occupancy update
        self._pending = None  # complete_frac device scalar of the last skip step

    def on_occupancy_update(self) -> None:
        self.suspended = False
        self._pending = None

    def pick(self, avg_samples_per_ray: float) -> str:
        if not self.can_skip or self.suspended:
            return "dense"
        if self.forced:
            return "skip"
        return "skip" if avg_samples_per_ray <= self.SKIP_DEMAND_FRACTION * self.skip_steps else "dense"

    def observe(self, complete_frac) -> Optional[float]:
        """Feed a skip step's complete_frac scalar; checks the previous one.
        Returns the offending fraction when this trips the dense fallback,
        else None."""
        prev, self._pending = self._pending, complete_frac
        if prev is None:
            return None
        val = float(prev)
        if val < self.COMPLETE_MIN:
            self.suspended = True
            self._pending = None
            return val
        return None


# ---------------------------------------------------------------------- train


def _generator(device, seed: int, step: int, stream: int) -> torch.Generator:
    """The random stream `stream` of step `step` (0: batch and jitter, 1:
    occupancy jitter), a function of (seed, step) so a resumed run goes on
    with the streams of the steps it has not taken."""
    return torch.Generator(device=device).manual_seed(((seed * 1_000_003 + step) << 1) | stream)


def train(
    cfg: TrainConfig,
    train_rays: RayPool,
    eval_set: Optional[PoseSet] = None,
    test_set: Optional[PoseSet] = None,
    resume: bool = False,
    device="cuda",
) -> Dict[str, object]:
    """Full training run on `device`; returns {renderer, occ_state, metrics}.

    Writes, as the JAX `train` does: `metrics_train.json` (one record per
    step), `metrics_eval.json` / `eval_timeline.json` / `metrics_test.json`
    when evaluating, `throughput.json`, `ckpt_{step}.pkl` (every
    `checkpoint_every` steps and at the end; params, Adam state and
    occupancy state in the JAX layout) and the rendered PNGs.  With `resume`
    it continues from the latest checkpoint in cfg.output."""
    if cfg.shard_tables or cfg.shard_bwd:
        raise NotImplementedError(MULTI_DEVICE_NOT_PORTED)
    output = Path(cfg.output)
    output.mkdir(parents=True, exist_ok=True)
    steps = cfg.total_steps
    renderer = build_renderer(
        cfg, train_rays.scene_scale,
        np.asarray(train_rays.bg_color) if train_rays.bg_color is not None else None,
        device=device,
    )
    optimizer = make_optimizer(cfg, renderer)
    pool_o, pool_d, pool_rgb = (a.to(device) for a in train_rays.arrays())
    occ_state = renderer.occupancy.init_state(device)
    start_step = 0
    ckpt_meta = {"shard_tables": False, "n_devices": 1}

    if resume:
        ck = latest_checkpoint(output)
        if ck is not None:
            start_step, state = load_checkpoint(ck)
            saved = state.get("meta")
            if saved is not None and saved.get("shard_tables"):
                raise ValueError(
                    f"checkpoint {ck} was written with {saved}; its sharded optimizer "
                    "layout needs the same device count and --shard_tables setting")
            load_params(renderer, state["params"])
            optimizer.load_state(state["opt_state"])
            occ_state = occ_state_to_torch(state["occ_state"], device)
            print(f"Resumed from {ck} at step {start_step}")

    n_params = sum(p.numel() for p in optimizer.params)
    print(f"Using {cfg.method} with {n_params} parameters on {device}.")

    steps_by_key: Dict[Tuple[int, str], Callable] = {}

    def get_step(bucket: int, march: str) -> Callable:
        if (bucket, march) not in steps_by_key:
            steps_by_key[bucket, march] = make_train_step(
                renderer, optimizer, cfg, n_cand=bucket * cfg.batch_size, march=march)
        return steps_by_key[bucket, march]

    policy = MarchPolicy(renderer.supports_skip_march, cfg.march, renderer.skip_steps)
    skip_grid = renderer.skip_grid(occ_state) if policy.can_skip else None
    occ_update = make_occupancy_update(renderer)
    render_chunk_fn = make_render_chunk(renderer)
    packed_chunk_fn = None
    if cfg.eval_render == "packed":
        packed_chunk_fn = make_render_chunk_packed(
            renderer, cfg.batch_size * cfg.eval_samples_per_ray,
            march="skip" if policy.can_skip else "dense")

    def eval_grid_args() -> Tuple:
        # the skip grid current at eval time (rebuilt at occupancy updates)
        return (skip_grid,) if packed_chunk_fn is not None and policy.can_skip else ()

    train_metrics: List[TrainMetrics] = []
    eval_acc: List[EvalMetrics] = []
    eval_timeline: List[Dict[str, float]] = []
    pending: List[Tuple] = []  # (loss, occupancy, fill, rays_used) device scalars
    estimator = BucketEstimator(cfg)
    eval_ptr = 0
    rays_candidate = 0.0
    rays_used = 0.0
    t_start = time.perf_counter()

    def flush_pending():
        nonlocal rays_used
        if not pending:
            return
        # one device -> host copy for the whole batch of scalars
        host = torch.stack([torch.stack([v.float() for v in rec]) for rec in pending]).cpu()
        for loss_v, occ_v, _, rays_v in host.tolist():
            train_metrics.append(TrainMetrics(loss=loss_v, occupancy=occ_v))
            rays_used += rays_v
        pending.clear()

    occ_frac = renderer.occupancy.occupancy(occ_state)
    prof = None
    for step_i in range(start_step, steps):
        if cfg.profile_start is not None:
            if step_i == cfg.profile_start:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.device(device).type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            elif prof is not None and step_i == cfg.profile_start + cfg.profile_count:
                prof.stop()
                prof.export_chrome_trace(str(output / "trace.json"))
                prof = None

        if step_i % cfg.occ_update_every == 0:
            occ_state = occ_update(occ_state, _generator(device, cfg.seed, step_i, 1))
            occ_frac = renderer.occupancy.occupancy(occ_state)
            if policy.can_skip:
                skip_grid = renderer.skip_grid(occ_state)
            estimator.mark_occupancy_changed()
            policy.on_occupancy_update()

        bucket = estimator.bucket()
        march = policy.pick(estimator.avg_samples_per_ray)
        grid_args = (skip_grid,) if march == "skip" else ()
        m = get_step(bucket, march)(occ_state, *grid_args, pool_o, pool_d, pool_rgb,
                                    _generator(device, cfg.seed, step_i, 0))
        pending.append((m["loss"], occ_frac, m["fill"], m["rays_used"]))
        rays_candidate += bucket * cfg.batch_size
        estimator.observe(m["fill"], m["rays_used"])
        if march == "skip":
            tripped = policy.observe(m["complete_frac"])
            if tripped is not None:
                print(f"step {step_i}: {1 - tripped:.1%} of rays exhausted the skip-march round "
                      f"budget ({renderer.skip_steps}); dense marching until the next occupancy update")

        if len(pending) >= 64 or step_i == steps - 1:
            flush_pending()
            print(f"step {step_i + 1}/{steps}: loss {train_metrics[-1].loss:.5f}, "
                  f"occupancy {train_metrics[-1].occupancy:.4f}, bucket {bucket}, march {march}")

        if cfg.checkpoint_every and (step_i + 1) % cfg.checkpoint_every == 0:
            save_checkpoint(output, step_i + 1, _state(renderer, optimizer, occ_state, ckpt_meta))

        if (cfg.eval_every is not None and cfg.eval_n is not None and eval_set is not None
                and step_i > 0 and step_i % cfg.eval_every == 0):
            flush_pending()
            indices = [(eval_ptr + j) % len(eval_set) for j in range(cfg.eval_n)]
            rendered = infer(
                renderer, occ_state, eval_set, indices, output, f"eval_{step_i}",
                chunk=cfg.batch_size, render_chunk_fn=render_chunk_fn, packed_fn=packed_chunk_fn,
                grid_args=eval_grid_args(),
            )
            round_metrics = evaluate(eval_set, rendered, indices)
            eval_acc.extend(round_metrics)
            eval_timeline.append({
                "step": step_i,
                "elapsed_s": time.perf_counter() - t_start,
                "psnr": float(np.mean([x.psnr for x in round_metrics])),
                "ssim": float(np.mean([x.ssim for x in round_metrics])),
            })
            eval_ptr += cfg.eval_n

    if prof is not None:
        prof.stop()
        prof.export_chrome_trace(str(output / "trace.json"))
    flush_pending()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t_start
    # the headline rate counts only rays that reached the loss
    rays_per_sec = rays_used / max(elapsed, 1e-9)
    cand_rays_per_sec = rays_candidate / max(elapsed, 1e-9)

    test_metrics: Optional[List[EvalMetrics]] = None
    if test_set is not None:
        indices = list(range(len(test_set)))
        rendered = infer(
            renderer, occ_state, test_set, indices, output, "test_full",
            chunk=cfg.batch_size, render_chunk_fn=render_chunk_fn, packed_fn=packed_chunk_fn,
            grid_args=eval_grid_args(),
        )
        if test_set.rgbs is not None:
            test_metrics = evaluate(test_set, rendered, indices)

    save_checkpoint(output, steps, _state(renderer, optimizer, occ_state, ckpt_meta))
    _write_json(output / "metrics_train.json", [asdict(x) for x in train_metrics])
    if eval_acc:
        _write_json(output / "metrics_eval.json", [asdict(x) for x in eval_acc])
    if eval_timeline:
        _write_json(output / "eval_timeline.json", eval_timeline)
    if test_metrics:
        _write_json(output / "metrics_test.json", [asdict(x) for x in test_metrics])
    _write_json(output / "throughput.json", {
        "rays_per_sec_per_chip": rays_per_sec,
        "candidate_rays_per_sec_per_chip": cand_rays_per_sec,
        "elapsed_s": elapsed,
        "steps": steps - start_step,
        "n_devices": 1,
    })
    return {
        "renderer": renderer,
        "occ_state": occ_state,
        "train_metrics": train_metrics,
        "eval_metrics": eval_acc,
        "eval_timeline": eval_timeline,
        "test_metrics": test_metrics,
        "rays_per_sec_per_chip": rays_per_sec,
        "elapsed_s": elapsed,
    }


def _state(renderer, optimizer, occ_state, meta) -> dict:
    return {"params": params_to_numpy(renderer), "opt_state": optimizer.state(),
            "occ_state": occ_state_to_numpy(occ_state), "meta": meta}


def _write_json(path: Path, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)
