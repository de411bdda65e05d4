"""Training, inference and evaluation, on one device or over a
data-parallel group of processes (one device each).

Counterpart of `tinynerf_tpu/train/loop.py`: `build_renderer`, the
optimizer (`lr_schedule`, `_decay_mask`, the fused Adam), `make_train_step`,
`make_occupancy_update`, the bucket and march policies, `train`, and the
serving entry points (`make_render_chunk`, `make_render_chunk_packed`,
`infer`, `evaluate`, `render_only`).  Differences from the JAX module:

  * parameters live in the renderer's modules and the Adam state in the
    optimizer object, so the step and chunk functions take no `params`
    argument; checkpoints still hold both in the JAX layout (`convert.py`);
  * every function runs over a `parallel.DataGroup` (`group`, one process
    per device, the JAX mesh's counterpart): each rank keeps its 1/N of the
    ray pool, samples and packs 1/N of a step's rays with 1/N of the
    sample cap, and the step all-reduces the loss pieces and the gradients
    (`shard_tables`: reduce-scatters the table gradients, keeps 1/N of the
    tables' Adam moments and all-gathers the updated tables; `shard_bwd`:
    splits the K-Planes pullback by row bands); serving splits each chunk's
    rays over the ranks and gathers the results; only rank 0 writes files.
    One device is a group of one rank with no process group
    (`parallel.single`), whose collectives are identities; `group=None`
    means that group on the caller's `device` (the renderer's);
  * PyTorch runs eagerly, so a "compiled step" is a closure, and the random
    streams are `torch.Generator`s seeded from (seed, step), and the batch
    stream from the rank as well, so a resumed run continues its stream as
    the JAX one does with `fold_in`;
  * as in the JAX package, `render_only` serves with the skip march
    whenever the renderer supports it, and `train` switches to it through
    `MarchPolicy` once the demand estimate leaves ample round budget; the
    skip grid is rebuilt at every occupancy update and never checkpointed.
"""

from __future__ import annotations

import contextlib
import functools
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
from ..parallel import zero
from ..parallel.mesh import DataGroup, shard_rays, single
from ..utils.image import save_png
from ..utils.trace import span
from .checkpoint import ScaleByAdamState, latest_checkpoint, load_checkpoint, save_checkpoint
from .config import TrainConfig
from .metrics import EvalMetrics, TrainMetrics, eval_metrics


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
    format (`state` / `load_state`).

    With `group` and `sharded_tree` (ZeRO-1, `parallel/zero.py`; the JAX
    `init_opt_state` on a sharded-table mesh), the sharded leaves' moments
    are this rank's [Lp / N] slices of their flat views, `step` takes those
    leaves' gradients as the same slices (the reduce-scattered view),
    updates this rank's slice of the parameter and all-gathers the full
    table back, and `state` / `load_state` exchange the JAX global view
    (flat [Lp] moments)."""

    def __init__(self, tree: dict, schedule, eps: float, weight_decay: float,
                 decay_tree: dict, table_ratio: float, table_tree: dict,
                 b1: float = 0.9, b2: float = 0.999,
                 group: Optional[DataGroup] = None, sharded_tree: Optional[dict] = None):
        leaves = list(tree_leaves_with_path(tree))
        self.tree = tree
        self.paths = [path for path, _ in leaves]
        self.params = [t for _, t in leaves]
        decay = dict(tree_leaves_with_path(decay_tree))
        table = dict(tree_leaves_with_path(table_tree))
        self.decay = [bool(decay[path]) for path in self.paths]
        self.table = [bool(table[path]) for path in self.paths]
        sharded = dict(tree_leaves_with_path(sharded_tree)) if sharded_tree is not None else {}
        self.sharded = [bool(sharded.get(path, False)) for path in self.paths]
        self.group = group
        self.schedule, self.eps, self.weight_decay = schedule, eps, weight_decay
        self.table_ratio, self.b1, self.b2 = table_ratio, b1, b2
        self.count = 0
        self.mu = [self._zero_moment(p, sh) for p, sh in zip(self.params, self.sharded)]
        self.nu = [self._zero_moment(p, sh) for p, sh in zip(self.params, self.sharded)]

    def _zero_moment(self, p: torch.Tensor, sharded: bool) -> torch.Tensor:
        if not sharded:
            return torch.zeros_like(p)
        return p.new_zeros(zero.padded_len(p.numel(), self.group.world) // self.group.world)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update from `grads` (aligned with the parameters; a sharded
        leaf's gradient is this rank's flat slice)."""
        targets = self.params
        if any(self.sharded):
            targets = [zero.local_slice(p, self.group.world, self.group.rank) if sh else p
                       for p, sh in zip(self.params, self.sharded)]
        lr = self.schedule(self.count)
        self.count += 1
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(self.count))
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(self.count))
        grads = list(grads)
        if self.weight_decay != 0.0:
            for i, dec in enumerate(self.decay):
                if dec:
                    grads[i] = grads[i] + self.weight_decay * targets[i]
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
        torch._foreach_add_(targets, upd)
        for p, t, sh in zip(self.params, targets, self.sharded):
            if sh:
                p.view(-1).copy_(self.group.all_gather(t)[: p.numel()])

    def as_tree(self, leaves: Sequence) -> dict:
        """`leaves` (aligned with the parameters) in the parameters' layout."""
        by_path = dict(zip(self.paths, leaves))
        return tree_map_with_path(lambda path, _: by_path[path], self.tree)

    def state(self) -> ScaleByAdamState:
        """{count, mu, nu} as numpy, in the JAX package's layout (sharded
        moments all-gathered into their flat [Lp] global view: every rank of
        the group calls this together)."""

        def full(moments):
            return [to_numpy(self.group.all_gather(t) if sh else t) for t, sh in zip(moments, self.sharded)]

        return ScaleByAdamState(
            count=np.asarray(self.count, np.int32),
            mu=self.as_tree(full(self.mu)),
            nu=self.as_tree(full(self.nu)),
        )

    def load_state(self, state) -> None:
        """Load {count, mu, nu} written by either package (sharded moments
        from their flat [Lp] global view: this rank takes its slice)."""
        mu = dict(tree_leaves_with_path(state.mu))
        nu = dict(tree_leaves_with_path(state.nu))
        with torch.no_grad():
            for i, path in enumerate(self.paths):
                for dst, src in ((self.mu[i], mu[path]), (self.nu[i], nu[path])):
                    src = np.asarray(src, np.float32)
                    want = tuple(dst.shape)
                    if self.sharded[i]:
                        want = (dst.shape[0] * self.group.world,)
                    if tuple(src.shape) != want:
                        raise ValueError(f"optimizer state {path}: {src.shape} does not fit {want}")
                    if self.sharded[i]:
                        src = src[self.group.rank * dst.shape[0] : (self.group.rank + 1) * dst.shape[0]]
                    dst.copy_(torch.from_numpy(src.copy()))
        self.count = int(np.asarray(state.count))


def make_optimizer(cfg: TrainConfig, renderer: NerfRenderer, group: Optional[DataGroup] = None) -> FusedAdam:
    """Adam + L2-in-grad weight decay (masked off the feature tables) + the
    piecewise-constant schedule + the split table lr, over the renderer's
    parameters, as `tinynerf_tpu/train/loop.py:make_optimizer`, with its
    initial state as `init_opt_state` makes it: the tables' moments sharded
    over `group` with `cfg.shard_tables` on a group of several ranks and a
    field that declares tables, else whole."""
    group = _group_of(renderer, group)
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
    sharded_tree = None
    if _zero_sharded(cfg, renderer, group):
        sharded_tree = zero.table_mask_tree(tree, frozenset(renderer.field.table_keys))
    return FusedAdam(tree, lr_schedule(cfg), cfg.adam_eps, cfg.weight_decay,
                     decay_tree, ratio, table_tree, group=group, sharded_tree=sharded_tree)


def _zero_sharded(cfg: TrainConfig, renderer: NerfRenderer, group: DataGroup) -> bool:
    """The JAX rule for the sharded-table (ZeRO-1) step: `shard_tables`, a
    group of several ranks and a field with declared tables; on one rank
    `shard_tables` changes nothing."""
    return (cfg.shard_tables and group.world > 1
            and zero.has_tables(param_tree(renderer), frozenset(renderer.field.table_keys)))


def _renderer_device(renderer: NerfRenderer) -> torch.device:
    return next(renderer.parameters()).device


def _group_of(renderer: NerfRenderer, group: Optional[DataGroup]) -> DataGroup:
    """`group`, or for None one rank on the renderer's device."""
    return group or single(_renderer_device(renderer))


# ---------------------------------------------------------------- train step


def make_train_step(
    renderer: NerfRenderer,
    optimizer: FusedAdam,
    cfg: TrainConfig,
    n_cand: int,
    deterministic: bool = False,
    march: str = "dense",
    group: Optional[DataGroup] = None,
) -> Callable:
    """One train step for `n_cand` candidate rays over `group` (no group:
    one rank on the renderer's device), as `tinynerf_tpu/train/loop.py:
    make_train_step` on a mesh, and `_make_zero_step`:
    fn(occ_state, pool_o, pool_d, pool_rgb, generator) -> metrics, a dict of
    the group's device scalars (loss, rays_used, fill over the global cap,
    complete_frac of the global candidates); with `march="skip"` the step
    takes the skip grid (`renderer.skip_grid`, rebuilt at each occupancy
    update) right after occ_state.  `pool_*` are this rank's shard of the
    pool.

    Each rank samples n_cand / N rays from its shard and four seed words
    from `generator` (two for the sample jitter, two for a field's dropout
    mask), packs them with cap / N samples and renders them on the chosen
    march.  One all-reduce sums the per-ray MSE numerator over rays that fit
    the cap, its denominator, the sample and complete-ray counts and the
    ranks' shares of the field's TV / L1 regularizer (K-Planes').  Each rank
    then takes one gradient of its objective, numerator times
    1 / max(global den, 1) plus its share, and

      * replicated: rank 0's share is the whole regularizer and the other
        ranks' none, and the gradients are all-reduced;
      * `shard_tables` (a group of several ranks and a field with tables):
        the share is this rank's row block (`loss_tv_partial`), table
        gradients are reduce-scattered to this rank's flat slice and the
        others all-reduced (`zero.reduce_grads`), and Adam updates the
        slices and all-gathers the tables (`FusedAdam`);
      * `shard_bwd` with `shard_tables` on a K-Planes field: the field's
        backward splits its pullback over the ranks (`shard_bwd_group`), and
        its per-rank table gradients are partials the reduction completes.

    On one rank with no process group every collective is an identity: the
    step is the one-device step.

    `deterministic=True` (tests) takes the shard's first n_cand / N rays with
    no jitter and no dropout (the JAX step's `krender=None`), and adds the
    reduced gradients (JAX layout, the update's input) to the metrics: the
    JAX package's seam for comparing steps."""
    group = _group_of(renderer, group)
    world, rank = group.world, group.rank
    if n_cand % world or cfg.sample_cap % world:
        raise ValueError(f"candidate rays {n_cand} and sample cap {cfg.sample_cap} must divide "
                         f"the group's {world} ranks")
    if march not in ("dense", "skip"):
        raise ValueError(f"unknown march {march!r}")
    local_cand, local_cap = n_cand // world, cfg.sample_cap // world
    use_skip = march == "skip"
    field_ = renderer.field
    table_keys = frozenset(field_.table_keys)
    sharded = _zero_sharded(cfg, renderer, group)
    if sharded != any(optimizer.sharded):
        raise ValueError("the optimizer's state layout does not fit this step: build it with "
                         "make_optimizer(cfg, renderer, group)")
    bwd_group = group if (sharded and cfg.shard_bwd and hasattr(field_, "shard_bwd_group")) else None
    has_reg = hasattr(field_, "loss_tv") and (cfg.tv_reg_alpha != 0.0 or cfg.l1_reg_alpha != 0.0)
    params = optimizer.params

    def reg_share() -> Optional[torch.Tensor]:
        # the ranks' shares sum to the group's regularizer, and so their
        # gradients to its gradient
        if sharded:
            loss_tv = functools.partial(field_.loss_tv_partial, rank, world)
            loss_l1 = functools.partial(field_.loss_l1_partial, rank, world)
        elif rank == 0:
            loss_tv, loss_l1 = field_.loss_tv, field_.loss_l1
        else:
            return None
        reg = cfg.tv_reg_alpha * loss_tv()
        if cfg.l1_reg_alpha != 0.0:
            reg = reg + cfg.l1_reg_alpha * loss_l1()
        return reg

    def collective():
        # the span of a collective that a process group runs
        return span("train_step.all_reduce") if group.grouped else contextlib.nullcontext()

    def step(occ_state, *rest):
        with span("train_step"):
            return body(occ_state, *rest)

    def body(occ_state, *rest):
        skip_grid = rest[0] if use_skip else None
        pool_o, pool_d, pool_rgb, *gen = rest[1:] if use_skip else rest
        with span("train_step.batch"):
            if deterministic:
                rays_o, rays_d, rgbs = pool_o[:local_cand], pool_d[:local_cand], pool_rgb[:local_cand]
                jitter_seed = dropout_seed = None
            else:
                rays_o, rays_d, rgbs = sample_ray_batch(gen[0], pool_o, pool_d, pool_rgb, local_cand)
                words = torch.randint(0, 2**32, (4,), generator=gen[0], device=pool_o.device)
                jitter_seed, dropout_seed = words[:2], words[2:]
        if bwd_group is not None:
            field_.shard_bwd_group = bwd_group
        try:
            out = renderer.render_packed(occ_state, rays_o, rays_d, local_cap,
                                         jitter_seed=jitter_seed, dropout_seed=dropout_seed,
                                         march=march, skip_grid=skip_grid)
            with span("train_step.loss"):
                per_ray_mse = torch.mean((out.rgb - rgbs) ** 2, dim=-1)
                num = torch.sum(per_ray_mse * out.ray_valid)
                den = torch.sum(out.ray_valid)
                reg = reg_share() if has_reg else None
                # [num, den, samples, complete rays, regularizer share]: one sum
                pieces = [num.detach(), den, out.n_samples.float(), out.n_complete.float()]
                if has_reg:
                    pieces.append(torch.zeros_like(den) if reg is None else reg.detach())
                stats = torch.stack(pieces)
            with collective():
                group.all_reduce_sum(stats)
            scale = 1.0 / torch.clamp(stats[1], min=1.0)
            objective = num * scale
            if reg is not None:
                objective = objective + reg
            with span("train_step.backward"):
                grads = torch.autograd.grad(objective, params, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        finally:
            if bwd_group is not None:
                field_.shard_bwd_group = None
        # the ranks' objectives sum to the group's loss: one rank's is it
        if world == 1:
            loss = objective.detach()
        else:
            loss = stats[0] * scale
            if has_reg:
                loss = loss + stats[4]
        if sharded:
            with collective():
                gview = [v for _, v in tree_leaves_with_path(
                    zero.reduce_grads(optimizer.as_tree(grads), table_keys, group))]
            with span("train_step.adam"):
                optimizer.step(gview)
            if deterministic:
                with collective():
                    full = zero.unview(optimizer.as_tree(gview), optimizer.tree, table_keys, group)
        else:
            with collective():
                grads = [group.all_reduce_sum(g) for g in grads]
            with span("train_step.adam"):
                optimizer.step(grads)
            if deterministic:
                full = optimizer.as_tree(grads)
        metrics = {"loss": loss, "rays_used": stats[1], "fill": stats[2] / cfg.sample_cap,
                   "complete_frac": stats[3] / n_cand}
        if deterministic:
            metrics["grads"] = full
        return metrics

    return step


def make_occupancy_update(renderer: NerfRenderer, group: Optional[DataGroup] = None) -> Callable:
    """fn(occ_state, generator) -> the state after one decay/confirm sweep.

    Every rank draws the same full jitter from the same stream, sweeps its
    contiguous x-slab (`OccupancyGrid.update_slab`), and the slabs are
    all-gathered once, so every rank holds the one-rank sweep's grid.  The
    grid is one slab, swept whole and gathered from nowhere, on one rank and
    where the group's world size does not divide the grid's x-resolution
    (the JAX mesh update asks that it divide)."""
    occ = renderer.occupancy
    group = _group_of(renderer, group)
    n_slabs = group.world if occ.size[0] % group.world == 0 else 1
    slab = group.rank if n_slabs > 1 else 0

    def update(occ_state, generator=None):
        with span("occupancy.sweep"):
            jitter = torch.rand((*occ.size, 3), generator=generator, device=occ_state.grid.device)
            grid = occ.update_slab(occ_state, renderer.sigma_fn, jitter, slab, n_slabs)
            if n_slabs > 1:
                grid = group.all_gather(grid)
            return OccupancyState(grid=grid, mean=grid.mean())

    return update


def make_render_chunk(renderer: NerfRenderer, group: Optional[DataGroup] = None) -> Callable:
    """Dense render of one ray chunk: fn(occ_state, rays_o, rays_d) -> rgb.
    Over a `group` with a process group (whose world size divides the
    chunk) each rank renders its 1/N of the rays and every rank gets the
    gathered chunk."""
    group = _group_of(renderer, group)

    def render_chunk(occ_state, rays_o, rays_d):
        return renderer.render_dense(occ_state, rays_o, rays_d).rgb

    def render_chunk_sharded(occ_state, rays_o, rays_d):
        return group.all_gather(render_chunk(occ_state, *shard_rays(group, rays_o, rays_d)))

    return render_chunk_sharded if group.grouped else render_chunk


def packed_graph_key(renderer: NerfRenderer, cap: int, march: str, occ_state, rays_o: torch.Tensor,
                     grid: Tuple) -> tuple:
    """What a captured packed chunk fixes: the rays' shape, dtype and
    device, the cap, the march, the TF32 flag of the matrix products, the
    renderer's options that the forward reads, and the storage a replay
    reads by address: the skip grid's (the occupancy state's on the dense
    march) and every parameter's.  A value written in place there is read
    by the replay; a tensor replaced, or an option changed, changes the key.
    The field's, the marcher's and the contraction's options, fixed when
    they are built, are read at capture."""
    if march == "skip":
        state = (grid[0].data_ptr(), tuple(grid[0].shape))
    elif occ_state is not None:
        state = (occ_state.grid.data_ptr(), tuple(occ_state.grid.shape), occ_state.mean.data_ptr())
    else:
        state = None
    bg = None if renderer.bg_color is None else tuple(renderer.bg_color)
    options = (renderer.skip_steps, renderer.compute_dtype, renderer.remat_field, renderer.early_termination, bg)
    return (tuple(rays_o.shape), rays_o.dtype, rays_o.device, cap, march,
            torch.backends.cuda.matmul.allow_tf32, options, state,
            tuple(p.data_ptr() for p in renderer.parameters()))


class _ChunkGraph:
    """One packed chunk captured as a CUDA graph: the rays copied into
    static inputs, the graph replayed, clones of its static outputs
    returned (a caller may queue many chunks before reading any).  A replay
    launches through no kernel wrapper, so the wrappers' launch counters
    count the capture and not the replays."""

    def __init__(self, render: Callable, key: tuple, occ_state, rays_o, rays_d, grid: Tuple):
        self.key = key
        with torch.inference_mode(False):  # written in place by every later call
            self.rays_o, self.rays_d = rays_o.clone(), rays_d.clone()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outs = render(occ_state, self.rays_o, self.rays_d, *grid)
        # cuBLAS made a 32 MiB workspace for the capture stream, which it
        # would keep allocated for the life of the process.  Freed here, it
        # stays reserved in the graph's private pool, where the replays use
        # it: the pool's reserved bytes, and not the allocated ones, hold
        # the serving chunk's working memory
        torch._C._cuda_clearCublasWorkspaces()

    def __call__(self, rays_o: torch.Tensor, rays_d: torch.Tensor) -> tuple:
        self.rays_o.copy_(rays_o)
        self.rays_d.copy_(rays_d)
        self.graph.replay()
        return tuple(t.clone() for t in self.outs)


def make_render_chunk_packed(renderer: NerfRenderer, cap: int, march: str = "dense",
                             group: Optional[DataGroup] = None) -> Callable:
    """Fixed-capacity packed render of one ray chunk, the serving path, with
    the skip march when `march="skip"` (the skip grid is then the trailing
    argument): fn(occ_state, rays_o, rays_d, *grid) -> (rgb [R, 3], ok [R]
    bool, n_samples, n_complete).  ok=False rays overflowed the cap or
    exhausted the skip march's rounds; `infer` re-renders exactly those
    through the dense path, so packed serving is exact.  Over a `group`
    with a process group (whose world size divides the chunk and `cap`)
    each rank packs its 1/N of the rays into cap / N samples, and every rank
    gets the gathered colors and flags and the summed counts.

    Without a process group, on CUDA rays and with grad mode off, the chunk
    runs as one CUDA graph: the first call for a `packed_graph_key` runs
    eagerly (its result is returned) and captures the graph, every later
    call with that key replays it, bit for bit the eager chunk.  One graph
    is kept, the last key's, until `fn.release()` drops it and its memory
    pool.  `fn.captures` and `fn.replays` count both.  Anything else (the
    CPU, a group's collectives, gradients) runs eagerly."""
    if march not in ("dense", "skip"):
        raise ValueError(f"unknown march {march!r}")
    group = _group_of(renderer, group)
    if cap % group.world:
        raise ValueError(f"eval cap {cap} does not split over {group.world} ranks")
    local_cap = cap // group.world

    def render(occ_state, rays_o, rays_d, *grid):
        out = renderer.render_packed(occ_state, rays_o, rays_d, local_cap, rgb_dir_branch="ray",
                                     march=march, skip_grid=grid[0] if grid else None)
        return out.rgb, out.ray_valid > 0.0, out.n_samples, out.n_complete

    if group.grouped:
        def render_sharded(occ_state, rays_o, rays_d, *grid):
            rgb, ok, n_samples, n_complete = render(occ_state, *shard_rays(group, rays_o, rays_d), *grid)
            both = group.all_gather(torch.cat([rgb, ok.float()[:, None]], dim=1))
            counts = group.all_reduce_sum(torch.stack([n_samples, n_complete]).long())
            return both[:, :3], both[:, 3] > 0.0, counts[0], counts[1]

        return render_sharded

    live: List[_ChunkGraph] = []  # the last key's graph

    def release() -> None:
        if live:
            torch.cuda.synchronize(live[0].rays_o.device)  # no replay of the graph still queued
            live.clear()

    def render_graphed(occ_state, rays_o, rays_d, *grid):
        if not rays_o.is_cuda or torch.is_grad_enabled():
            return render(occ_state, rays_o, rays_d, *grid)
        key = packed_graph_key(renderer, local_cap, march, occ_state, rays_o, grid)
        if live and live[0].key == key:
            render_graphed.replays += 1
            return live[0](rays_o, rays_d)
        release()
        out = render(occ_state, rays_o, rays_d, *grid)  # the warm-up
        live.append(_ChunkGraph(render, key, occ_state, rays_o, rays_d, grid))
        render_graphed.captures += 1
        return out

    render_graphed.captures = render_graphed.replays = 0
    render_graphed.release = release
    return render_graphed


@dataclass
class InferStats:
    """What `infer` did: per image its rendering (float, before the PNG's
    8-bit rounding), seconds on the host clock (synchronized) and ray count;
    in total the packed samples, the rays re-rendered densely, the rays
    whose skip march ran out of rounds (padding rays included), and the
    packed chunks captured as a CUDA graph and replayed from one; and
    `render_only`'s skip-grid build, seconds (synchronized)."""

    images: List[np.ndarray] = field(default_factory=list)
    seconds: List[float] = field(default_factory=list)
    rays: List[int] = field(default_factory=list)
    packed_samples: int = 0
    fallback_rays: int = 0
    incomplete_rays: int = 0
    graph_captures: int = 0
    graph_replays: int = 0
    skip_grid_seconds: float = 0.0


def _graph_counts(packed_fn: Optional[Callable]) -> Tuple[int, int]:
    """(captures, replays) of a packed chunk function; (0, 0) for one that
    never captures (a group's, or none)."""
    return getattr(packed_fn, "captures", 0), getattr(packed_fn, "replays", 0)


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
    write: bool = True,
) -> List[np.ndarray]:
    """Render full images pose by pose in fixed-size ray chunks on the
    renderer's device and save `{name}_{i:04d}.png` (unless `write` is
    False: the ranks but 0 of a group).  With `packed_fn` (and its trailing
    `grid_args`), the rays it flags (cap overflow, skip-march rounds
    exhausted) are re-rendered by `render_chunk_fn` (dense), gathered over
    the image into chunks of the same shape (the JAX `infer` re-renders per
    packed chunk; every ray's value is the same either way).  Sharded chunk
    functions gather every chunk to every rank, so all ranks flag the same
    rays and call the dense chunks in lockstep."""
    if render_chunk_fn is None:
        render_chunk_fn = make_render_chunk(renderer)
    device = _renderer_device(renderer)
    folder = Path(folder)
    if write:
        folder.mkdir(parents=True, exist_ok=True)
    pad_d = torch.tensor([0.0, 0.0, 1.0], device=device)

    rendered: List[np.ndarray] = []
    for i in indices:
        t0 = time.perf_counter()
        with span("serve.view"):
            item = dataset[i]
            K = dataset.img_intrinsics(i)
            with span("serve.upload"):
                rays_o = torch.from_numpy(np.asarray(item["rays_o"], np.float32).reshape(-1, 3))
                rays_d = torch.from_numpy(np.asarray(item["rays_d"], np.float32).reshape(-1, 3))
                n = rays_o.shape[0]
                n_pad = (-n) % chunk
                rays_o = torch.cat([rays_o.to(device), torch.zeros(n_pad, 3, device=device)])
                rays_d = torch.cat([rays_d.to(device), pad_d.expand(n_pad, 3)])
            with torch.inference_mode():
                # queue every chunk before reading any back (the host then
                # waits once per chunk for its overflow flags, not per launch)
                chunks = []
                graphs = _graph_counts(packed_fn)
                with span("serve.enqueue"):
                    for k in range(0, rays_o.shape[0], chunk):
                        o_c, d_c = rays_o[k : k + chunk], rays_d[k : k + chunk]
                        if packed_fn is not None:
                            chunks.append((*packed_fn(occ_state, o_c, d_c, *grid_args), o_c, d_c))
                        else:
                            chunks.append((render_chunk_fn(occ_state, o_c, d_c), None, None, None, o_c, d_c))
                if stats is not None:
                    captures, replays = (b - a for a, b in zip(graphs, _graph_counts(packed_fn)))
                    stats.graph_captures += captures
                    stats.graph_replays += replays
                outs, bad_o, bad_d, bad_at = [], [], [], []
                for k, (rgb, ok, n_samples, n_complete, o_c, d_c) in enumerate(chunks):
                    if ok is not None:
                        with span("serve.readback"):
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
                    with span("serve.fallback"):
                        o_b, d_b, at = torch.cat(bad_o), torch.cat(bad_d), torch.cat(bad_at)
                        for a in range(0, at.numel(), chunk):
                            nb = min(chunk, at.numel() - a)
                            o_p = torch.zeros(chunk, 3, device=device)
                            d_p = pad_d.expand(chunk, 3).clone()
                            o_p[:nb], d_p[:nb] = o_b[a : a + nb], d_b[a : a + nb]
                            flat[at[a : a + nb]] = render_chunk_fn(occ_state, o_p, d_p)[:nb]
                with span("serve.image"):
                    img = flat[:n].reshape(K.h, K.w, 3).cpu().numpy()
        if stats is not None:
            stats.seconds.append(time.perf_counter() - t0)
            stats.rays.append(n)
            stats.images.append(img)
        rendered.append(img)
        if write:
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
    group: Optional[DataGroup] = None,
) -> Optional[List[EvalMetrics]]:
    """Render `pose_set` from the latest checkpoint in cfg.output (the CLI's
    `--render_only`) on `device`, or on every rank of `group` in lockstep
    (each chunk split over the ranks where its sizes divide, as the JAX
    package splits it over the mesh).  Writes `{name}_{i:04d}.png` per pose
    and, with ground truth, `metrics_render.json` (rank 0); returns the
    per-image metrics (None without ground truth)."""
    group = group or single(device)
    device = group.device
    lead = group.rank == 0
    output = Path(cfg.output)
    ck = latest_checkpoint(output)
    if ck is None:
        raise FileNotFoundError(f"no checkpoint found under {output}")
    step, state = load_checkpoint(ck)
    if lead:
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
    chunk_group, packed_group = _serving_groups(cfg, group)
    packed_fn = None
    grid_args: Tuple = ()
    if cfg.eval_render == "packed":
        can_skip = renderer.supports_skip_march
        packed_fn = make_render_chunk_packed(
            renderer, cfg.batch_size * cfg.eval_samples_per_ray, march="skip" if can_skip else "dense",
            group=packed_group)
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
        chunk=cfg.batch_size, render_chunk_fn=make_render_chunk(renderer, chunk_group),
        packed_fn=packed_fn, stats=stats, grid_args=grid_args, write=lead,
    )
    if pose_set.rgbs is None:
        return None
    metrics = evaluate(pose_set, rendered, indices)
    if lead:
        _write_json(output / "metrics_render.json", [asdict(x) for x in metrics])
        psnrs = [m.psnr for m in metrics]
        print(f"rendered {len(metrics)} poses: psnr {np.mean(psnrs):.2f} "
              f"(min {np.min(psnrs):.2f}, max {np.max(psnrs):.2f})")
    return metrics


def _serving_groups(cfg: TrainConfig, group: DataGroup) -> Tuple:
    """(dense chunk group, packed chunk group): `group` where the chunk (and
    the packed path's eval cap) split over its ranks, else this rank alone
    (it renders whole chunks), as the JAX package picks its mesh."""
    alone = single(group.device)
    if cfg.batch_size % group.world:
        return alone, alone
    eval_cap = cfg.batch_size * cfg.eval_samples_per_ray
    return group, (group if eval_cap % group.world == 0 else alone)


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
        with span("train.readback"):
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
        with span("train.readback"):
            val = float(prev)
        if val < self.COMPLETE_MIN:
            self.suspended = True
            self._pending = None
            return val
        return None


# ---------------------------------------------------------------------- train


def _generator(device, seed: int, step: int, stream: int, rank: int = 0) -> torch.Generator:
    """The random stream `stream` of step `step` (0: batch and jitter, 1:
    occupancy jitter), a function of (seed, step) so a resumed run goes on
    with the streams of the steps it has not taken; rank r > 0 of a group
    folds r into the top bits (the JAX step's `fold_in(key, axis_index)`),
    and rank 0 keeps the one-device stream."""
    base = ((seed * 1_000_003 + step) << 1) | stream
    return torch.Generator(device=device).manual_seed((base ^ (rank << 56)) & (2**64 - 1))


def train(
    cfg: TrainConfig,
    train_rays: RayPool,
    eval_set: Optional[PoseSet] = None,
    test_set: Optional[PoseSet] = None,
    resume: bool = False,
    device="cuda",
    group: Optional[DataGroup] = None,
) -> Dict[str, object]:
    """Full training run on `device`, or over the ranks of `group` (each on
    its own device, all in lockstep); returns {renderer, occ_state,
    metrics, the steps each march took and the first skip-march step}.

    Writes, as the JAX `train` does: `metrics_train.json` (one record per
    step), `metrics_eval.json` / `eval_timeline.json` / `metrics_test.json`
    when evaluating, `throughput.json`, `ckpt_{step}.pkl` (every
    `checkpoint_every` steps and at the end; params, Adam state and
    occupancy state in the JAX layout, and the meta {"shard_tables",
    "n_devices"}) and the rendered PNGs; over a group only rank 0 writes,
    and the others wait for it at a barrier.  With `resume` it continues
    from the latest checkpoint in cfg.output; a checkpoint written with
    `shard_tables` holds its optimizer state in the layout of its group
    size, so resuming it needs the same size and setting (the JAX check).

    Over a group every rank keeps its 1/N of the pool (padded by repeating
    its head), samples its 1/N of each step's rays from a batch stream
    folded with its rank, sweeps its x-slab of the occupancy grid from the
    shared occupancy stream, and renders its 1/N of each serving chunk."""
    group = group or single(device)
    device, n_dev, rank = group.device, group.world, group.rank
    lead = rank == 0
    output = Path(cfg.output)
    output.mkdir(parents=True, exist_ok=True)
    steps = cfg.total_steps
    renderer = build_renderer(
        cfg, train_rays.scene_scale,
        np.asarray(train_rays.bg_color) if train_rays.bg_color is not None else None,
        device=device,
    )
    optimizer = make_optimizer(cfg, renderer, group)
    pool_o, pool_d, pool_rgb = shard_rays(group, *train_rays.arrays())
    occ_state = renderer.occupancy.init_state(device)
    start_step = 0
    # the sharded optimizer state is laid out per group size
    ckpt_meta = {"shard_tables": bool(cfg.shard_tables), "n_devices": n_dev}

    if resume:
        ck = latest_checkpoint(output)
        if ck is not None:
            start_step, state = load_checkpoint(ck)
            saved = state.get("meta")
            if saved is not None and (
                saved.get("shard_tables") != ckpt_meta["shard_tables"]
                or (saved.get("shard_tables") and saved.get("n_devices") != ckpt_meta["n_devices"])
            ):
                raise ValueError(
                    f"checkpoint {ck} was written with {saved} but this run uses {ckpt_meta}; "
                    "shard_tables checkpoints hold an optimizer layout of their device count: "
                    "resume with the same device count and --shard_tables setting")
            load_params(renderer, state["params"])
            optimizer.load_state(state["opt_state"])
            occ_state = occ_state_to_torch(state["occ_state"], device)
            if lead:
                print(f"Resumed from {ck} at step {start_step}")

    n_params = sum(p.numel() for p in optimizer.params)
    if lead:
        print(f"Using {cfg.method} with {n_params} parameters on {device}"
              + (f" and {n_dev - 1} more rank(s) ({group.backend})." if n_dev > 1 else "."))

    steps_by_key: Dict[Tuple[int, str], Callable] = {}

    def get_step(bucket: int, march: str) -> Callable:
        if (bucket, march) not in steps_by_key:
            steps_by_key[bucket, march] = make_train_step(
                renderer, optimizer, cfg, n_cand=bucket * cfg.batch_size, march=march, group=group)
        return steps_by_key[bucket, march]

    policy = MarchPolicy(renderer.supports_skip_march, cfg.march, renderer.skip_steps)
    skip_grid = renderer.skip_grid(occ_state) if policy.can_skip else None
    occ_update = make_occupancy_update(renderer, group)
    chunk_group, packed_group = _serving_groups(cfg, group)
    render_chunk_fn = make_render_chunk(renderer, chunk_group)
    packed_chunk_fn = None
    if cfg.eval_render == "packed":
        packed_chunk_fn = make_render_chunk_packed(
            renderer, cfg.batch_size * cfg.eval_samples_per_ray,
            march="skip" if policy.can_skip else "dense", group=packed_group)

    def eval_grid_args() -> Tuple:
        # the skip grid current at eval time (rebuilt at occupancy updates)
        return (skip_grid,) if packed_chunk_fn is not None and policy.can_skip else ()

    def checkpoint(step: int) -> None:
        state = _state(renderer, optimizer, occ_state, ckpt_meta)  # every rank: gathers moments
        if lead:
            save_checkpoint(output, step, state)
        group.barrier()

    train_metrics: List[TrainMetrics] = []
    eval_acc: List[EvalMetrics] = []
    eval_timeline: List[Dict[str, float]] = []
    pending: List[Tuple] = []  # (loss, occupancy, fill, rays_used) device scalars
    estimator = BucketEstimator(cfg)
    eval_ptr = 0
    # the steps each march took, and the first that took the skip march
    march_steps = {"dense": 0, "skip": 0}
    first_skip_step: Optional[int] = None
    rays_candidate = 0.0
    rays_used = 0.0
    t_start = time.perf_counter()

    def flush_pending():
        nonlocal rays_used
        if not pending:
            return
        # one device -> host copy for the whole batch of scalars
        with span("train.readback"):
            host = torch.stack([torch.stack([v.float() for v in rec]) for rec in pending]).cpu()
        for loss_v, occ_v, _, rays_v in host.tolist():
            train_metrics.append(TrainMetrics(loss=loss_v, occupancy=occ_v))
            rays_used += rays_v
        pending.clear()

    occ_frac = renderer.occupancy.occupancy(occ_state)
    prof = None
    for step_i in range(start_step, steps):
        if cfg.profile_start is not None and lead:
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
        march_steps[march] += 1
        if march == "skip" and first_skip_step is None:
            first_skip_step = step_i
        grid_args = (skip_grid,) if march == "skip" else ()
        m = get_step(bucket, march)(occ_state, *grid_args, pool_o, pool_d, pool_rgb,
                                    _generator(device, cfg.seed, step_i, 0, rank))
        pending.append((m["loss"], occ_frac, m["fill"], m["rays_used"]))
        rays_candidate += bucket * cfg.batch_size
        estimator.observe(m["fill"], m["rays_used"])
        if march == "skip":
            tripped = policy.observe(m["complete_frac"])
            if tripped is not None and lead:
                print(f"step {step_i}: {1 - tripped:.1%} of rays exhausted the skip-march round "
                      f"budget ({renderer.skip_steps}); dense marching until the next occupancy update")

        if len(pending) >= 64 or step_i == steps - 1:
            flush_pending()
            if lead:
                print(f"step {step_i + 1}/{steps}: loss {train_metrics[-1].loss:.5f}, "
                      f"occupancy {train_metrics[-1].occupancy:.4f}, bucket {bucket}, march {march}")

        if cfg.checkpoint_every and (step_i + 1) % cfg.checkpoint_every == 0:
            checkpoint(step_i + 1)

        if (cfg.eval_every is not None and cfg.eval_n is not None and eval_set is not None
                and step_i > 0 and step_i % cfg.eval_every == 0):
            flush_pending()
            indices = [(eval_ptr + j) % len(eval_set) for j in range(cfg.eval_n)]
            rendered = infer(
                renderer, occ_state, eval_set, indices, output, f"eval_{step_i}",
                chunk=cfg.batch_size, render_chunk_fn=render_chunk_fn, packed_fn=packed_chunk_fn,
                grid_args=eval_grid_args(), write=lead,
            )
            release = getattr(packed_chunk_fn, "release", None)
            if release is not None:
                release()  # training does not carry the eval's graph and its pool
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
    # the headline rate counts only rays that reached the loss; over a group
    # the counts are the group's, so each chip's share divides them by N
    rays_per_sec = rays_used / max(elapsed, 1e-9) / n_dev
    cand_rays_per_sec = rays_candidate / max(elapsed, 1e-9) / n_dev

    test_metrics: Optional[List[EvalMetrics]] = None
    if test_set is not None:
        indices = list(range(len(test_set)))
        rendered = infer(
            renderer, occ_state, test_set, indices, output, "test_full",
            chunk=cfg.batch_size, render_chunk_fn=render_chunk_fn, packed_fn=packed_chunk_fn,
            grid_args=eval_grid_args(), write=lead,
        )
        if test_set.rgbs is not None:
            test_metrics = evaluate(test_set, rendered, indices)

    checkpoint(steps)
    if lead:
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
            "n_devices": n_dev,
        })
    group.barrier()
    return {
        "renderer": renderer,
        "occ_state": occ_state,
        "train_metrics": train_metrics,
        "eval_metrics": eval_acc,
        "eval_timeline": eval_timeline,
        "test_metrics": test_metrics,
        "rays_per_sec_per_chip": rays_per_sec,
        "elapsed_s": elapsed,
        "march_steps": march_steps,
        "first_skip_step": first_skip_step,
    }


def _state(renderer, optimizer, occ_state, meta) -> dict:
    return {"params": params_to_numpy(renderer), "opt_state": optimizer.state(),
            "occ_state": occ_state_to_numpy(occ_state), "meta": meta}


def _write_json(path: Path, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)
