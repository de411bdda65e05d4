"""What a cell's window drives in the program, `tinynerf_tpu_torch`: the
training loop in `train()`'s own order, or served views through `infer` as
`render_only` calls it.  The program is imported inside the functions, so
the harness, the reference and the tests import this module without it.

Departure from `train()`: the occupancy state is part of the cell's traffic
and is held fixed.  The sweep and the skip-grid rebuild run at their
cadence, so their cost is in the window, but the skip grid is rebuilt from
the cell's state and the grid the sweep returns is checked for its shape
and dropped: with seeded random weights it would turn any state into noise
within a few updates.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import scene
from .reference.nerf import scene_of


def span(name: str, on: bool):
    """The harness's host span `name` while tracing, else nothing."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(config: dict, device: torch.device, field_kw: Optional[dict] = None):
    """(TrainConfig, renderer) of the configuration, its parameters drawn
    later by `load_params`; `field_kw` sets field options (the control's
    float8 gathers)."""
    from tinynerf_tpu_torch.train import TrainConfig, build_renderer

    cfg = TrainConfig(**scene_of(config).train_keys(config["train"]))
    opt = config["optimizer"]
    stated = (cfg.effective_lr, cfg.effective_lr_tables or cfg.effective_lr, cfg.adam_eps, cfg.weight_decay)
    if not np.allclose(stated, (opt["lr"], opt["lr_tables"], opt["eps"], opt["weight_decay"]), rtol=1e-12):
        raise ValueError(f"the program's optimizer settings {stated} are not the configuration's {opt}")
    renderer = build_renderer(cfg, 1.0, np.ones(3, np.float32), device=device,
                              generator=torch.Generator().manual_seed(0))
    for key, value in (field_kw or {}).items():
        setattr(renderer.field, key, value)
    return cfg, renderer


def load_params(renderer: torch.nn.Module, params: Dict[str, torch.Tensor], n_params: int) -> None:
    """Copy the benchmark's parameters into the renderer, name by name."""
    named = dict(renderer.named_parameters())
    if set(named) != set(params) or sum(p.numel() for p in named.values()) != n_params:
        raise ValueError(f"the program's parameters {sorted(named)} are not the configuration's {sorted(params)}")
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(params[name])


def occupancy_state(config: dict, kind: str, device):
    from tinynerf_tpu_torch.core.occupancy import OccupancyState

    grid, mean = scene_of(config).occupancy_grid(kind, config["train"]["occupancy_res"], device)
    return OccupancyState(grid=grid, mean=mean)


def step_seed(seed: int, step: int, stream: int) -> int:
    """The generator seed of a step's stream (0: batch and seed words, 1:
    the occupancy sweep's jitter), a function of (seed, step)."""
    return scene.stream_seed(seed, 1000 + 2 * step + stream)


class TrainLoop:
    """`train()`'s loop on one device from the benchmark's parameters and
    ray pool: the occupancy sweep and skip-grid rebuild every
    `occ_update_every` steps, the bucket from `BucketEstimator`, the march
    from `MarchPolicy`, the step, and the loss and counts read back in
    batches as `flush_pending` does."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 pool, params: Dict[str, torch.Tensor], field_kw: Optional[dict] = None):
        from tinynerf_tpu_torch.train import BucketEstimator, MarchPolicy, make_occupancy_update, make_optimizer

        self.traffic, self.seed, self.device, self.pool = traffic, seed, device, pool
        self.cfg, self.renderer = build(config, device, field_kw)
        load_params(self.renderer, params, config["params"])
        self.optimizer = make_optimizer(self.cfg, self.renderer)
        self.occ = occupancy_state(config, traffic["occupancy"], device)
        self.policy = MarchPolicy(self.renderer.supports_skip_march, self.cfg.march, self.renderer.skip_steps)
        self.skip_grid = self.renderer.skip_grid(self.occ) if self.policy.can_skip else None
        self.occ_update = make_occupancy_update(self.renderer)
        self.estimator = BucketEstimator(self.cfg)
        self._steps: Dict[tuple, object] = {}
        self.step_i = 0
        self.trace = False
        self.update_ms: List[float] = []
        self.pending: List[dict] = []
        self.done: List[List[float]] = []  # [loss, rays_used, fill] of flushed steps

    def _step_fn(self, bucket: int, march: str):
        from tinynerf_tpu_torch.train import make_train_step

        if (bucket, march) not in self._steps:
            self._steps[bucket, march] = make_train_step(
                self.renderer, self.optimizer, self.cfg, n_cand=bucket * self.cfg.batch_size, march=march)
        return self._steps[bucket, march]

    def _occupancy_update(self) -> None:
        if self.trace:
            synchronize(self.device)
            t0 = time.perf_counter()
        with span("occupancy_update", self.trace):
            gen = torch.Generator(device=self.device).manual_seed(step_seed(self.seed, self.step_i, 1))
            swept = self.occ_update(self.occ, gen)
            if swept.grid.shape != self.occ.grid.shape:
                raise RuntimeError(f"the occupancy sweep returned a grid of {tuple(swept.grid.shape)}")
            del swept
        if self.policy.can_skip:
            with span("skip_grid", self.trace):
                self.skip_grid = self.renderer.skip_grid(self.occ)
        self.estimator.mark_occupancy_changed()
        self.policy.on_occupancy_update()
        if self.trace:
            synchronize(self.device)
            self.update_ms.append((time.perf_counter() - t0) * 1e3)

    def step(self) -> dict:
        """One step of the loop; returns its metrics (device scalars) with
        the candidate rays and the march it took."""
        if self.step_i % self.cfg.occ_update_every == 0:
            self._occupancy_update()
        bucket = self.estimator.bucket()
        march = self.policy.pick(self.estimator.avg_samples_per_ray)
        grid_args = (self.skip_grid,) if march == "skip" else ()
        seed = step_seed(self.seed, self.step_i, 0)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with span("step", self.trace):
            m = self._step_fn(bucket, march)(self.occ, *grid_args, *self.pool, gen)
        self.estimator.observe(m["fill"], m["rays_used"])
        if march == "skip":
            self.policy.observe(m["complete_frac"])
        self.pending.append(m)
        if len(self.pending) >= self.traffic["flush_every"]:
            self.flush()
        self.step_i += 1
        return {**m, "n_cand": bucket * self.cfg.batch_size, "march": march, "seed": seed}

    def flush(self) -> None:
        """One device-to-host copy for the pending steps' scalars."""
        if self.pending:
            host = torch.stack([torch.stack([m["loss"].float(), m["rays_used"].float(), m["fill"].float()])
                                for m in self.pending]).cpu()
            self.done.extend(host.tolist())
            self.pending.clear()

    def window(self, seconds: Optional[float] = None, n_steps: Optional[int] = None) -> dict:
        """Whole steps until `seconds` have passed (or `n_steps` are done),
        closed by a synchronize: the window's seconds, steps, rays that
        reached the loss, samples per step and steps whose loss is not
        finite."""
        self.flush()
        self.done.clear()
        self.update_ms.clear()
        synchronize(self.device)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        start = self.step_i
        while True:
            self.step()
            if n_steps is not None and self.step_i - start >= n_steps:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
        self.flush()
        synchronize(self.device)
        elapsed = time.perf_counter() - t0
        cap = self.cfg.sample_cap
        return {
            "seconds": elapsed,
            "steps": len(self.done),
            "rays": sum(r for _, r, _ in self.done),
            "samples": [int(round(f * cap)) for _, _, f in self.done],
            "failed": sum(1 for loss, _, _ in self.done if not math.isfinite(loss)),
            "update_ms": list(self.update_ms),
        }

    def leaf_names(self) -> List[str]:
        by_id = {id(p): name for name, p in self.renderer.named_parameters()}
        return [by_id[id(p)] for p in self.optimizer.params]


def checked_steps(loop: TrainLoop, params0: Dict[str, torch.Tensor]) -> dict:
    """The loop's first `check_steps` steps: per step its loss, kept
    samples, rays trained on, generator seed and candidate rays; each leaf's
    first gradient norm as Adam received it (its first moment after one
    step over 1 - b1) and its change after those steps."""
    names = loop.leaf_names()
    b1 = loop.optimizer.b1
    cap = loop.cfg.sample_cap
    out = {"loss": [], "samples": [], "rays_used": [], "steps": []}
    for i in range(loop.traffic["check_steps"]):
        m = loop.step()
        out["loss"].append(float(m["loss"]))
        out["samples"].append(int(round(float(m["fill"]) * cap)))
        out["rays_used"].append(int(round(float(m["rays_used"]))))
        out["steps"].append((m["seed"], m["n_cand"]))
        if i == 0:
            out["grad_norm"] = {n: float(torch.linalg.vector_norm(mu)) / (1.0 - b1)
                                for n, mu in zip(names, loop.optimizer.mu)}
    named = dict(loop.renderer.named_parameters())
    out["update_norm"] = {n: float(torch.linalg.vector_norm(named[n].detach() - params0[n])) for n in names}
    return out


def train_setup(loop: TrainLoop, params0: Dict[str, torch.Tensor]) -> dict:
    """The checked steps, then the rest of the warm-up: the loop runs to
    `warmup_steps` (a whole occupancy cycle, so the window starts on an
    update with every shape it uses built once)."""
    out = checked_steps(loop, params0)
    while loop.step_i < loop.traffic["warmup_steps"]:
        loop.step()
    return out


class HostViews:
    """The serving loop's views as `infer` reads a pose set: per index the
    rays (host arrays [res, res, 3]) and the image size."""

    class _Size:
        def __init__(self, res: int):
            self.h = self.w = res

    def __init__(self, rays_o: np.ndarray, rays_d: np.ndarray):
        self.rays_o, self.rays_d = rays_o, rays_d
        self._size = self._Size(rays_o.shape[1])

    def __len__(self) -> int:
        return self.rays_o.shape[0]

    def __getitem__(self, i: int) -> dict:
        return {"rays_o": self.rays_o[i], "rays_d": self.rays_d[i]}

    def img_intrinsics(self, i: int):
        return self._size


class ServeLoop:
    """Served views through `infer` as `render_only` calls it: the packed
    chunk on the skip march over the skip grid of the cell's occupancy
    state, the dense chunk for the rays it flags, `write=False`."""

    def __init__(self, config: dict, traffic: dict, device: torch.device, views: HostViews,
                 params: Dict[str, torch.Tensor], field_kw: Optional[dict] = None):
        from tinynerf_tpu_torch.train import make_render_chunk, make_render_chunk_packed

        self.traffic, self.device, self.views = traffic, device, views
        self.cfg, self.renderer = build(config, device, field_kw)
        load_params(self.renderer, params, config["params"])
        self.occ = occupancy_state(config, traffic["occupancy"], device)
        self.chunk = traffic["chunk"]
        self.packed = make_render_chunk_packed(
            self.renderer, self.chunk * traffic["packed_samples_per_ray"], march=traffic["march"])
        self._dense = make_render_chunk(self.renderer)
        self.trace = False
        self.grid_args = (self.renderer.skip_grid(self.occ),) if traffic["march"] == "skip" else ()
        self.next_view = 0
        self.rendered: List[int] = []  # the window's view indices, in order

    def _dense_chunk(self, *args):
        with span("fallback", self.trace):
            return self._dense(*args)

    def view(self, stats) -> None:
        from pathlib import Path

        from tinynerf_tpu_torch.train import infer

        with span("view", self.trace):
            infer(self.renderer, self.occ, self.views, [self.next_view], Path("."), "view", chunk=self.chunk,
                  render_chunk_fn=self._dense_chunk, packed_fn=self.packed, stats=stats,
                  grid_args=self.grid_args, write=False)
        self.rendered.append(self.next_view)
        self.next_view = (self.next_view + 1) % len(self.views)

    def window(self, seconds: Optional[float] = None, n_views: Optional[int] = None) -> dict:
        """Whole views until `seconds` have passed (or `n_views` are done)."""
        from tinynerf_tpu_torch.train import InferStats

        stats = InferStats()
        self.rendered = []
        synchronize(self.device)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        while True:
            self.view(stats)
            if n_views is not None and len(stats.images) >= n_views:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
        synchronize(self.device)
        elapsed = time.perf_counter() - t0
        return {
            "seconds": elapsed,
            "views": len(stats.images),
            "images": stats.images,
            "view_index": list(self.rendered),
            "rays": sum(stats.rays),
            "packed_samples": stats.packed_samples,
            "fallback_rays": stats.fallback_rays,
            "failed": sum(1 for img in stats.images if not np.isfinite(img).all()),
        }
