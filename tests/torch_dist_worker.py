"""Worker processes of the port's data-parallel tests (no jax here: each
rank is a fresh spawned process that imports only torch and the port).

`run(rank, world, rdv, job, payload, out)` joins a gloo group through the
file `rdv` (`file://`, so pytest-xdist workers never share a port), runs
`JOBS[job](group, payload)` and, on rank 0, pickles its result to `out`.
Every result is numpy, in the JAX layout where it is a tree.
"""

import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

from tinynerf_tpu_torch.convert import load_params, params_to_numpy, tree_map
from tinynerf_tpu_torch.data import RayPool, parse_nerf_synthetic
from tinynerf_tpu_torch.models import ColorDecoder, KPlanesFeatureField, OpacityDecoder
from tinynerf_tpu_torch.parallel import shard_rays, wrap_default_group
from tinynerf_tpu_torch.train import TrainConfig, build_renderer, make_optimizer, make_train_step, train
from tinynerf_tpu_torch.train.loop import make_occupancy_update, make_render_chunk, make_render_chunk_packed
from tinynerf_tpu_torch.utils import make_shell_occupancy

T = torch.from_numpy


def small_renderer(cfg: TrainConfig, scene_scale: float, bg_color):
    """tests/test_zero.py's field and decoders: planes 9/17/33 x 8
    features, the opacity decoder at 64 hidden, the color decoder 16 x 2."""
    r = build_renderer(cfg, scene_scale, bg_color, device="cpu")
    r.field = KPlanesFeatureField(feature_dim_per_plane=8, resolutions=(9, 17, 33))
    r.sigma_decoder = OpacityDecoder(feature_dim=r.field.feature_dim)
    r.rgb_decoder = ColorDecoder(n_freqs=8, in_features=r.field.feature_dim, hidden_features=16, hidden_layers=2)
    return r


def _np_tree(tree):
    return tree_map(lambda t: t.detach().cpu().numpy().copy() if torch.is_tensor(t) else t, tree)


def steps_job(group, p: dict) -> dict:
    """One deterministic step per variant from the same parameters and
    global batch (replicated, shard_tables, shard_tables + shard_bwd), then
    the serving chunks and the occupancy sweep over the group against one
    rank."""
    out = {}
    rays = tuple(T(a) for a in p["rays"])
    for name, kw in p["variants"].items():
        cfg = TrainConfig(**p["cfg"], **kw)
        r = small_renderer(cfg, p["scene_scale"], p["bg_color"])
        load_params(r, p["params"])
        opt = make_optimizer(cfg, r, group)
        step = make_train_step(r, opt, cfg, n_cand=rays[0].shape[0], deterministic=True, group=group)
        m = step(r.occupancy.init_state("cpu"), *shard_rays(group, *rays))
        out[name] = dict(loss=float(m["loss"]), grads=_np_tree(m["grads"]), params=params_to_numpy(r),
                         opt_state=opt.state(), rays_used=float(m["rays_used"]), fill=float(m["fill"]))

    cfg = TrainConfig(**p["cfg"])
    r = small_renderer(cfg, p["scene_scale"], p["bg_color"])
    load_params(r, p["params"])
    occ = make_shell_occupancy(r.occupancy)
    cap = rays[0].shape[0] * cfg.n_samples
    with torch.inference_mode():
        for name, fn in (("dense", make_render_chunk), ("packed", lambda rr, g: make_render_chunk_packed(rr, cap, group=g))):
            one = fn(r, None)(occ, *rays[:2])
            many = fn(r, group)(occ, *rays[:2])
            one, many = (x if isinstance(x, tuple) else (x,) for x in (one, many))
            out[f"render_{name}"] = ([np.asarray(v) for v in one], [np.asarray(v) for v in many])
        # the density bias moved so that the median density over the grid
        # sits at the threshold's: the sweep then confirms some voxels and
        # decays others
        thr = float(r.occupancy._threshold(occ))
        coords = torch.rand(4096, 3, generator=torch.Generator().manual_seed(3)) * 2 - 1
        sigma = torch.median(r.sigma_fn(coords))
        r.sigma_decoder.mlp.b[-1].sub_(torch.log(sigma * r.occupancy.step_size / -np.log1p(-thr)))
        upd = [make_occupancy_update(r, g)(occ, torch.Generator().manual_seed(11)) for g in (None, group)]
    out["occupancy"] = [(s.grid.numpy().copy(), float(s.mean)) for s in upd]
    return out


def _train_cfg(p: dict, out, **kw) -> TrainConfig:
    return TrainConfig(**dict(p["cfg"], output=out, **kw))


def train_job(group, p: dict) -> dict:
    """`train()` over the group with shard_tables: 3 steps with a checkpoint
    each step, a resume to 5, and 5 straight."""
    pool = RayPool(parse_nerf_synthetic(p["scene"], "train"))
    a, b = p["dirs"]
    first = train(_train_cfg(p, a, steps=3, checkpoint_every=1), pool, group=group)
    resumed = train(_train_cfg(p, a, steps=5), pool, resume=True, group=group)
    straight = train(_train_cfg(p, b, steps=5), pool, group=group)
    return dict(first_losses=[m.loss for m in first["train_metrics"]],
                resumed_steps=len(resumed["train_metrics"]),
                resumed=params_to_numpy(resumed["renderer"]), straight=params_to_numpy(straight["renderer"]))


JOBS = {"steps": steps_job, "train": train_job}


def run(rank: int, world: int, rdv: str, job: str, payload: dict, out: str) -> None:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=world)
    try:
        result = JOBS[job](wrap_default_group("cpu"), payload)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(job: str, payload: dict, tmp, world: int = 2):
    """Start the job's ranks; returns (process context, result path): call
    `join(context, path)` for the result."""
    ctx = torch.multiprocessing.start_processes(
        run, args=(world, str(tmp / "rdv"), job, payload, str(tmp / "result.pkl")),
        nprocs=world, join=False, start_method="spawn")
    return ctx, tmp / "result.pkl"


def join(ctx, path, timeout: float = 300.0):
    """Wait for every rank (a rank's exception is raised here) and load the
    result; ranks still running after `timeout` seconds are terminated."""
    deadline = time.monotonic() + timeout
    while not ctx.join(max(deadline - time.monotonic(), 0.0)):  # one rank's exit per call
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.terminate()
            raise TimeoutError(f"the ranks did not finish within {timeout} s")
    with open(path, "rb") as f:
        return pickle.load(f)
