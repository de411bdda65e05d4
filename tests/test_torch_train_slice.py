"""The port's training slice against the JAX package: the train step, the
occupancy update, the jittered march, and the entry points (`train`, its
checkpoints and resume, the command line).

Setup as in test_torch_slice.py (tests/torch_world.py: planes 9/17/33, 32
samples, 64 rays, occupancy 16, f32 compute), with JAX-initialized
parameters carried over.  The JAX step is `make_train_step(...,
deterministic=True)` on a one-device mesh: the pool's first rays, no
jitter.

Tolerances: step-0 loss 1e-5 relative and gradients 1e-4 of each leaf's
largest |g| (f32 sums in another order); the loss over three steps 1e-3
relative.  Parity trap: Adam with eps = 1e-15 moves every parameter whose
gradient is not 0 by about +-lr on the first step, so a gradient that is f32
noise may flip sign between frameworks and move a parameter by 2 lr;
parameters are compared only where |g| > 1e-6 of the leaf's largest.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.data import RayPool as JRayPool
from tinynerf_tpu.data import parse_nerf_synthetic as jparse
from tinynerf_tpu.parallel import make_mesh
from tinynerf_tpu.train import TrainConfig as JConfig
from tinynerf_tpu.train import loop as jloop
from tinynerf_tpu.train.checkpoint import latest_checkpoint as jlatest_checkpoint
from tinynerf_tpu.train.checkpoint import load_checkpoint as jload_checkpoint
from tinynerf_tpu_torch.__main__ import main as cli_main
from tinynerf_tpu_torch.convert import load_params, occ_state_to_numpy, params_to_numpy, tree_leaves_with_path
from tinynerf_tpu_torch.core import OccupancyGrid
from tinynerf_tpu_torch.data import RayPool, parse_nerf_synthetic
from tinynerf_tpu_torch.train import (
    TrainConfig,
    build_renderer,
    make_optimizer,
    make_train_step,
    save_checkpoint,
    train,
)
from tinynerf_tpu_torch.utils import make_shell_occupancy
from torch_world import CFG, F32_ATOL, make_scene, make_world

torch.set_num_threads(2)

T = torch.from_numpy
N_CAND = 64


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(tmp_path_factory.mktemp("torch_train_scene") / "spheres")


@pytest.fixture(scope="module")
def world(scene):
    return make_world(scene)


@pytest.fixture(scope="module")
def rays(scene):
    """The 64 rays through the middle rows of the training view (they cross
    the spheres), as numpy (o, d, rgb)."""
    pool = JRayPool(jparse(scene, "train"))
    return tuple(np.asarray(a)[96 : 96 + N_CAND] for a in pool.arrays())


def _leaves(tree):
    return [np.asarray(v) for _, v in tree_leaves_with_path(tree)]


def _jax_steps(world, rays, n_steps):
    jcfg = JConfig(compute_dtype="float32", **CFG)
    jopt = jloop.make_optimizer(jcfg)
    step = jloop.make_train_step(world["jr"], jopt, jcfg, make_mesh(jax.devices()[:1]),
                                 n_cand=N_CAND, deterministic=True)
    params = jax.tree_util.tree_map(jnp.array, world["params"])
    opt_state = jopt.init(params)
    occ = world["jr"].occupancy.init_state()
    pools = tuple(jnp.asarray(a) for a in rays)
    out = []
    for _ in range(n_steps):
        params, opt_state, m = step(params, opt_state, occ, *pools, jax.random.PRNGKey(0))
        out.append((float(m["loss"]), jax.tree_util.tree_map(np.asarray, m["grads"]),
                    jax.tree_util.tree_map(np.asarray, params)))
    return out


def _port_steps(world, rays, n_steps):
    cfg = TrainConfig(compute_dtype="float32", **CFG)
    r = build_renderer(cfg, world["pset"].scene_scale, world["pset"].bg_color, device="cpu")
    load_params(r, jax.tree_util.tree_map(np.asarray, world["params"]))
    opt = make_optimizer(cfg, r)
    step = make_train_step(r, opt, cfg, n_cand=N_CAND, deterministic=True)
    occ = r.occupancy.init_state()
    out = []
    for _ in range(n_steps):
        m = step(occ, *(T(a) for a in rays))
        out.append((float(m["loss"]), m["grads"], params_to_numpy(r)))
    return out


def test_train_step_matches_jax(world, rays):
    """Step 0's loss and every gradient leaf, the parameters after it where
    the gradient is not noise, and the loss over three steps."""
    ref = _jax_steps(world, rays, 3)
    ours = _port_steps(world, rays, 3)
    loss0, grads0, params1 = ours[0]
    jloss0, jgrads0, jparams1 = ref[0]
    assert loss0 == pytest.approx(jloss0, rel=1e-5)
    jg = jax.tree_util.tree_leaves(jgrads0)
    g = _leaves(grads0)
    assert len(g) == len(jg) > 0
    n_table_cells = 0
    for a, b in zip(g, jg):
        scale = np.abs(b).max()
        np.testing.assert_allclose(a, b, atol=1e-4 * scale)
        if a.ndim == 3:
            n_table_cells += int(np.count_nonzero(b))
    assert n_table_cells > 100  # the table gradient reached many plane cells
    for p, jp, b in zip(_leaves(params1), jax.tree_util.tree_leaves(jparams1), jg):
        sure = np.abs(b) > 1e-6 * np.abs(b).max()
        np.testing.assert_allclose(p[sure], np.asarray(jp)[sure], rtol=1e-5, atol=1e-6)
    for (l, _, _), (jl, _, _) in zip(ours, ref):
        assert l == pytest.approx(jl, rel=1e-3)
    assert ours[2][0] < ours[0][0]


def test_occupancy_update_matches_jax(world):
    """One decay/confirm sweep from the shell state, with the JAX sweep's
    own jitter passed in: equal grids except at voxels whose alpha lies
    within 1e-6 of the threshold.  The sigma decoder's output bias is
    lowered so that the sweep both confirms and decays voxels."""
    params = jax.tree_util.tree_map(np.asarray, world["params"])
    params["sigma"]["mlp"][-1]["b"] = params["sigma"]["mlp"][-1]["b"] - 1.9
    jr, occ0 = world["jr"], world["occ"]
    key = jax.random.PRNGKey(11)
    ref = jloop.make_occupancy_update(jr, None)(jax.tree_util.tree_map(jnp.asarray, params), occ0, key)
    res = jr.occupancy.size[0]
    jitter = np.stack([np.asarray(jax.random.uniform(k, (res, res, 3)))
                       for k in jax.random.split(key, res)])

    r = world["renderers"]["float32"]
    load_params(r, params)
    state0 = world["tocc"]
    out = r.occupancy.update(state0, r.sigma_fn, jitter=T(jitter))
    grid, jgrid = out.grid.numpy(), np.asarray(ref.grid)
    idx = np.stack(np.meshgrid(*(np.arange(res, dtype=np.float32),) * 3, indexing="ij"), -1)
    coords = -1.0 + 2.0 * (idx + jitter) / np.float32(res)
    with torch.no_grad():
        sigma = r.sigma_fn(T(coords.reshape(-1, 3))).numpy().reshape(res, res, res)
    alpha = 1.0 - np.exp(-sigma * r.occupancy.step_size)
    thr = min(0.01, float(np.asarray(occ0.mean)))
    differ = grid != jgrid
    assert not np.any(differ & (np.abs(alpha - thr) > 1e-6))
    assert 0 < np.mean(jgrid == 1.0) < 1  # some voxels confirmed, some decayed
    assert out.mean.item() == pytest.approx(float(ref.mean), rel=1e-6)
    load_params(r, jax.tree_util.tree_map(np.asarray, world["params"]))


def test_jittered_render_matches_jax(world, rays):
    """Train-time jitter: the JAX renderer's `key` against the port's seed
    words of `fold_in(key, 0)`, on the packed (per-sample rgb) and dense
    paths, at f32."""
    jr, r = world["jr"], world["renderers"]["float32"]
    o, d = (jnp.asarray(a) for a in rays[:2])
    key = jax.random.PRNGKey(5)
    words = [int(w) for w in np.asarray(jax.random.fold_in(key, 0)).astype(np.uint32).reshape(-1)]
    ref_p = jax.jit(lambda p, occ: jr.render_packed(p, occ, o, d, 2048, key=key))(
        world["params"], world["occ"])
    ref_d = jax.jit(lambda p, occ: jr.render_dense(p, occ, o, d, key=key))(world["params"], world["occ"])
    with torch.no_grad():
        out_p = r.render_packed(world["tocc"], T(rays[0]), T(rays[1]), 2048, jitter_seed=words)
        out_d = r.render_dense(world["tocc"], T(rays[0]), T(rays[1]), jitter_seed=words)
    np.testing.assert_allclose(out_p.rgb.numpy(), np.asarray(ref_p.rgb), atol=F32_ATOL)
    np.testing.assert_allclose(out_d.rgb.numpy(), np.asarray(ref_d.rgb), atol=F32_ATOL)
    assert int(out_p.n_samples) == int(ref_p.n_samples) > 0
    with torch.no_grad():
        still = r.render_packed(world["tocc"], T(rays[0]), T(rays[1]), 2048)
    assert not np.allclose(still.rgb.numpy(), out_p.rgb.numpy())  # the jitter moved samples


def _train_cfg(out, **kw):
    base = dict(CFG, output=out, occupancy_update_every=2, compute_dtype="float32", ray_buckets=(1,))
    base.update(kw)
    return TrainConfig(**base)


def test_train_checkpoint_resume_and_jax_reader(world, scene, tmp_path):
    """train() writes its artifacts and checkpoints whose Adam state the JAX
    package's reader loads in the JAX layout; resuming from step 3 to 5
    gives the same parameters as 5 steps straight through (one ray bucket,
    as the bucket estimate is not checkpointed, and no lr milestones, as
    they follow the run's length; both as in the JAX package)."""
    pool = RayPool(parse_nerf_synthetic(scene, "train"), device="cpu")
    a = tmp_path / "a"
    out = train(_train_cfg(a, steps=3, checkpoint_every=1, lr_milestones=()), pool, device="cpu")
    assert len(out["train_metrics"]) == 3 and all(np.isfinite(m.loss) for m in out["train_metrics"])
    for name in ("metrics_train.json", "throughput.json", "ckpt_1.pkl", "ckpt_3.pkl"):
        assert (a / name).exists(), name
    assert len(json.loads((a / "metrics_train.json").read_text())) == 3

    step, state = jload_checkpoint(jlatest_checkpoint(a))
    assert step == 3 and int(state["opt_state"].count) == 3
    jparams = world["params"]
    for tree in (state["params"], state["opt_state"].mu, state["opt_state"].nu):
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(jparams)
        for x, y in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(jparams)):
            assert x.shape == y.shape and x.dtype == np.float32
    assert np.asarray(state["occ_state"].grid).shape == (16, 16, 16)

    resumed = train(_train_cfg(a, steps=5, lr_milestones=()), pool, resume=True, device="cpu")
    assert len(resumed["train_metrics"]) == 2
    straight = train(_train_cfg(tmp_path / "b", steps=5, lr_milestones=()), pool, device="cpu")
    for x, y in zip(_leaves(params_to_numpy(resumed["renderer"])),
                    _leaves(params_to_numpy(straight["renderer"]))):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)


def test_train_learns(scene, tmp_path):
    """A short run on the CPU lowers the loss (jittered batches from the
    generator, occupancy updates, bucket changes)."""
    pool = RayPool(parse_nerf_synthetic(scene, "train"), device="cpu")
    out = train(_train_cfg(tmp_path / "exp", steps=40, occupancy_update_every=16, ray_buckets=(1, 2)),
                pool, device="cpu")
    losses = [m.loss for m in out["train_metrics"]]
    assert np.mean(losses[-8:]) < 0.7 * np.mean(losses[:4])


def test_cli_trains_and_renders(world, scene, tmp_path):
    """`python -m tinynerf_tpu_torch` without --render_only: a new experiment
    directory (0 steps: the final render and checkpoint), then --resume
    trains from a step-1 checkpoint of the CLI's 128^3 occupancy grid (no
    occupancy sweep falls in steps 1-2), then --render_only renders it;
    `--method vanilla` trains as well, and `--shard_tables` on one rank
    trains as without it (the JAX package's one-device no-op)."""
    base = ["--data", str(scene), "--datatype", "synthetic", "--method", "kplanes",
            "--batch_size", "64", "--n_samples", "32", "--field_scale", "0.07", "--device", "cpu"]
    cli_main(base + ["--output", str(tmp_path / "runs"), "--steps", "0"])
    (new,) = (tmp_path / "runs").iterdir()
    assert (new / "ckpt_0.pkl").exists() and (new / "metrics_test.json").exists()

    exp = tmp_path / "exp"
    r = world["renderers"]["float32"]
    occ = make_shell_occupancy(OccupancyGrid.cube(128, r.marcher.step_size))
    opt = make_optimizer(TrainConfig(field_scale=0.07), r)
    save_checkpoint(exp, 1, {"params": params_to_numpy(r), "opt_state": opt.state(),
                             "occ_state": occ_state_to_numpy(occ)})
    cli_main(base + ["--output", str(exp), "--resume", "--steps", "2"])
    assert (exp / "ckpt_2.pkl").exists()
    assert len(json.loads((exp / "metrics_train.json").read_text())) == 1
    cli_main(base + ["--output", str(exp), "--render_only"])
    assert (exp / "metrics_render.json").exists()
    # the vanilla method trains too (0 steps: its final render and checkpoint)
    cli_main([a if a != "kplanes" else "vanilla" for a in base] + ["--output", str(tmp_path / "vanilla"),
                                                                    "--steps", "0"])
    (new,) = (tmp_path / "vanilla").iterdir()
    assert new.name.endswith("_vanilla_aabb_32") and (new / "ckpt_0.pkl").exists()
    # on one rank --shard_tables changes nothing but the checkpoint's meta
    cli_main(base + ["--shard_tables", "--output", str(tmp_path / "sharded"), "--steps", "0"])
    (new,) = (tmp_path / "sharded").iterdir()
    _, state = jload_checkpoint(new / "ckpt_0.pkl")
    assert state["meta"] == {"shard_tables": True, "n_devices": 1}


def test_remat_field_raises_until_ported(tmp_path):
    """`remat_field=True` and `--remat on` are taken now, as None / False
    and `auto` / `off` are: the renderer recomputes its field in the
    backward (tests/test_torch_vanilla.py holds the step against JAX's)."""
    assert TrainConfig(remat_field=True).remat_field is True
    assert TrainConfig(remat_field=None).remat_field is None
    assert TrainConfig(remat_field=False).remat_field is False
    r = build_renderer(TrainConfig(remat_field=True, **CFG), 1.0, None, device="cpu")
    assert r.remat_field is True
    cli = ["--data", str(tmp_path / "none"), "--datatype", "synthetic", "--method", "kplanes",
           "--output", str(tmp_path / "runs"), "--device", "cpu"]
    for ok in ("on", "auto", "off"):  # accepted: the run then fails on the missing scene
        with pytest.raises(FileNotFoundError):
            cli_main(cli + ["--remat", ok])
