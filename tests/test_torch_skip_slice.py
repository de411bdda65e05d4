"""The skip march on the port's training and serving paths against the JAX
package: the train step with `march="skip"`, `MarchPolicy`, and `train()`
with the skip march forced and picked by the policy.

Setup as in test_torch_train_slice.py (tests/torch_world.py: planes
9/17/33, 32 samples, 64 rays, occupancy 16, f32 compute), behind the shell
occupancy.  The JAX step is `make_train_step(..., deterministic=True,
march="skip")` on a one-device mesh.  Tolerances as there: loss 1e-5
relative, gradients 1e-4 of each leaf's largest |g|.
"""

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
from tinynerf_tpu_torch.convert import load_params, occ_state_to_numpy, params_to_numpy, tree_leaves_with_path
from tinynerf_tpu_torch.data import PoseSet, RayPool, parse_nerf_synthetic
from tinynerf_tpu_torch.train import (
    MarchPolicy,
    TrainConfig,
    build_renderer,
    make_optimizer,
    make_train_step,
    save_checkpoint,
    train,
)
from torch_world import CFG, make_scene, make_world

torch.set_num_threads(2)

T = torch.from_numpy
N_CAND = 64


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(tmp_path_factory.mktemp("torch_skip_slice_scene") / "spheres")


@pytest.fixture(scope="module")
def world(scene):
    return make_world(scene)


@pytest.fixture(scope="module")
def rays(scene):
    """64 rays through the middle rows of the training view, as numpy."""
    pool = JRayPool(jparse(scene, "train"))
    return tuple(np.asarray(a)[96 : 96 + N_CAND] for a in pool.arrays())


def _port_step(world, rays, march):
    cfg = TrainConfig(compute_dtype="float32", **CFG)
    r = build_renderer(cfg, world["pset"].scene_scale, world["pset"].bg_color, device="cpu")
    load_params(r, jax.tree_util.tree_map(np.asarray, world["params"]))
    step = make_train_step(r, make_optimizer(cfg, r), cfg, n_cand=N_CAND, deterministic=True, march=march)
    grid = (r.skip_grid(world["tocc"]),) if march == "skip" else ()
    return step(world["tocc"], *grid, *(T(a) for a in rays))


def test_train_step_skip_matches_jax_and_dense(world, rays):
    """Behind the shell occupancy: the skip step's loss and every gradient
    leaf against JAX's skip step, and its loss against the port's dense
    step (the same sample set)."""
    jcfg = JConfig(compute_dtype="float32", **CFG)
    jopt = jloop.make_optimizer(jcfg)
    jstep = jloop.make_train_step(world["jr"], jopt, jcfg, make_mesh(jax.devices()[:1]),
                                  n_cand=N_CAND, deterministic=True, march="skip")
    params = jax.tree_util.tree_map(jnp.array, world["params"])
    sg = world["jr"].skip_grid(world["occ"])
    _, _, jm = jstep(params, jopt.init(params), world["occ"], sg, *(jnp.asarray(a) for a in rays),
                     jax.random.PRNGKey(0))
    skip = _port_step(world, rays, "skip")
    dense = _port_step(world, rays, "dense")
    assert float(skip["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(skip["loss"]) == pytest.approx(float(dense["loss"]), rel=1e-5)
    assert float(skip["complete_frac"]) == float(jm["complete_frac"]) == 1.0
    assert float(skip["fill"]) == pytest.approx(float(jm["fill"]), rel=1e-6) and float(skip["fill"]) > 0
    g = [np.asarray(v) for _, v in tree_leaves_with_path(skip["grads"])]
    jg = jax.tree_util.tree_leaves(jm["grads"])
    assert len(g) == len(jg) > 0
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max())


def test_march_policy_matches_jax():
    """The demand threshold, the modes, and the one-step-late budget check
    with its fallback until the next occupancy update (tests/
    test_loop_units.py), decision for decision against JAX's policy."""
    for supported, mode in ((True, "auto"), (False, "auto"), (True, "dense"), (True, "skip"), (False, "skip")):
        ours, ref = MarchPolicy(supported, mode, 64), jloop.MarchPolicy(supported, mode, 64)
        assert ours.can_skip == ref.can_skip
        for avg in (1.0, 10.0, 22.4, 22.5, 30.0, 1e9):
            assert ours.pick(avg) == ref.pick(avg), (supported, mode, avg)
    ours, ref = MarchPolicy(True, "auto", 64), jloop.MarchPolicy(True, "auto", 64)
    for frac in (0.90, 1.0, "update", 1.0, 0.999, 1.0, 0.99, 1.0, "update", 1.0):
        if frac == "update":
            ours.on_occupancy_update()
            ref.on_occupancy_update()
        else:
            assert ours.observe(torch.tensor(frac)) == pytest.approx(ref.observe(jnp.float32(frac)))
        assert ours.suspended == ref.suspended
        assert ours.pick(5.0) == ref.pick(5.0)
    with pytest.raises(ValueError, match="march mode"):
        MarchPolicy(True, "sometimes", 64)


def _train_cfg(out, **kw):
    base = dict(CFG, output=out, compute_dtype="float32", ray_buckets=(1,))
    base.update(kw)
    return TrainConfig(**base)


def test_train_forced_skip(scene, tmp_path, capsys):
    """`train()` with `march="skip"` (as tests/test_train.py:248): the skip
    step's signature, the grid rebuilt at the occupancy updates, jittered
    batches, and the final test render through the packed skip path."""
    pool = RayPool(parse_nerf_synthetic(scene, "train"), device="cpu")
    pset = PoseSet(parse_nerf_synthetic(scene, "test"))
    out = train(_train_cfg(tmp_path / "exp", steps=3, occupancy_update_every=2, march="skip"),
                pool, test_set=pset, device="cpu")
    assert len(out["train_metrics"]) == 3 and all(np.isfinite(m.loss) for m in out["train_metrics"])
    assert "march skip" in capsys.readouterr().out
    assert out["test_metrics"] and all(np.isfinite(m.psnr) for m in out["test_metrics"])


def test_train_auto_picks_skip_when_demand_is_low(world, scene, tmp_path, capsys):
    """Resumed behind the shell occupancy, `march="auto"` marches densely
    until the bucket estimate refreshes (8 steps), then picks the skip march
    (a few samples per ray, under 0.35 x 32), where the JAX policy does."""
    exp = tmp_path / "exp"
    r = world["renderers"]["float32"]
    opt = make_optimizer(TrainConfig(**CFG), r)
    save_checkpoint(exp, 1, {"params": params_to_numpy(r), "opt_state": opt.state(),
                             "occ_state": occ_state_to_numpy(world["tocc"])})
    pool = RayPool(parse_nerf_synthetic(scene, "train"), device="cpu")
    out = train(_train_cfg(exp, steps=11, occupancy_update_every=1000), pool, resume=True, device="cpu")
    assert len(out["train_metrics"]) == 10
    lines = capsys.readouterr().out
    assert "march skip" in lines and "exhausted" not in lines
