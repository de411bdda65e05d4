"""The port's Cobafa slice against the JAX package: the renderers, the
train step, `train()` with dropout, a JAX-written checkpoint served by the
port, and the command line with `--method cobafa`.

Setup as in tests/torch_world.py with `COBAFA_CFG` (basis grids
8/8/8/8/10/12, coefficients 8^3 x 6, the full-width field MLP; 32 samples,
64 rays, occupancy 16) and the JAX field in its oct layout
(`lookup_mode="quad"`).  The JAX step is `make_train_step(...,
deterministic=True)` on a one-device mesh: the pool's first rays, no jitter
and no dropout.  The port's step gets the JAX march's sample positions: the
field's 7-layer ReLU MLP makes its gradients sensitive to last-bit
differences in the positions (shifting them by 5e-7 moves the grid
gradients by ~1% of their max, in either package), and the two marches
differ in the last bits (held to 1e-5 in test_torch_render.py).

Tolerances (as test_torch_train_slice.py): renders 1e-4 at f32 compute;
step-0 loss 1e-5 relative, gradients 1e-4 of each leaf's largest |g|, the
loss over three steps 1e-3 relative.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

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
from tinynerf_tpu.train import save_checkpoint as jsave_checkpoint
from tinynerf_tpu.train.checkpoint import latest_checkpoint as jlatest_checkpoint
from tinynerf_tpu.train.checkpoint import load_checkpoint as jload_checkpoint
from tinynerf_tpu_torch.__main__ import main as cli_main
from tinynerf_tpu_torch.convert import load_params, occ_state_to_numpy, params_to_numpy, tree_leaves_with_path
from tinynerf_tpu_torch.core import OccupancyGrid
from tinynerf_tpu_torch.data import RayPool, parse_nerf_synthetic
from tinynerf_tpu_torch.ops import octbuild
from tinynerf_tpu_torch.train import (
    TrainConfig,
    build_renderer,
    make_optimizer,
    make_train_step,
    save_checkpoint,
    train,
)
from tinynerf_tpu_torch.utils import make_shell_occupancy
from torch_world import BF16_ATOL, COBAFA_CFG, F32_ATOL, make_scene, make_world

torch.set_num_threads(2)

T = torch.from_numpy
N_CAND = 64
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(tmp_path_factory.mktemp("torch_cobafa_scene") / "spheres")


@pytest.fixture(scope="module")
def world(scene):
    return make_world(scene, COBAFA_CFG)


@pytest.fixture(scope="module")
def rays(scene):
    """64 rays through the middle rows of the training view, as numpy."""
    pool = JRayPool(jparse(scene, "train"))
    return tuple(np.asarray(a)[96 : 96 + N_CAND] for a in pool.arrays())


def _rays(n=64, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)
    o = np.stack([4 * np.cos(theta), 4 * np.sin(theta), rng.uniform(-1, 2, n)], -1)
    d = rng.uniform(-0.8, 0.8, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cobafa_render_dense_and_packed_match_jax(world, dtype):
    """Serving renders behind the shell occupancy: dense, packed with an
    ample cap and a starved one (overflow flags equal)."""
    r = world["renderers"][dtype]
    jr = dataclasses.replace(world["jr"], compute_dtype=getattr(jnp, dtype))
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    o, d = _rays(64, seed=2)
    to, td, jo, jd = T(o), T(d), jnp.asarray(o), jnp.asarray(d)
    params, occ, tocc = world["params"], world["occ"], world["tocc"]
    before = octbuild.build_oct.launches
    with torch.inference_mode():
        dense = r.render_dense(tocc, to, td)
    jdense = jax.jit(jr.render_dense)(params, occ, jo, jd)
    np.testing.assert_allclose(dense.rgb.numpy(), np.asarray(jdense.rgb), atol=atol)
    assert int(dense.n_samples) == int(jdense.n_samples) > 0
    for cap in (64 * 32, 40):
        with torch.inference_mode():
            packed = r.render_packed(tocc, to, td, cap, rgb_dir_branch="ray")
        jpacked = jax.jit(jr.render_packed, static_argnames=("cap", "rgb_dir_branch"))(
            params, occ, jo, jd, cap=cap, rgb_dir_branch="ray")
        np.testing.assert_array_equal(packed.ray_valid.numpy(), np.asarray(jpacked.ray_valid))
        ok = packed.ray_valid.numpy() > 0
        np.testing.assert_allclose(packed.rgb.numpy()[ok], np.asarray(jpacked.rgb)[ok], atol=atol)
        assert (0 < ok.sum() < ok.size) if cap == 40 else ok.all()
    assert octbuild.build_oct.launches == before  # CPU tensors: the plain build


def _jax_steps(world, rays, n_steps):
    jcfg = JConfig(compute_dtype="float32", **COBAFA_CFG)
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
        out.append((float(m["loss"]), jax.tree_util.tree_map(np.asarray, m["grads"])))
    return out


def _port_steps(world, rays, n_steps):
    cfg = TrainConfig(compute_dtype="float32", **COBAFA_CFG)
    r = build_renderer(cfg, world["pset"].scene_scale, world["pset"].bg_color, device="cpu")
    load_params(r, jax.tree_util.tree_map(np.asarray, world["params"]))
    jr = world["jr"]
    march = jax.jit(jr._march)(jnp.asarray(rays[0]), jnp.asarray(rays[1]), jr.occupancy.init_state(), None)
    r._march = lambda *args, **kw: tuple(T(np.array(a)) for a in march)  # JAX's positions
    step = make_train_step(r, make_optimizer(cfg, r), cfg, n_cand=N_CAND, deterministic=True)
    occ = r.occupancy.init_state()
    return [(float(m["loss"]), m["grads"]) for m in (step(occ, *(T(a) for a in rays)) for _ in range(n_steps))]


def test_cobafa_train_step_matches_jax(world, rays):
    """Step 0's loss and every gradient leaf (the grids through the oct
    backward, the field MLP, the decoders; the split table lr applied
    after), and the loss over three steps."""
    ref = _jax_steps(world, rays, 3)
    ours = _port_steps(world, rays, 3)
    assert ours[0][0] == pytest.approx(ref[0][0], rel=1e-5)
    g = [np.asarray(v) for _, v in tree_leaves_with_path(ours[0][1])]
    jg = jax.tree_util.tree_leaves(ref[0][1])
    assert len(g) == len(jg) == 6 + 1 + 14 + 4 + 10
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max())
    assert all(np.count_nonzero(a) > 0 for a in g[:7])  # every grid got a gradient
    for (l, _), (jl, _) in zip(ours, ref):
        assert l == pytest.approx(jl, rel=1e-3)
    assert ours[2][0] < ours[0][0]


def _train_cfg(out, **kw):
    base = dict(COBAFA_CFG, output=out, occupancy_update_every=16, compute_dtype="float32",
                ray_buckets=(1, 2))
    base.update(kw)
    return TrainConfig(**base)


def test_cobafa_train_learns_with_dropout(world, scene, tmp_path):
    """`train()` on the CPU, dropout and jitter on: a falling loss, and a
    checkpoint whose params and Adam state the JAX package's reader loads
    in the JAX Cobafa layout.  128-ray batches: at 64 rays the deep field's
    loss is too noisy to fall reliably in 40 steps."""
    pool = RayPool(parse_nerf_synthetic(scene, "train"), device="cpu")
    out = train(_train_cfg(tmp_path / "exp", steps=40, batch_size=128), pool, device="cpu")
    losses = [m.loss for m in out["train_metrics"]]
    assert np.isfinite(losses).all() and np.mean(losses[-8:]) < 0.7 * np.mean(losses[:4])
    step, state = jload_checkpoint(jlatest_checkpoint(tmp_path / "exp"))
    assert step == 40 and int(state["opt_state"].count) == 40
    jparams = world["params"]
    for tree in (state["params"], state["opt_state"].mu, state["opt_state"].nu):
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(jparams)
        for x, y in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(jparams)):
            assert x.shape == y.shape and x.dtype == np.float32


_BLOCKED_RENDER = """
import sys
for name in ("jax", "optax", "tinynerf_tpu"):
    sys.modules[name] = None   # importing them now raises ImportError
import numpy as np
from tinynerf_tpu_torch.data import PoseSet, parse_nerf_synthetic
from tinynerf_tpu_torch.train import InferStats, TrainConfig, render_only
cfg = TrainConfig(output=sys.argv[2], compute_dtype="float32", **{cfg})
stats = InferStats()
metrics = render_only(cfg, PoseSet(parse_nerf_synthetic(sys.argv[1], "test")), device="cpu", stats=stats)
np.save(sys.argv[3], np.stack(stats.images))
assert all(np.isfinite(m.psnr) for m in metrics)
"""


@pytest.mark.parametrize("march", ["dense", "skip"])
def test_render_only_reads_jax_cobafa_checkpoint(world, scene, tmp_path, march):
    """A Cobafa checkpoint written by the JAX package is rendered by the
    port's `render_only` (jax, optax and the JAX package unimportable; it
    serves with the skip march, as the JAX `render_only` does) and gives
    the JAX infer's images at f32, with either march packed."""
    jr = world["jr"]
    exp = tmp_path / "exp"
    jcfg = JConfig(compute_dtype="float32", output=exp, **COBAFA_CFG)
    opt_state = jloop.make_optimizer(jcfg).init(world["params"])
    jsave_checkpoint(exp, 4, {"params": world["params"], "opt_state": opt_state,
                              "occ_state": world["occ"], "meta": {"n_devices": 1}})
    cap = COBAFA_CFG["batch_size"] * jcfg.eval_samples_per_ray
    ref = jloop.infer(
        jr, world["params"], world["occ"], world["jset"], [0, 1], tmp_path / "jax", "r",
        chunk=COBAFA_CFG["batch_size"], render_chunk_fn=jloop.make_render_chunk(jr),
        packed_fn=jloop.make_render_chunk_packed(jr, cap, march=march),
        grid_args=(jr.skip_grid(world["occ"]),) if march == "skip" else (),
    )
    out_npy = tmp_path / "port.npy"
    script = _BLOCKED_RENDER.replace("{cfg}", repr(COBAFA_CFG))
    proc = subprocess.run([sys.executable, "-c", script, str(scene), str(exp), str(out_npy)],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "ckpt_4.pkl" in proc.stdout
    np.testing.assert_allclose(np.load(out_npy), np.stack(ref), atol=F32_ATOL)


def test_cli_trains_and_renders_cobafa(world, scene, tmp_path):
    """`python -m tinynerf_tpu_torch --method cobafa`: resume from a step-1
    checkpoint of the CLI's 128^3 occupancy grid (no sweep in steps 1-2),
    then `--render_only`."""
    base = ["--data", str(scene), "--datatype", "synthetic", "--method", "cobafa",
            "--batch_size", "64", "--n_samples", "32", "--field_scale", str(COBAFA_CFG["field_scale"]),
            "--device", "cpu"]
    exp = tmp_path / "exp"
    r = world["renderers"]["float32"]
    occ = make_shell_occupancy(OccupancyGrid.cube(128, r.marcher.step_size))
    opt = make_optimizer(TrainConfig(**COBAFA_CFG), r)
    save_checkpoint(exp, 1, {"params": params_to_numpy(r), "opt_state": opt.state(),
                             "occ_state": occ_state_to_numpy(occ)})
    cli_main(base + ["--output", str(exp), "--resume", "--steps", "2"])
    assert (exp / "ckpt_2.pkl").exists() and (exp / "metrics_train.json").exists()
    cli_main(base + ["--output", str(exp), "--render_only"])
    assert (exp / "metrics_render.json").exists() and (exp / "render_0001.png").exists()
