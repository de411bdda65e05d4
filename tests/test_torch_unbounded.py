"""Unbounded scenes in the port against the JAX package: the Mip-360
contraction, the disparity marcher, the isotropic skip grid and the
unbounded skip march (`skip_march_unbounded_plain`, the kernel's plain
version on CPU tensors), the renderer and the train step on them, the
nerfstudio parser, and the command line with `--datatype nerfstudio
--scene_type unbounded`.

Mirrors tests/test_skipmarch.py's unbounded cases: the skip grid and the
march's `k_idx` / `complete` must equal JAX's bit for bit, with and without
jitter (the words of `fold_in(key, 0)`), and the emitted set must equal the
port's own dense mask, also where the local Lipschitz certificate is tight
(diagonal far-field rays, rays that pass their closest approach to the
origin, n_eff on both sides of 2.25) and on a reduced round budget.
Renders and steps: tests/torch_world.py's setup with `scene_type=
"unbounded"` (K-Planes planes 9/17/33, 32 samples, occupancy 16, f32),
packed skip vs dense 2e-5 (tests/test_skipmarch.py), port vs JAX 1e-4,
the step's loss 1e-5 relative and gradients 1e-4 of each leaf's max.
"""

import json
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.core import ContractionMip360 as JContractionMip360
from tinynerf_tpu.core import RayMarcherUnbounded as JRayMarcherUnbounded
from tinynerf_tpu.core.skipmarch import make_skip_grid_iso as jmake_skip_grid_iso
from tinynerf_tpu.core.skipmarch import skip_march_unbounded as jskip_march_unbounded
from tinynerf_tpu.data import RayPool as JRayPool
from tinynerf_tpu.data import parse_nerf_synthetic as jparse
from tinynerf_tpu.data import parse_nerfstudio as jparse_nerfstudio
from tinynerf_tpu.parallel import make_mesh
from tinynerf_tpu.train import TrainConfig as JConfig
from tinynerf_tpu.train import loop as jloop
from tinynerf_tpu_torch.__main__ import main as cli_main
from tinynerf_tpu_torch.convert import load_params, tree_leaves_with_path
from tinynerf_tpu_torch.core import (
    ContractionMip360,
    NerfRenderer,
    OccupancyGrid,
    OccupancyState,
    RayMarcherUnbounded,
    make_skip_grid_iso,
)
from tinynerf_tpu_torch.core.skipmarch import skip_march_unbounded, skip_march_unbounded_plain
from tinynerf_tpu_torch.data import Intrinsics, RayPool, parse_nerfstudio
from tinynerf_tpu_torch.models import make_model
from tinynerf_tpu_torch.train import TrainConfig, build_renderer, make_optimizer, make_train_step
from torch_world import F32_ATOL, UNBOUNDED_CFG, make_scene, make_world

torch.set_num_threads(2)

T = torch.from_numpy
N_CAND = 64
SKIP_DENSE_ATOL = 2e-5  # tests/test_skipmarch.py: the same samples, sums in another order


def jitter_words(key):
    """The seed words the JAX renderer hashes with: `fold_in(key, 0)`."""
    if key is None:
        return None, None
    jkey = jax.random.fold_in(key, 0)
    return jkey, [int(w) for w in np.asarray(jkey).astype(np.uint32).reshape(-1)]


def marching(res=16, n_samples=64, uniform_range=2.0, budget=None):
    """The port's and JAX's marcher and contraction of
    tests/test_skipmarch.py's `make_unbounded_renderer`, without a field."""
    marcher = RayMarcherUnbounded(n_samples=n_samples, near=0.1, far=1e5, uniform_range=uniform_range)
    jmarcher = JRayMarcherUnbounded(n_samples=n_samples, near=0.1, far=1e5, uniform_range=uniform_range)
    return SimpleNamespace(marcher=marcher, jmarcher=jmarcher, contraction=ContractionMip360(),
                           occupancy=OccupancyGrid.cube(res, marcher.step_size),
                           skip_steps=budget or n_samples, res=res, n_samples=n_samples)


def random_grid(res, density, seed):
    return (np.random.default_rng(seed).random((res,) * 3) < density).astype(np.float32)


def random_rays(n, seed):
    """Unit directions from ~4 units out, aimed near the origin."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = -4.0 * d + rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    return o.astype(np.float32), d


def state_of(grid):
    return OccupancyState(grid=T(grid), mean=torch.tensor(float(grid.mean())))


def march_both(m, grid, o, d, key):
    """(port k_idx, complete), (JAX k_idx, complete) and the port's dense
    mask, on the iso grid of `grid`."""
    occ = grid > 0
    sg = make_skip_grid_iso(T(occ))
    jkey, words = jitter_words(key)
    ours = skip_march_unbounded(T(o), T(d), m.marcher, m.contraction, sg, words, m.skip_steps)
    ref = jskip_march_unbounded(jnp.asarray(o), jnp.asarray(d), m.jmarcher, JContractionMip360(),
                                jnp.asarray(sg.numpy()), jkey, m.skip_steps)
    dense = NerfRenderer._march(m, T(o), T(d), state_of(grid), words)[2].numpy() > 0
    return ours, ref, dense


def emitted(k_idx, n_samples):
    k_idx = k_idx.numpy()
    out = np.zeros((k_idx.shape[0], n_samples), bool)
    for r in range(k_idx.shape[0]):
        ks = k_idx[r][k_idx[r] >= 0]
        assert (np.diff(ks) > 0).all()  # ascending, no duplicates
        out[r, ks] = True
    return out


def check_march(m, grid, o, d, all_complete=True):
    for key in (None, jax.random.PRNGKey(11)):
        (k, c), (jk, jc), dense = march_both(m, grid, o, d, key)
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        if all_complete:
            assert bool(c.all())
            np.testing.assert_array_equal(emitted(k, m.n_samples), dense)


# ------------------------------------------------------ contraction, marcher


@pytest.mark.parametrize("order", [float("inf"), 2.0])
def test_contraction_mip360_bit_equal_to_jax(order):
    """Points inside and far outside the unit ball, and on its boundary."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=(2000, 3)) * s for s in (0.3, 3.0, 300.0)]).astype(np.float32)
    x[:3] = np.eye(3, dtype=np.float32)
    ours, mask = ContractionMip360(order)(T(x))
    ref, jmask = JContractionMip360(order)(jnp.asarray(x))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    if order == float("inf"):
        assert float(ours.abs().max()) <= 1.0


@pytest.mark.parametrize("n_samples,near,uniform_range", [(64, 0.1, 2.0), (400, 0.1, 0.0567), (33, 0.0, 7.5)])
def test_unbounded_marcher_bit_equal_to_jax(n_samples, near, uniform_range):
    m = RayMarcherUnbounded(n_samples, near, 1e5, uniform_range)
    jm = JRayMarcherUnbounded(n_samples, near, 1e5, uniform_range)
    assert (m.step_size, m.step_x) == (jm.step_size, jm.step_x)
    o, d = random_rays(5, 0)
    t, deltas = m(T(o), T(d))
    jt, jdeltas = jm(jnp.asarray(o), jnp.asarray(d))
    assert t.shape == deltas.shape == (5, n_samples)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(deltas.numpy(), np.asarray(jdeltas))


# ------------------------------------------------------------- skip grid


@pytest.mark.parametrize("density,seed", [(0.01, 2), (0.08, 5), (0.3, 1)])
def test_make_skip_grid_iso_bit_equal_to_jax(density, seed):
    for shape in ((16,) * 3, (40, 3, 5)):
        occ = np.random.default_rng(seed).random(shape) < density
        ours = make_skip_grid_iso(T(occ))
        assert ours.dtype == torch.int32 and tuple(ours.shape) == shape
        np.testing.assert_array_equal(ours.numpy(), np.asarray(jmake_skip_grid_iso(jnp.asarray(occ))))


def test_skip_grid_iso_conservative():
    """g - 1 is a Chebyshev radius around the voxel with nothing occupied
    (tests/test_skipmarch.py:234)."""
    res = 12
    occ = np.random.default_rng(5).random((res,) * 3) < 0.08
    grid = make_skip_grid_iso(T(occ)).numpy()
    assert (grid[occ] == 0).all() and (grid[~occ] >= 1).all()
    assert grid.max() > 2
    for v in np.argwhere(grid > 1):
        r = int(grid[tuple(v)]) - 1
        lo, hi = np.maximum(v - r, 0), np.minimum(v + r + 1, res)
        assert not occ[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].any(), (v, r)


# ------------------------------------------------------------ skip march


@pytest.mark.parametrize("density,seed", [(0.01, 2), (0.05, 0), (0.2, 1)])
def test_skip_march_unbounded_equals_jax_and_dense_mask(density, seed):
    """tests/test_skipmarch.py:252 on random grids and rays."""
    m = marching()
    o, d = random_rays(256, seed)
    check_march(m, random_grid(m.res, density, seed), o, d)


def test_skip_march_unbounded_diagonal_far_field():
    """tests/test_skipmarch.py:391: isolated occupied voxels near the cube
    diagonals in the contracted far field, probed by near-diagonal rays from
    near the origin, where the order-inf contraction's directional constant
    is ~sqrt(2)/||x||_inf."""
    m = marching(res=32, n_samples=128)
    g = np.zeros((32,) * 3, np.float32)
    rng = np.random.default_rng(7)
    for sign in np.array(np.meshgrid([-1, 1], [-1, 1], [-1, 1])).reshape(3, -1).T:
        for c_r in (0.55, 0.7, 0.8, 0.9):
            for _ in range(4):
                p = sign * c_r + rng.normal(size=3) * 0.02
                g[tuple(np.clip(np.round((p + 1.0) * 0.5 * 31), 0, 31).astype(int))] = 1.0
    n = 512
    d = rng.choice([-1.0, 1.0], size=(n, 3)) / np.sqrt(3.0) + rng.normal(size=(n, 3)) * 0.05
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    check_march(m, g, o, d)


@pytest.mark.parametrize("radius", [1.5, 2.0, 2.25, 2.6, 3.5])
def test_skip_march_unbounded_past_closest_approach(radius):
    """Rays that start at `radius` from the origin, tangential or heading
    past their closest approach (t_star inside the march), so that n_eff
    switches from n_perp to the current radius mid-ray, on both sides of the
    2.25 switch of the local bound; far-field voxels occupied around the
    shell the rays graze."""
    m = marching(res=32, n_samples=96)
    rng = np.random.default_rng(int(radius * 10))
    n = 384
    o = rng.normal(size=(n, 3))
    o = (o / np.linalg.norm(o, axis=-1, keepdims=True) * radius).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d -= np.sum(d * o, -1, keepdims=True) * o / radius**2 * rng.uniform(0.0, 1.2, (n, 1))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    assert (np.sum(o * d, -1) < 0).mean() > 0.3  # many rays still approach the origin
    c = (np.arange(32) + 0.5) / 32 * 2.0 - 1.0
    cx, cy, cz = np.meshgrid(c, c, c, indexing="ij")
    shell = np.abs(np.maximum(np.maximum(abs(cx), abs(cy)), abs(cz)) - 0.62) < 0.04
    g = (shell & (np.random.default_rng(3).random(shell.shape) < 0.3)).astype(np.float32)
    check_march(m, g, o, d)


@pytest.mark.parametrize("blob_r,seed", [(3, 3), (6, 4)])
def test_skip_march_unbounded_far_field_budget(blob_r, seed):
    """tests/test_skipmarch.py:451: behind a central blob a budget of 40
    rounds, under the 64 samples, still finishes every ray, thanks to the
    local bound's growing far-field advances."""
    m = marching(res=32, n_samples=64, budget=40)
    ax = np.arange(32, dtype=np.float32) - 15.5
    rr = np.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2 + ax[None, None, :] ** 2)
    o, d = random_rays(256, seed + 40)
    check_march(m, (rr <= blob_r).astype(np.float32), o, d)


def test_skip_march_unbounded_small_budget_flags_rays():
    """A budget of 4 rounds on a dense grid: JAX's k_idx and complete, and
    most rays flagged incomplete."""
    m = marching(budget=4)
    o, d = random_rays(64, 7)
    (k, c), (jk, jc), _ = march_both(m, random_grid(16, 0.3, 6), o, d, None)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert float(c.float().mean()) < 0.5


def test_skip_march_unbounded_refuses():
    m = marching()
    o, d = (T(a) for a in random_rays(4, 0))
    grid = torch.zeros(8, 8, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="cubic"):
        skip_march_unbounded(o, d, m.marcher, m.contraction, grid[:, :, :4], None, 8)
    with pytest.raises(ValueError, match="order-inf"):
        skip_march_unbounded(o, d, m.marcher, ContractionMip360(2.0), grid, None, 8)
    with pytest.raises(ValueError, match="CPU or all CUDA"):
        skip_march_unbounded(o, d, m.marcher, m.contraction, grid.to("meta"), None, 8)
    # the plain version counts the rounds it ran, for the kernel's bound
    k, c, rounds = skip_march_unbounded_plain(o, d, m.marcher, m.contraction, grid, None, 8, count_rounds=True)
    assert rounds == 4 * 8 and not bool(c.any())  # an all-occupied grid: one sample per round


# ------------------------------------------------------- renderer and step


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(tmp_path_factory.mktemp("torch_unbounded_scene") / "spheres")


@pytest.fixture(scope="module")
def world(scene):
    return make_world(scene, UNBOUNDED_CFG)


@pytest.fixture(scope="module")
def rays(scene):
    """64 rays through the middle rows of the training view, as numpy."""
    pool = JRayPool(jparse(scene, "train"))
    return tuple(np.asarray(a)[96 : 96 + N_CAND] for a in pool.arrays())


def test_build_renderer_unbounded(world):
    r = world["renderers"]["float32"]
    assert isinstance(r.marcher, RayMarcherUnbounded) and isinstance(r.contraction, ContractionMip360)
    assert r.marcher.uniform_range == world["pset"].scene_scale == world["jr"].marcher.uniform_range
    assert r.skip_steps == 32  # min(96, n_samples)
    assert r.supports_skip_march and world["jr"].supports_skip_march
    grid = r.skip_grid(world["tocc"])
    np.testing.assert_array_equal(grid.numpy(), np.asarray(world["jr"].skip_grid(world["occ"])))


@pytest.mark.parametrize("jitter", [False, True])
def test_unbounded_render_packed_skip_matches_dense_and_jax(world, rays, jitter):
    """Behind the shell occupancy, at f32: the packed render on the skip
    march against the port's dense march and dense render, and against
    JAX's packed skip render."""
    jr, r = world["jr"], world["renderers"]["float32"]
    o, d = T(rays[0]), T(rays[1])
    key = jax.random.PRNGKey(5) if jitter else None
    _, words = jitter_words(key)
    grid = r.skip_grid(world["tocc"])
    with torch.no_grad():
        skip = r.render_packed(world["tocc"], o, d, 2048, jitter_seed=words, march="skip", skip_grid=grid)
        packed = r.render_packed(world["tocc"], o, d, 2048, jitter_seed=words)
        dense = r.render_dense(world["tocc"], o, d, jitter_seed=words)
    ref = jax.jit(lambda p, occ, sg: jr.render_packed(p, occ, jnp.asarray(rays[0]), jnp.asarray(rays[1]), 2048,
                                                      key=key, march="skip", skip_grid=sg))(
        world["params"], world["occ"], jr.skip_grid(world["occ"]))
    assert int(skip.n_samples) == int(packed.n_samples) == int(ref.n_samples) > 0
    assert int(skip.n_complete) == N_CAND
    np.testing.assert_allclose(skip.rgb.numpy(), packed.rgb.numpy(), atol=SKIP_DENSE_ATOL)
    np.testing.assert_allclose(skip.rgb.numpy(), dense.rgb.numpy(), atol=SKIP_DENSE_ATOL)
    np.testing.assert_allclose(skip.rgb.numpy(), np.asarray(ref.rgb), atol=F32_ATOL)
    np.testing.assert_array_equal(skip.ray_valid.numpy(), np.asarray(ref.ray_valid))


@pytest.mark.parametrize("march", ["dense", "skip"])
def test_unbounded_train_step_matches_jax(world, rays, march):
    """Behind the shell occupancy, the deterministic K-Planes step on the
    unbounded marcher: loss and every gradient leaf against JAX's."""
    jcfg = JConfig(compute_dtype="float32", **UNBOUNDED_CFG)
    jopt = jloop.make_optimizer(jcfg)
    jstep = jloop.make_train_step(world["jr"], jopt, jcfg, make_mesh(jax.devices()[:1]),
                                  n_cand=N_CAND, deterministic=True, march=march)
    params = jax.tree_util.tree_map(jnp.array, world["params"])
    jgrid = (world["jr"].skip_grid(world["occ"]),) if march == "skip" else ()
    _, _, jm = jstep(params, jopt.init(params), world["occ"], *jgrid, *(jnp.asarray(a) for a in rays),
                     jax.random.PRNGKey(0))

    cfg = TrainConfig(compute_dtype="float32", **UNBOUNDED_CFG)
    r = build_renderer(cfg, world["pset"].scene_scale, world["pset"].bg_color, device="cpu")
    load_params(r, jax.tree_util.tree_map(np.asarray, world["params"]))
    step = make_train_step(r, make_optimizer(cfg, r), cfg, n_cand=N_CAND, deterministic=True, march=march)
    grid = (r.skip_grid(world["tocc"]),) if march == "skip" else ()
    m = step(world["tocc"], *grid, *(T(a) for a in rays))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["fill"]) == pytest.approx(float(jm["fill"]), rel=1e-6) and float(m["fill"]) > 0
    g = [np.asarray(v) for _, v in tree_leaves_with_path(m["grads"])]
    jg = jax.tree_util.tree_leaves(jm["grads"])
    assert len(g) == len(jg) > 0
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max())


# ------------------------------------------------------------ nerfstudio


def _assert_same_data(ours, ref):
    np.testing.assert_array_equal(ours.cameras, ref.cameras)
    as_dicts = lambda k: [vars(x) for x in k] if isinstance(k, list) else vars(k)
    assert as_dicts(ours.intrinsics) == as_dicts(ref.intrinsics)
    assert len(ours.imgs) == len(ref.imgs) > 0
    for a, b in zip(ours.imgs, ref.imgs):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.bg_color, ref.bg_color)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_parse_nerfstudio_holdout_matches_jax(nerfstudio_scene, split):
    """Nine frames and no filename lists: every 8th frame (0 and 8) is held
    out for val and test, the other seven train; global intrinsics."""
    ours = parse_nerfstudio(nerfstudio_scene, split)
    _assert_same_data(ours, jparse_nerfstudio(nerfstudio_scene, split))
    assert ours.n_img == (7 if split == "train" else 2)
    assert isinstance(ours.intrinsics, Intrinsics)


def test_parse_nerfstudio_filenames_and_per_frame_intrinsics(nerfstudio_scene, tmp_path):
    """`{split}_filenames` lists pick the frames; per-frame intrinsics that
    differ stay a list, and fall back to the global ones per key."""
    root = tmp_path / "capture"
    shutil.copytree(nerfstudio_scene, root)
    meta = json.loads((root / "transforms.json").read_text())
    names = sorted(fr["file_path"] for fr in meta["frames"])
    meta["train_filenames"], meta["val_filenames"] = names[3:], names[:2]
    meta["frames"][0]["fl_x"] = 70.0
    meta["frames"][1]["cx"] = 30.0
    (root / "transforms.json").write_text(json.dumps(meta))
    for split in ("train", "val", "test"):
        ours = parse_nerfstudio(root, split)
        _assert_same_data(ours, jparse_nerfstudio(root, split))
    assert parse_nerfstudio(root, "train").n_img == 6
    assert isinstance(parse_nerfstudio(root, "val").intrinsics, list)
    assert parse_nerfstudio(root, "test").n_img == 2  # no test list: the holdout


def test_cli_nerfstudio_unbounded(nerfstudio_scene, tmp_path):
    """`python -m tinynerf_tpu_torch --datatype nerfstudio --scene_type
    unbounded` trains (0 steps: the final render and checkpoint) and renders
    the checkpoint back with --render_only."""
    base = ["--data", str(nerfstudio_scene), "--datatype", "nerfstudio", "--scene_type", "unbounded",
            "--method", "kplanes", "--batch_size", "64", "--n_samples", "32", "--field_scale", "0.07",
            "--device", "cpu"]
    cli_main(base + ["--output", str(tmp_path / "runs"), "--steps", "0"])
    (exp,) = (tmp_path / "runs").iterdir()
    assert exp.name.endswith("_kplanes_unbounded_32")
    assert (exp / "ckpt_0.pkl").exists() and (exp / "test_full_0001.png").exists()
    assert json.loads((exp / "metrics_test.json").read_text())
    cli_main(base + ["--output", str(exp), "--render_only"])
    assert (exp / "render_0001.png").exists() and (exp / "metrics_render.json").exists()


def test_train_on_nerfstudio_unbounded(nerfstudio_scene, tmp_path, capsys):
    """`train()` on a RayPool of parsed nerfstudio data, unbounded, with
    the skip march forced: finite losses and the unbounded skip grid rebuilt
    at the occupancy updates."""
    from tinynerf_tpu_torch.train import train

    pool = RayPool(parse_nerfstudio(nerfstudio_scene, "train"), device="cpu")
    cfg = TrainConfig(output=tmp_path / "exp", steps=3, occupancy_update_every=2, march="skip",
                      ray_buckets=(1,), compute_dtype="float32", **UNBOUNDED_CFG)
    out = train(cfg, pool, device="cpu")
    assert isinstance(out["renderer"].marcher, RayMarcherUnbounded)
    assert all(np.isfinite(m.loss) for m in out["train_metrics"]) and len(out["train_metrics"]) == 3
    assert "march skip" in capsys.readouterr().out
