"""The port's renderer (core) against the JAX package's.

Both packages get the same scene (generated, 16x16 views), the same
parameters (initialized by JAX, carried with `tinynerf_tpu_torch.convert`)
and the same occupancy state (the shell fixture).  JAX's packed path runs
its CPU form (the dense-detour weights); the port's runs the plain versions
of its kernels (CPU tensors).

How the parity traps are handled:
  * compaction: the port's cumsum-scatter buffer must hold exactly JAX's
    top_k indices, pad fill `total` included; overflow flags must be equal;
  * knife edges (the box nudge, half-to-even rounding of the occupancy
    query): the masks are asserted EQUAL, with no allowance for differing
    rays, and they are on these inputs;
  * bf16: f32 compute is held to 1e-4 (as tests/test_core.py:189); bf16
    compute to 2e-2 (one-ulp bf16 rounding flips between frameworks, see
    tests/test_torch_models.py).
The whole slice (infer, render_only, checkpoints, the CLI) is in
test_torch_slice.py.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu_torch.utils import make_shell_occupancy, make_spheres_pose_set, write_png
from torch_world import BF16_ATOL, F32_ATOL, make_scene, make_world

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return make_world(make_scene(tmp_path_factory.mktemp("torch_scene") / "spheres"))


def _rays(n=64, seed=0):
    """Rays from a ring at distance ~4 aimed near the origin (some miss the
    occupied shell, some graze it)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)
    o = np.stack([4 * np.cos(theta), 4 * np.sin(theta), rng.uniform(-1, 2, n)], -1)
    target = rng.uniform(-0.8, 0.8, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_march_contraction_occupancy_match_jax(world):
    jr, r = world["jr"], world["renderers"]["float32"]
    o, d = _rays(256, seed=1)
    t, deltas = r.marcher(torch.from_numpy(o), torch.from_numpy(d))
    jt, jdeltas = jr.marcher(jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(deltas.numpy(), np.asarray(jdeltas))
    cpos, _, maskf = r._march(torch.from_numpy(o), torch.from_numpy(d), world["tocc"])
    jcpos, _, jmaskf = jax.jit(jr._march)(jnp.asarray(o), jnp.asarray(d), world["occ"], None)
    np.testing.assert_allclose(cpos.numpy(), np.asarray(jcpos), atol=1e-5)
    np.testing.assert_array_equal(maskf.numpy(), np.asarray(jmaskf))
    assert 0 < maskf.sum() < maskf.numel()  # the shell culls some, keeps some


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_dense_and_packed_match_jax(world, dtype):
    r = world["renderers"][dtype]
    jr = dataclasses.replace(world["jr"], compute_dtype=getattr(jnp, dtype))
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    o, d = _rays(64, seed=2)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    params, occ, tocc = world["params"], world["occ"], world["tocc"]
    with torch.inference_mode():
        dense = r.render_dense(tocc, to, td)
    jdense = jax.jit(jr.render_dense)(params, occ, jo, jd)
    np.testing.assert_allclose(dense.rgb.numpy(), np.asarray(jdense.rgb), atol=atol)
    np.testing.assert_allclose(dense.opacity.numpy(), np.asarray(jdense.opacity), atol=atol)
    assert int(dense.n_samples) == int(jdense.n_samples)
    # ample cap, then a starved one (overflow flags must match JAX exactly)
    for cap in (64 * 32, 40) if dtype == "float32" else (64 * 32,):
        with torch.inference_mode():
            packed = r.render_packed(tocc, to, td, cap)
        jpacked = jax.jit(jr.render_packed, static_argnames=("cap", "rgb_dir_branch"))(
            params, occ, jo, jd, cap=cap, rgb_dir_branch="ray")
        np.testing.assert_array_equal(packed.ray_valid.numpy(), np.asarray(jpacked.ray_valid))
        ok = packed.ray_valid.numpy() > 0
        np.testing.assert_allclose(packed.rgb.numpy()[ok], np.asarray(jpacked.rgb)[ok], atol=atol)
        np.testing.assert_allclose(packed.opacity.numpy()[ok], np.asarray(jpacked.opacity)[ok], atol=atol)
        assert int(packed.n_samples) == int(jpacked.n_samples)
        if cap == 40:
            assert 0 < ok.sum() < ok.size
        else:
            assert ok.all()
            np.testing.assert_allclose(packed.rgb.numpy(), dense.rgb.numpy(), atol=atol)


def test_port_sources_import_no_jax():
    """No module of the port imports jax, optax or triton (importing and
    rendering with jax and optax unimportable is the subprocess test above)."""
    for path in (REPO / "tinynerf_tpu_torch").rglob("*.py"):
        src = path.read_text()
        for mod in ("jax", "optax", "triton"):
            assert f"import {mod}" not in src and f"from {mod}" not in src, path


def test_png_writer_round_trip(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    for c in (3, 4):
        arr = rng.integers(0, 256, (5, 7, c), dtype=np.uint8)
        write_png(arr, tmp_path / f"x{c}.png")
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / f"x{c}.png")), arr)


def test_spheres_pose_set_and_shell(world):
    ps = make_spheres_pose_set(n_views=2, res=16, seed=0)
    assert len(ps) == 2 and ps[0]["rgbs"].shape == (16, 16, 3)
    assert ps[0]["rays_o"].shape == ps[0]["rays_d"].shape == (16, 16, 3)
    occ = make_shell_occupancy(world["renderers"]["float32"].occupancy)
    np.testing.assert_array_equal(occ.grid.numpy(), np.asarray(world["occ"].grid))
    assert float(occ.mean) == float(world["occ"].mean)
