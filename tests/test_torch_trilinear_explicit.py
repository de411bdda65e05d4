"""Two small parts of the port against the JAX package: the occupancy
grid's trilinear query (`OccupancyGrid(interp="trilinear")`, through the
plain `trilinear_lookup`) and the K-Planes explicit decoders (the bilinear
opacity form and the color basis, with `apply_per_ray`), whose parameters
`convert.py` carries.

Tolerances: occupancy masks equal and looked-up values 1e-6; decoders
1e-5 at f32; packed renders F32_ATOL (tests/test_core.py:189's 1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.core.occupancy import OccupancyGrid as JOccupancyGrid
from tinynerf_tpu.core.occupancy import OccupancyState as JOccupancyState
from tinynerf_tpu.models.kplanes import KPlanesExplicitColorDecoder as JExplicitColor
from tinynerf_tpu.models.kplanes import KPlanesExplicitOpacityDecoder as JExplicitOpacity
from tinynerf_tpu.ops import interp as jinterp
from tinynerf_tpu_torch.convert import decoder_into, decoder_tree, load_params, params_to_numpy
from tinynerf_tpu_torch.core import OccupancyGrid, OccupancyState
from tinynerf_tpu_torch.models import KPlanesExplicitColorDecoder, KPlanesExplicitOpacityDecoder
from tinynerf_tpu_torch.ops import interp
from torch_world import CFG, F32_ATOL, make_scene, make_world

torch.set_num_threads(2)
T = torch.from_numpy


def _coords(rng, n):
    """Coordinates over and just past [-1, 1], with exact +-1 and 0."""
    c = rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    c[: n // 8] = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), (n // 8, 3))
    return c


@pytest.mark.parametrize("size", [(16, 16, 16), (8, 12, 20)])
def test_trilinear_occupancy_query_matches_jax(size):
    """Masks equal to JAX's on random grids (decayed values around the
    threshold) and coordinates; the looked-up values within 1e-6."""
    rng = np.random.default_rng(sum(size))
    grid = (rng.random(size) ** 4).astype(np.float32)
    coords = _coords(rng, 4096)
    jocc = JOccupancyGrid(size, 0.05, interp="trilinear")
    occ = OccupancyGrid(size, 0.05, interp="trilinear")
    jstate = JOccupancyState(grid=jnp.asarray(grid), mean=jnp.float32(grid.mean()))
    state = OccupancyState(grid=T(grid), mean=torch.tensor(float(grid.mean())))
    want = np.asarray(jocc.query(jstate, jnp.asarray(coords)))
    got = occ.query(state, T(coords)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.05 < want.mean() < 0.95  # both occupied and empty points
    vals = interp.trilinear_lookup(T(grid)[..., None], T(coords))[..., 0].numpy()
    jvals = np.asarray(jinterp.trilinear_lookup(jnp.asarray(grid)[..., None], jnp.asarray(coords))[..., 0])
    np.testing.assert_allclose(vals, jvals, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="interp"):
        OccupancyGrid(size, 0.05, interp="cubic")


def test_packed_render_with_trilinear_occupancy_matches_jax(tmp_path):
    """A packed render behind the shell occupancy queried trilinearly:
    the same samples (count) and colors within F32_ATOL; no skip march."""
    world = make_world(make_scene(tmp_path / "spheres"), dict(CFG, occupancy_interp="trilinear"))
    jr, r = world["jr"], world["renderers"]["float32"]
    assert jr.occupancy.interp == r.occupancy.interp == "trilinear"
    assert not r.supports_skip_march
    rng = np.random.default_rng(0)
    theta = rng.uniform(0, 2 * np.pi, 64)
    o = np.stack([4 * np.cos(theta), 4 * np.sin(theta), rng.uniform(-1, 2, 64)], -1).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, (64, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = jax.jit(lambda p, occ: jr.render_packed(p, occ, jnp.asarray(o), jnp.asarray(d), 2048))(
        world["params"], world["occ"])
    with torch.no_grad():
        out = r.render_packed(world["tocc"], T(o), T(d), 2048)
    assert int(out.n_samples) == int(ref.n_samples) > 0
    np.testing.assert_allclose(out.rgb.numpy(), np.asarray(ref.rgb), atol=F32_ATOL)


def _features(rng, n, dims=(8, 8, 8)):
    return tuple(rng.standard_normal((n, k)).astype(np.float32) * 0.5 for k in dims)


def test_explicit_decoders_match_jax():
    """Opacity and color (per sample and per ray) from JAX-initialized
    parameters carried by `convert.decoder_into`, within 1e-5 at f32; the
    features as pieces (how the renderer passes them) and whole."""
    rng = np.random.default_rng(1)
    fdim, n_rays, cap = 24, 13, 97
    pieces = _features(rng, cap)
    d_ray = rng.standard_normal((n_rays, 3)).astype(np.float32)
    d_ray /= np.linalg.norm(d_ray, axis=-1, keepdims=True)
    seg = np.sort(rng.integers(0, n_rays, cap))
    jop, jcol = JExplicitOpacity(fdim), JExplicitColor(fdim, n_freqs=8, hidden_dim=16)
    op_params = jax.tree_util.tree_map(np.asarray, jop.init(jax.random.PRNGKey(1)))
    col_params = jax.tree_util.tree_map(np.asarray, jcol.init(jax.random.PRNGKey(2)))
    op, col = KPlanesExplicitOpacityDecoder(fdim), KPlanesExplicitColorDecoder(fdim, n_freqs=8, hidden_dim=16)
    decoder_into(op, op_params, "sigma")
    decoder_into(col, col_params, "rgb")
    for tree, want in ((decoder_tree(op), op_params), (decoder_tree(col), col_params)):
        for a, b in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.detach().numpy(), tree)),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)

    jpieces = tuple(jnp.asarray(p) for p in pieces)
    tpieces = tuple(T(p) for p in pieces)
    with torch.no_grad():
        sigma = op(tpieces).numpy()
        np.testing.assert_allclose(op(torch.cat(tpieces, -1)).numpy(), sigma, rtol=1e-6)
        rgb = col(tpieces, T(d_ray[seg])).numpy()
        rgb_ray = col.apply_per_ray(tpieces, T(d_ray), T(seg)).numpy()
    np.testing.assert_allclose(sigma, np.asarray(jop.apply(op_params, jpieces)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rgb, np.asarray(jcol.apply(col_params, jpieces, jnp.asarray(d_ray[seg]))),
                               atol=1e-5)
    np.testing.assert_allclose(
        rgb_ray, np.asarray(jcol.apply_per_ray(col_params, jpieces, jnp.asarray(d_ray), jnp.asarray(seg))),
        atol=1e-5)
    assert sigma.shape == (cap,) and rgb.shape == rgb_ray.shape == (cap, 3)


def test_renderer_with_explicit_decoders_matches_jax(tmp_path):
    """A renderer whose decoders are the explicit ones: `load_params` and
    `params_to_numpy` carry their layout ({"linear": ...} for the opacity
    form), and the packed render (the per-ray color branch) and the dense
    one agree with JAX's within F32_ATOL."""
    world = make_world(make_scene(tmp_path / "spheres"))
    jr, r = world["jr"], world["renderers"]["float32"]
    fdim = jr.field.feature_dim
    jr = dataclasses.replace(jr, sigma_decoder=JExplicitOpacity(fdim),
                             rgb_decoder=JExplicitColor(fdim, n_freqs=8, hidden_dim=16))
    params = dict(jax.tree_util.tree_map(np.asarray, world["params"]))
    params["sigma"] = jax.tree_util.tree_map(np.asarray, jr.sigma_decoder.init(jax.random.PRNGKey(4)))
    params["rgb"] = jax.tree_util.tree_map(np.asarray, jr.rgb_decoder.init(jax.random.PRNGKey(5)))
    r.sigma_decoder = KPlanesExplicitOpacityDecoder(fdim)
    r.rgb_decoder = KPlanesExplicitColorDecoder(fdim, n_freqs=8, hidden_dim=16)
    load_params(r, params)
    back = params_to_numpy(r)
    assert set(back["sigma"]) == {"linear"} and set(back["rgb"]) == {"mlp"}
    rng = np.random.default_rng(3)
    o = np.tile(np.array([[0.0, -4.0, 0.5]], np.float32), (32, 1))
    d = np.stack([rng.uniform(-0.2, 0.2, 32), np.ones(32), rng.uniform(-0.2, 0.1, 32)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref_p = jr.render_packed(jp, world["occ"], jnp.asarray(o), jnp.asarray(d), 1024, rgb_dir_branch="ray")
    ref_d = jr.render_dense(jp, world["occ"], jnp.asarray(o), jnp.asarray(d))
    with torch.no_grad():
        out_p = r.render_packed(world["tocc"], T(o), T(d), 1024, rgb_dir_branch="ray")
        out_d = r.render_dense(world["tocc"], T(o), T(d))
    assert int(out_p.n_samples) == int(ref_p.n_samples) > 0
    np.testing.assert_allclose(out_p.rgb.numpy(), np.asarray(ref_p.rgb), atol=F32_ATOL)
    np.testing.assert_allclose(out_d.rgb.numpy(), np.asarray(ref_d.rgb), atol=F32_ATOL)
