"""The port's data-parallel step and serving over two gloo ranks on the CPU
against the JAX package's 2-device mesh.

One spawn of two ranks (`tests/torch_dist_worker.py`, jax-free) runs every
variant: the deterministic step replicated, with `shard_tables` and with
`shard_tables` + `shard_bwd`, each from the same JAX-initialized parameters
on the same 64-ray global batch; then the dense and packed serving chunks
and the occupancy sweep over the group against one rank.  The JAX side is
`make_train_step(..., deterministic=True)` on `make_mesh(jax.devices()[:2])`
with the same field as tests/test_zero.py (planes 9/17/33 x 8 features,
color decoder 16 x 2), run while the ranks work.

Tolerances, those of tests/test_zero.py:234-256: loss 1e-5 relative;
gradients and updated parameters rtol 1e-4, atol 1e-6.  Serving chunks
1e-5 against one rank (tests/test_parallel.py's), the occupancy sweep bit
for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch_dist_worker
from tinynerf_tpu.data import RayPool as JRayPool
from tinynerf_tpu.data import parse_nerf_synthetic as jparse
from tinynerf_tpu.models.kplanes import KPlanesFeatureField as JKPlanes
from tinynerf_tpu.models.vanilla import ColorDecoder as JColorDecoder
from tinynerf_tpu.models.vanilla import OpacityDecoder as JOpacityDecoder
from tinynerf_tpu.parallel import make_mesh
from tinynerf_tpu.parallel.zero import table_mask_tree as jtable_mask_tree
from tinynerf_tpu.train import TrainConfig as JConfig
from tinynerf_tpu.train import loop as jloop
from tinynerf_tpu_torch.convert import tree_leaves_with_path
from torch_world import make_scene

N_CAND = 64
CFG = dict(method="kplanes", scene_type="aabb", batch_size=64, n_samples=16, steps=3, occupancy_res=16,
           compute_dtype="float32", tv_reg_alpha=1e-4, l1_reg_alpha=1e-5)
VARIANTS = {"replicated": {}, "zero": dict(shard_tables=True),
            "zero_bwd": dict(shard_tables=True, shard_bwd=True)}


def _jax_renderer(jcfg, pool):
    jr = jloop.build_renderer(jcfg, pool.scene_scale, pool.bg_color)
    small = JKPlanes(feature_dim_per_plane=8, resolutions=(9, 17, 33))
    return dataclasses.replace(
        jr, field=small, sigma_decoder=JOpacityDecoder(feature_dim=small.feature_dim),
        rgb_decoder=JColorDecoder(n_freqs=8, in_features=small.feature_dim, hidden_features=16, hidden_layers=2))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results by variant, the ranks' results)."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    scene = make_scene(tmp / "spheres")
    pool = JRayPool(jparse(scene, "train"))
    # the 64 rays through the middle rows of the view (they cross the spheres)
    rays = tuple(np.asarray(a)[96 : 96 + N_CAND] for a in pool.arrays())
    jcfg = JConfig(**CFG)
    jr = _jax_renderer(jcfg, pool)
    params0 = jax.tree_util.tree_map(np.asarray, jr.init(jax.random.PRNGKey(3)))
    payload = dict(rays=rays, cfg=CFG, params=params0, scene_scale=float(pool.scene_scale),
                   bg_color=np.asarray(pool.bg_color), variants=VARIANTS)
    ctx, path = torch_dist_worker.spawn("steps", payload, tmp)

    mesh = make_mesh(jax.devices()[:2])
    sh = NamedSharding(mesh, P("data"))
    pools = tuple(jax.device_put(a, sh) for a in rays)
    jopt = jloop.make_optimizer(jcfg)
    ref = {}
    for name, kw in VARIANTS.items():
        c = dataclasses.replace(jcfg, **kw)
        step = jloop.make_train_step(jr, jopt, c, mesh, n_cand=N_CAND, deterministic=True)
        params = jax.tree_util.tree_map(jnp.array, params0)
        opt_state = jloop.init_opt_state(jr, jopt, c, mesh, params)
        p1, os1, m = step(params, opt_state, jr.occupancy.init_state(), *pools, jax.random.PRNGKey(7))
        ref[name] = dict(loss=float(m["loss"]), grads=jax.tree_util.tree_map(np.asarray, m["grads"]),
                         params=jax.tree_util.tree_map(np.asarray, p1),
                         opt_state=jax.tree_util.tree_map(np.asarray, os1))
    return ref, torch_dist_worker.join(ctx, path)


def _leaves(tree):
    return [np.asarray(v) for _, v in tree_leaves_with_path(tree)]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_group_step_matches_jax_mesh(runs, variant):
    """Loss, every gradient leaf and every updated parameter of the 2-rank
    step against the JAX 2-device step of the same variant."""
    ref, ours = runs[0][variant], runs[1][variant]
    assert ours["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    jg = jax.tree_util.tree_leaves(ref["grads"])
    g = _leaves(ours["grads"])
    assert len(g) == len(jg) > 0
    for a, b in zip(g, jg):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    assert sum(int(np.count_nonzero(b)) for b in jg if b.ndim == 3) > 100  # the tables got gradients
    for a, b in zip(_leaves(ours["params"]), jax.tree_util.tree_leaves(ref["params"])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    assert ours["rays_used"] == N_CAND


def test_zero_opt_state_matches_jax_layout(runs):
    """The shard_tables step's Adam state (all-gathered on the host) has
    JAX's `init_opt_state` layout for 2 devices: the table moments flat,
    of a length divisible by 2, every leaf of JAX's shape, the counts 1,
    and the moments within the step's tolerance of JAX's."""
    ref, ours = runs[0]["zero"]["opt_state"], runs[1]["zero"]["opt_state"]
    assert int(ours.count) == int(ref.count) == 1
    for moment in ("mu", "nu"):
        mine, theirs = getattr(ours, moment), getattr(ref, moment)
        assert [p for p, _ in tree_leaves_with_path(mine)] == [
            tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(theirs)[0]]
        flat_tables = 0
        masks = jax.tree_util.tree_leaves(jtable_mask_tree(theirs, frozenset({"planes"})))
        for a, b, is_table in zip(_leaves(mine), jax.tree_util.tree_leaves(theirs), masks):
            assert a.shape == b.shape
            if is_table:
                assert a.ndim == 1 and a.shape[0] % 2 == 0
                flat_tables += 1
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-9)
        assert flat_tables == 9


@pytest.mark.parametrize("path", ["dense", "packed"])
def test_sharded_render_chunk_matches_one_rank(runs, path):
    """The serving chunk split over two ranks and gathered, against one
    rank, behind the shell occupancy; the packed path's flags and counts
    equal."""
    one, many = runs[1][f"render_{path}"]
    np.testing.assert_allclose(many[0], one[0], atol=1e-5)
    for a, b in zip(one[1:], many[1:]):
        np.testing.assert_array_equal(a, b)


def test_sharded_occupancy_update_matches_one_rank(runs):
    """The sweep split into two x-slabs and all-gathered equals the one-rank
    sweep bit for bit; it both confirmed and decayed voxels."""
    (g1, m1), (g2, m2) = runs[1]["occupancy"]
    np.testing.assert_array_equal(g2, g1)
    assert m2 == m1
    assert 0 < np.mean(g1 == 1.0) < 1
