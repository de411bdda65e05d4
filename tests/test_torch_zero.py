"""The port's ZeRO-1 pieces and data-parallel checkpoints against the JAX
package: the flat table views and their classification by declared keys,
the row-partitioned TV / L1 regularizers, the pullback split by row bands,
the occupancy sweep split by x-slabs (all in one process, no group), and
checkpoints written by `train()` over two gloo ranks with `shard_tables`
(one spawn of two ranks, `tests/torch_dist_worker.py`).

Tolerances: partials summed 1e-5 relative (tests/test_zero.py's), their
gradients summed 1e-5 / 1e-8; the banded pullback 1e-6 (f32 sums of a few
terms in another order); views and slabs exact; a resumed run's parameters
1e-6 / 1e-7 of a straight run's (tests/test_torch_train_slice.py's).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_worker
from tinynerf_tpu.models.kplanes import KPlanesFeatureField as JKPlanes
from tinynerf_tpu.ops import interp as jinterp
from tinynerf_tpu.parallel import make_mesh
from tinynerf_tpu.parallel import zero as jzero
from tinynerf_tpu.train import TrainConfig as JConfig
from tinynerf_tpu.train import loop as jloop
from tinynerf_tpu.train.checkpoint import latest_checkpoint as jlatest_checkpoint
from tinynerf_tpu.train.checkpoint import load_checkpoint as jload_checkpoint
from tinynerf_tpu_torch.convert import tree_leaves_with_path
from tinynerf_tpu_torch.data import RayPool, parse_nerf_synthetic
from tinynerf_tpu_torch.models import KPlanesFeatureField
from tinynerf_tpu_torch.ops import interp
from tinynerf_tpu_torch.parallel import zero
from tinynerf_tpu_torch.train import TrainConfig, train
from tinynerf_tpu_torch.utils import make_shell_occupancy
from torch_world import CFG, make_scene

try:  # jax >= 0.6 stable API
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(2)
T = torch.from_numpy
KEY = jax.random.PRNGKey(0)


def _planes_from_jax(field: JKPlanes, params) -> KPlanesFeatureField:
    ours = KPlanesFeatureField(field.feature_dim_per_plane, field.resolutions)
    with torch.no_grad():
        for s, scale in enumerate(params["planes"]):
            for p, plane in enumerate(scale):
                ours.planes[s][p].copy_(T(np.array(plane)))
    return ours


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_views_classify_by_declared_keys(n):
    """Table leaves are found by the declared keys through the parameter
    tree and through a tree that embeds it (Adam's mu); the global view
    flattens and zero-pads only those, as JAX's does, and the local slices
    of the n ranks put back together are the global view."""
    rng = np.random.default_rng(n)
    tree = {"field": {"planes": [[rng.random((5, 5, 2), dtype=np.float32)]], "extra_mlp": np.zeros(3, np.float32)},
            "sigma": {"linear": {"w": rng.random((4, 4), dtype=np.float32)}}}
    tk = frozenset({"planes"})
    mask = zero.table_mask_tree(tree, tk)
    assert mask["field"]["planes"][0][0] is True
    assert mask["field"]["extra_mlp"] is False and mask["sigma"]["linear"]["w"] is False
    wrapped = {"mu": tree, "count": np.zeros(())}
    assert zero.table_mask_tree(wrapped, tk)["mu"]["field"]["planes"][0][0] is True
    assert zero.has_tables(tree, tk) and not zero.has_tables({"field": {"mlp": []}}, tk)

    tt = jax.tree_util.tree_map(T, tree)
    view = zero.global_view(tt, tk, n)
    jview = jzero.global_view(jax.tree_util.tree_map(jnp.asarray, tree), tk, n)
    for (_, a), b in zip(tree_leaves_with_path(view), jax.tree_util.tree_leaves(jview)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    v = view["field"]["planes"][0][0]
    assert v.ndim == 1 and v.shape[0] % n == 0 and v.shape[0] >= 50
    parts = [zero.local_view(tt, tk, n, i)["field"]["planes"][0][0] for i in range(n)]
    assert all(p.shape[0] == v.shape[0] // n for p in parts)
    np.testing.assert_array_equal(torch.cat(parts).numpy(), v.numpy())
    assert view["sigma"]["linear"]["w"].shape == (4, 4)


@pytest.mark.parametrize("n_blocks", [1, 2, 3, 8])
def test_tv_l1_partials_sum_to_full_and_match_jax(n_blocks):
    """sum_k loss_*_partial(k, n) == loss_*() and the gradients summed over
    blocks == the full gradients, for block counts that do and do not divide
    the (odd) plane rows; each block's value equals the JAX partial's."""
    jfield = JKPlanes(feature_dim_per_plane=4, resolutions=(9, 17), init_range=(0.0, 1.0))
    jparams = jfield.init(KEY)
    field = _planes_from_jax(jfield, jparams)
    planes = list(field.parameters())
    for full_fn, part_fn, jpart in ((field.loss_tv, field.loss_tv_partial, jfield.loss_tv_partial),
                                    (field.loss_l1, field.loss_l1_partial, jfield.loss_l1_partial)):
        jfn = jax.jit(lambda p, k: jpart(p, k, n_blocks))
        full = full_fn()
        g_full = torch.autograd.grad(full, planes)
        total, g_sum = 0.0, [torch.zeros_like(p) for p in planes]
        for k in range(n_blocks):
            part = part_fn(k, n_blocks)
            assert part.item() == pytest.approx(float(jfn(jparams, jnp.int32(k))), rel=1e-5, abs=1e-9)
            total += part.item()
            for acc, g in zip(g_sum, torch.autograd.grad(part, planes, allow_unused=True)):
                if g is not None:
                    acc += g
        assert total == pytest.approx(full.item(), rel=1e-5)
        for a, b in zip(g_sum, g_full):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_banded_pullback_matches_full_and_jax_bands(n):
    """Given the summed fine gradient, the n bands' outputs sum to
    `_pullback_scales` of it, and band b is the JAX `_sharded_pullback`
    output of device b of an n-device mesh (device 0 holding the whole quad
    gradient, the others zeros, so its psum_scatter hands each device its
    band of the same fine gradient)."""
    rng = np.random.default_rng(n)
    res, f = (9, 17, 33), 8
    r_fine, f_tot = res[-1], f * len(res)
    gq = rng.standard_normal(((r_fine - 1) ** 2, 4 * f_tot)).astype(np.float32)
    tables = [torch.zeros(r, r, f) for r in res]
    fine = interp._fine_from_quad(T(gq), r_fine, f_tot)
    unit = interp.sharded_pullback_unit(r_fine, res)
    band = -(-r_fine // (unit * n)) * unit
    padded = torch.cat([fine, fine.new_zeros(band * n - r_fine, r_fine, f_tot)])
    bands = [interp.pullback_band(padded[b * band : (b + 1) * band], tables, r_fine, b, n) for b in range(n)]
    for s, want in enumerate(interp._pullback_scales(fine, tables)):
        got = sum(out[s] for out in bands)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6 * float(want.abs().max()))

    mesh = make_mesh(jax.devices()[:n])
    jtables = ((tuple(jnp.zeros((r, r, f)) for r in res)),)
    per_dev = np.zeros((n,) + gq.shape, np.float32)
    per_dev[0] = gq

    def body(g):
        (grads,) = jinterp._sharded_pullback((g[0],), jtables, r_fine, f_tot, ("data", n))
        return tuple(x[None] for x in grads)

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),), out_specs=(P("data"),) * len(res),
                           check_vma=False))
    jbands = [np.asarray(x) for x in fn(jnp.asarray(per_dev))]
    for b in range(n):
        for s in range(len(res)):
            np.testing.assert_allclose(bands[b][s].numpy(), jbands[s][b], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_occupancy_slabs_equal_the_sweep(n):
    """The x-slabs of `update_slab`, put together, are `update`'s grid bit
    for bit (each slab from its own slices and jitter alone)."""
    field = KPlanesFeatureField(feature_dim_per_plane=4, resolutions=(9, 17),
                                generator=torch.Generator().manual_seed(0))
    from tinynerf_tpu_torch.core import OccupancyGrid

    occ = OccupancyGrid.cube(16, 0.05)
    state = make_shell_occupancy(occ)

    # densities above zero for about half the voxels
    med = torch.median(field(torch.rand(4096, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1).sum(-1))

    def sigma_fn(x):
        return 100.0 * torch.relu(field(x).sum(-1) - med)

    jitter = torch.rand((16, 16, 16, 3), generator=torch.Generator().manual_seed(n))
    whole = occ.update(state, sigma_fn, jitter=jitter).grid
    slabs = torch.cat([occ.update_slab(state, sigma_fn, jitter, b, n) for b in range(n)])
    np.testing.assert_array_equal(slabs.numpy(), whole.numpy())
    assert 0 < float((whole == 1.0).float().mean()) < 1


# ------------------------------------------------ checkpoints over two ranks


def _train_kw(**kw):
    return dict(CFG, occupancy_update_every=2, compute_dtype="float32", ray_buckets=(1,), lr_milestones=(),
                shard_tables=True, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two ranks, shard_tables: 3 steps (a checkpoint each), a resume to 5,
    and 5 straight; returns (the first run's directory, the ranks' result,
    the scene)."""
    tmp = tmp_path_factory.mktemp("torch_zero")
    scene = make_scene(tmp / "spheres")
    a, b = tmp / "a", tmp / "b"
    ctx, path = torch_dist_worker.spawn("train", dict(scene=str(scene), dirs=(str(a), str(b)), cfg=_train_kw()), tmp)
    return a, torch_dist_worker.join(ctx, path), scene


def test_sharded_checkpoint_has_jax_layout(runs):
    """The checkpoint of a 2-rank shard_tables run: the JAX reader loads it,
    its meta is {"shard_tables": True, "n_devices": 2}, and its Adam state
    has the structure and shapes of JAX's `init_opt_state` for 2 devices
    (the table moments flat [Lp])."""
    a, res, scene = runs
    assert len(res["first_losses"]) == 3 and np.all(np.isfinite(res["first_losses"]))
    assert jlatest_checkpoint(a).name == "ckpt_5.pkl"  # the resume's
    step, state = jload_checkpoint(a / "ckpt_3.pkl")
    assert step == 3 and state["meta"] == {"shard_tables": True, "n_devices": 2}
    assert int(state["opt_state"].count) == 3
    from tinynerf_tpu.data import RayPool as JRayPool
    from tinynerf_tpu.data import parse_nerf_synthetic as jparse

    jpool = JRayPool(jparse(scene, "train"))
    jcfg = JConfig(**_train_kw(output=a))
    jr = jloop.build_renderer(jcfg, jpool.scene_scale, jpool.bg_color)
    jparams = jax.tree_util.tree_map(np.asarray, jr.init(KEY))
    ref = jloop.init_opt_state(jr, jloop.make_optimizer(jcfg), jcfg, make_mesh(jax.devices()[:2]), jparams)
    for got, want in ((state["opt_state"].mu, ref.mu), (state["opt_state"].nu, ref.nu),
                      (state["params"], jparams)):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for x, y in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert x.shape == y.shape and x.dtype == np.float32
    flat = [x for x in jax.tree_util.tree_leaves(state["opt_state"].mu) if x.ndim == 1 and x.size % 2 == 0
            and x.size > 1000]
    assert len(flat) == 9


def test_resume_with_the_same_group_continues(runs):
    """Resumed at step 3 on the same two ranks, the run takes steps 4-5 and
    lands where 5 straight steps land."""
    _, res, _ = runs
    assert res["resumed_steps"] == 2
    for (_, x), (_, y) in zip(tree_leaves_with_path(res["resumed"]), tree_leaves_with_path(res["straight"])):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)


def test_resume_with_another_group_size_raises(runs, tmp_path):
    """A shard_tables checkpoint of two ranks does not resume on one (nor
    without shard_tables), as in the JAX package."""
    a, _, scene = runs
    exp = tmp_path / "exp"
    shutil.copytree(a, exp)
    pool = RayPool(parse_nerf_synthetic(scene, "train"))
    for kw in ({}, dict(shard_tables=False)):
        cfg = TrainConfig(**dict(_train_kw(output=exp, steps=5), **kw))
        with pytest.raises(ValueError, match="shard_tables"):
            train(cfg, pool, resume=True, device="cpu")
