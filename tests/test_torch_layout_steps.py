"""The training slice in each of the fields' other lookup layouts against
the JAX package: one deterministic step (`make_train_step(deterministic=
True)` in both packages, f32 compute, 64 rays of a test view with random
colors) of K-Planes with `lookup_mode` "quad", "mixed" (f32 and bf16
scatter) and "plain" and `fwd_mode="fusedfine"`, and of Cobafa with "mixed"
and "plain"; and `train()` taking a few steps in each layout.

Setup as tests/torch_world.py (planes 9/17/33; Cobafa basis grids
8/8/8/8/10/12, coefficients 8^3 x 6, the full-width field MLP), the JAX
field replaced with the same options.  The Cobafa step gets the JAX march's
sample positions (tests/test_torch_cobafa_slice.py: its 7-layer MLP makes
the gradients sensitive to last-bit position differences).  Tolerances as
tests/test_torch_train_slice.py: the loss 1e-5 relative, every gradient
leaf 1e-4 of its largest magnitude; with the bf16 scatter the plane
gradients 2^-5 of their largest (JAX's chain of bf16 adds; the op test in
tests/test_torch_lookup_modes.py bounds it value by value).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.parallel import make_mesh
from tinynerf_tpu.train import TrainConfig as JConfig
from tinynerf_tpu.train import loop as jloop
from tinynerf_tpu_torch.convert import load_params, tree_leaves_with_path
from tinynerf_tpu_torch.data import RayPool, parse_nerf_synthetic
from tinynerf_tpu_torch.ops import octbuild
from tinynerf_tpu_torch.train import TrainConfig, build_renderer, make_optimizer, make_train_step, train
from tinynerf_tpu_torch.train import loop as loop_mod
from torch_world import CFG, COBAFA_CFG, make_scene, make_world

torch.set_num_threads(2)

T = torch.from_numpy
N_CAND = 64
LAYOUTS = {  # id: (method, field options)
    "kplanes_quad": ("kplanes", dict(lookup_mode="quad")),
    "kplanes_mixed": ("kplanes", dict(lookup_mode="mixed")),
    "kplanes_mixed_bf16_scatter": ("kplanes", dict(lookup_mode="mixed", scatter_dtype="bfloat16")),
    "kplanes_plain": ("kplanes", dict(lookup_mode="plain")),
    "kplanes_fusedfine": ("kplanes", dict(fwd_mode="fusedfine")),
    "cobafa_mixed": ("cobafa", dict(lookup_mode="mixed")),
    "cobafa_plain": ("cobafa", dict(lookup_mode="plain")),
}
CFGS = {"kplanes": CFG, "cobafa": COBAFA_CFG}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(tmp_path_factory.mktemp("layout_scene") / "spheres")


@pytest.fixture(scope="module")
def worlds(scene):
    return {method: make_world(scene, cfg) for method, cfg in CFGS.items()}


def _rays(world):
    """64 rays of test view 0 with random colors, as numpy."""
    rng = np.random.default_rng(9)
    o = np.asarray(world["jset"].rays_o[0]).reshape(-1, 3)
    d = np.asarray(world["jset"].rays_d[0]).reshape(-1, 3)
    pick = rng.choice(o.shape[0], N_CAND, replace=False)
    return o[pick], d[pick], rng.uniform(0, 1, (N_CAND, 3)).astype(np.float32)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layout_step_matches_jax(worlds, layout):
    method, options = LAYOUTS[layout]
    world, base = worlds[method], CFGS[method]
    rays = _rays(world)
    jr = world["jr"]
    jr = dataclasses.replace(jr, field=dataclasses.replace(jr.field, **options))
    jcfg = JConfig(compute_dtype="float32", **base)
    jopt = jloop.make_optimizer(jcfg)
    jstep = jloop.make_train_step(jr, jopt, jcfg, make_mesh(jax.devices()[:1]), n_cand=N_CAND,
                                  deterministic=True)
    params = jax.tree_util.tree_map(jnp.array, world["params"])
    _, _, m = jstep(params, jopt.init(params), jr.occupancy.init_state(), *(jnp.asarray(a) for a in rays),
                    jax.random.PRNGKey(0))

    cfg = TrainConfig(compute_dtype="float32", **base)
    r = build_renderer(cfg, world["pset"].scene_scale, world["pset"].bg_color, device="cpu")
    load_params(r, jax.tree_util.tree_map(np.asarray, world["params"]))
    for k, v in options.items():
        setattr(r.field, k, v)
    if method == "cobafa":  # JAX's sample positions
        march = jax.jit(jr._march)(jnp.asarray(rays[0]), jnp.asarray(rays[1]), jr.occupancy.init_state(), None)
        r._march = lambda *args, **kw: tuple(T(np.array(a)) for a in march)
    step = make_train_step(r, make_optimizer(cfg, r), cfg, n_cand=N_CAND, deterministic=True)
    launches = octbuild.build_quad.launches, octbuild.build_oct.launches
    ours = step(r.occupancy.init_state(), *(T(a) for a in rays))
    assert (octbuild.build_quad.launches, octbuild.build_oct.launches) == launches  # CPU: plain versions
    assert float(ours["loss"]) == pytest.approx(float(m["loss"]), rel=1e-5)
    g = [np.asarray(v) for _, v in tree_leaves_with_path(ours["grads"])]
    jg = [np.asarray(v) for v in jax.tree_util.tree_leaves(m["grads"])]
    assert len(g) == len(jg) > 0
    bf16_tables = options.get("scatter_dtype") == "bfloat16"
    n_tables = 9 if method == "kplanes" else 7
    for k, (a, b) in enumerate(zip(g, jg)):
        is_table = (k < n_tables) if method == "cobafa" else (a.ndim == 3)
        tol = 2.0**-5 if bf16_tables and is_table else 1e-4
        np.testing.assert_allclose(a, b, atol=tol * np.abs(b).max())
    assert sum(int(np.count_nonzero(a)) for a in g[:n_tables] if a.ndim >= 3) > 100  # the tables got gradients


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_train_runs_in_every_layout(scene, tmp_path, layout, monkeypatch):
    """`train()` through the registry with the layout's options (as
    tools/quality_run_torch.py passes them): finite losses for 3 steps, the
    field built with the options, the plain versions on CPU tensors."""
    method, options = LAYOUTS[layout]
    orig = loop_mod.make_model
    monkeypatch.setattr(loop_mod, "make_model", lambda m, **kw: orig(m, **kw, **options))
    cfg = TrainConfig(**dict(CFGS[method], output=tmp_path / "exp", steps=3, ray_buckets=(1,),
                             compute_dtype="float32"))
    out = train(cfg, RayPool(parse_nerf_synthetic(scene, "train")), device="cpu")
    losses = [m.loss for m in out["train_metrics"]]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    for k, v in options.items():
        assert getattr(out["renderer"].field, k) == v
