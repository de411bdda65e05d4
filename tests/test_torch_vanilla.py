"""The vanilla field in the port against the JAX package: the field, its
renders (packed on both marches, and dense), checkpoints both ways, the
deterministic train step, `remat_field` (against JAX's remat step, and
against the port's step without it, for every field), and the command line
with `--method vanilla`.

Setup: tests/torch_world.py with `method="vanilla"` (posenc(10) into 10
layers of width 32, field_scale 0.07; 32 samples, occupancy 16), JAX
parameters carried over.  Tolerances: the field and renders f32 1e-4, bf16
2e-2 (one-ulp bf16 rounding flips between frameworks); the step's loss 1e-5
relative and gradients 1e-4 of each leaf's largest |g|.

Parity trap: JAX's jitted step reports gradients that differ from JAX's
own op-by-op gradient of the same loss by up to 2.4e-2 of a leaf's largest
entry on the field's first layers (XLA compiles the 10-layer stack on
posenc(10) inputs into other arithmetic), while the port agrees with the
op-by-op gradient to ~4e-7.  So the step's loss is held against
`make_train_step`'s, and its gradients against `jax.grad` of the
renderer's loss, evaluated op by op (`_jax_step`).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.data import RayPool as JRayPool
from tinynerf_tpu.data import parse_nerf_synthetic as jparse
from tinynerf_tpu.models import make_model as jmake_model
from tinynerf_tpu.parallel import make_mesh
from tinynerf_tpu.train import TrainConfig as JConfig
from tinynerf_tpu.train import loop as jloop
from tinynerf_tpu_torch.__main__ import main as cli_main
from tinynerf_tpu_torch.convert import load_params, params_to_numpy, tree_leaves_with_path
from tinynerf_tpu_torch.models import VanillaFeatureField, make_model
from tinynerf_tpu_torch.train import TrainConfig, build_renderer, make_optimizer, make_train_step
from torch_world import BF16_ATOL, CFG, COBAFA_CFG, F32_ATOL, VANILLA_CFG, make_scene, make_world

torch.set_num_threads(2)

T = torch.from_numpy
N_CAND = 64
ATOL = {"float32": F32_ATOL, "bfloat16": BF16_ATOL}
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(tmp_path_factory.mktemp("torch_vanilla_scene") / "spheres")


@pytest.fixture(scope="module")
def world(scene):
    return make_world(scene, VANILLA_CFG)


@pytest.fixture(scope="module")
def rays(scene):
    """64 rays through the middle rows of the training view, as numpy."""
    pool = JRayPool(jparse(scene, "train"))
    return tuple(np.asarray(a)[96 : 96 + N_CAND] for a in pool.arrays())


@pytest.mark.parametrize("field_scale", [0.07, 0.5, 1.0])
def test_make_model_vanilla_matches_jax(field_scale):
    """The width rule max(32, round(256 s)), 8 hidden layers on posenc(10),
    He init (zero biases, U(+-sqrt(6 / fan_in)) weights), declared groups."""
    jfield, _, jrgb = jmake_model("vanilla", field_scale=field_scale)
    field, sig, rgb = make_model("vanilla", field_scale=field_scale, device="meta")
    assert isinstance(field, VanillaFeatureField)
    assert field.feature_dim == jfield.feature_dim == max(32, int(round(256 * field_scale)))
    assert (field.table_keys, field.mlp_keys) == (jfield.table_keys, jfield.mlp_keys)
    shapes = [tuple(x["w"].shape) for x in jax.eval_shape(jfield.init, jax.random.PRNGKey(0))["mlp"]]
    assert [tuple(w.shape) for w in field.mlp.w] == shapes and len(shapes) == 10
    assert tuple(sig.mlp.w[0].shape) == (field.feature_dim, 64)
    small = VanillaFeatureField(hidden_features=32, generator=torch.Generator().manual_seed(0))
    for w, b in zip(small.mlp.w, small.mlp.b):
        assert float(b.detach().abs().max()) == 0.0 and float(w.detach().abs().max()) <= np.sqrt(6.0 / w.shape[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vanilla_field_matches_jax(world, dtype):
    x = np.random.default_rng(0).uniform(-1.0, 1.0, (4096, 3)).astype(np.float32)
    ref = world["jr"].field.apply(world["params"]["field"], jnp.asarray(x), JDTYPE[dtype])
    with torch.no_grad():
        (ours,) = world["renderers"][dtype].field.apply_pieces(T(x), TDTYPE[dtype])
    assert ours.dtype == TDTYPE[dtype] and tuple(ours.shape) == (4096, 32)
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32), atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vanilla_render_matches_jax(world, rays, dtype):
    """Behind the shell occupancy: packed (dense and skip march, the
    per-ray direction branch of serving) and dense renders against JAX's."""
    jr = dataclasses.replace(world["jr"], compute_dtype=JDTYPE[dtype])
    r = world["renderers"][dtype]
    o, d = jnp.asarray(rays[0]), jnp.asarray(rays[1])
    ref_p = jax.jit(lambda p, occ: jr.render_packed(p, occ, o, d, 2048, rgb_dir_branch="ray"))(
        world["params"], world["occ"])
    ref_d = jax.jit(lambda p, occ: jr.render_dense(p, occ, o, d))(world["params"], world["occ"])
    grid = r.skip_grid(world["tocc"])
    with torch.no_grad():
        packed = r.render_packed(world["tocc"], T(rays[0]), T(rays[1]), 2048, rgb_dir_branch="ray")
        skip = r.render_packed(world["tocc"], T(rays[0]), T(rays[1]), 2048, rgb_dir_branch="ray",
                               march="skip", skip_grid=grid)
        dense = r.render_dense(world["tocc"], T(rays[0]), T(rays[1]))
    assert int(packed.n_samples) == int(skip.n_samples) == int(ref_p.n_samples) > 0
    for out in (packed, skip):
        np.testing.assert_allclose(out.rgb.numpy(), np.asarray(ref_p.rgb), atol=ATOL[dtype])
    np.testing.assert_allclose(dense.rgb.numpy(), np.asarray(ref_d.rgb), atol=ATOL[dtype])


def test_vanilla_checkpoint_round_trip(world, rays):
    """Port parameters (a torch init) into the JAX renderer, which renders
    what the port renders; and back into a second port renderer, equal."""
    cfg = TrainConfig(compute_dtype="float32", **VANILLA_CFG)
    r = build_renderer(cfg, world["pset"].scene_scale, world["pset"].bg_color, device="cpu",
                       generator=torch.Generator().manual_seed(9))
    tree = params_to_numpy(r)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(world["params"])
    with torch.no_grad():
        ours = r.render_dense(world["tocc"], T(rays[0]), T(rays[1]))
    ref = world["jr"].render_dense(jax.tree_util.tree_map(jnp.asarray, tree), world["occ"],
                                   jnp.asarray(rays[0]), jnp.asarray(rays[1]))
    np.testing.assert_allclose(ours.rgb.numpy(), np.asarray(ref.rgb), atol=F32_ATOL)
    r2 = build_renderer(cfg, world["pset"].scene_scale, world["pset"].bg_color, device="cpu")
    load_params(r2, tree)
    for a, b in zip(r.parameters(), r2.parameters()):
        assert torch.equal(a, b)


def _jax_step(world, rays, cfg, remat=False):
    """The loss of JAX's deterministic step, and the gradient of that loss
    (the packed render's per-ray MSE over valid rays) by `jax.grad`, op by
    op, from the all-occupied grid."""
    jcfg = JConfig(compute_dtype="float32", **cfg)
    jr = dataclasses.replace(world["jr"], remat_field=remat)
    jopt = jloop.make_optimizer(jcfg)
    step = jloop.make_train_step(jr, jopt, jcfg, make_mesh(jax.devices()[:1]), n_cand=N_CAND,
                                 deterministic=True)
    params = jax.tree_util.tree_map(jnp.array, world["params"])
    o, d, rgb = (jnp.asarray(a) for a in rays)
    _, _, m = step(params, jopt.init(params), jr.occupancy.init_state(), o, d, rgb, jax.random.PRNGKey(0))
    occ = jr.occupancy.init_state()

    def loss_fn(p):
        out = jr.render_packed(p, occ, o, d, jcfg.sample_cap)
        per_ray = jnp.mean((out.rgb - rgb) ** 2, axis=-1)
        return jnp.sum(per_ray * out.ray_valid) / jnp.maximum(jnp.sum(out.ray_valid), 1.0)

    grads = jax.grad(loss_fn)(jax.tree_util.tree_map(jnp.array, world["params"]))  # the step donated its own
    return float(m["loss"]), jax.tree_util.tree_leaves(grads)


def _port_step(world, rays, cfg, remat=None):
    tcfg = TrainConfig(compute_dtype="float32", remat_field=remat, **cfg)
    r = build_renderer(tcfg, world["pset"].scene_scale, world["pset"].bg_color, device="cpu")
    assert r.remat_field is bool(remat)
    load_params(r, jax.tree_util.tree_map(np.asarray, world["params"]))
    step = make_train_step(r, make_optimizer(tcfg, r), tcfg, n_cand=N_CAND, deterministic=True)
    m = step(r.occupancy.init_state(), *(T(a) for a in rays))
    return float(m["loss"]), [np.asarray(v) for _, v in tree_leaves_with_path(m["grads"])]


def _assert_step_close(ours, ref):
    loss, g = ours
    jloss, jg = ref
    assert loss == pytest.approx(jloss, rel=1e-5)
    assert len(g) == len(jg) > 0
    for a, b in zip(g, jg):
        scale = np.abs(b).max()
        assert scale > 0
        np.testing.assert_allclose(a, b, atol=1e-4 * scale)


def test_vanilla_train_step_matches_jax(world, rays):
    """The deterministic step from the all-occupied grid: loss and every
    gradient leaf (the field's ten layers and both decoders)."""
    _assert_step_close(_port_step(world, rays, VANILLA_CFG), _jax_step(world, rays, VANILLA_CFG))


def test_vanilla_remat_step_matches_jax_and_no_remat(world, rays):
    """`remat_field=True`: the port's step against JAX's remat step and
    against the port's step without remat."""
    ours = _port_step(world, rays, VANILLA_CFG, remat=True)
    _assert_step_close(ours, _jax_step(world, rays, VANILLA_CFG, remat=True))
    _assert_step_close(ours, _port_step(world, rays, VANILLA_CFG, remat=False))


@pytest.mark.parametrize("method", ["vanilla", "kplanes", "cobafa"])
def test_remat_recomputes_the_field_with_the_same_values(method):
    """For every field, a jittered packed render with dropout words (Cobafa
    draws its mask from them) and its backward, with and without remat:
    equal losses and gradients, the field run twice with remat (the
    recompute) and once without, and once under inference_mode."""
    cfg = dict({"vanilla": VANILLA_CFG, "kplanes": CFG, "cobafa": COBAFA_CFG}[method], compute_dtype="float32")
    rng = np.random.default_rng(3)
    d = rng.normal(size=(N_CAND, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = T(-3.0 * d + 0.2 * rng.normal(size=(N_CAND, 3)).astype(np.float32)), T(d)
    seeds = dict(jitter_seed=[123, 456], dropout_seed=[789, 1011])
    results = {}
    for remat in (False, True):
        r = build_renderer(TrainConfig(remat_field=remat, **cfg), 1.0, None, device="cpu")
        calls = []
        apply = r.field.apply_pieces
        r.field.apply_pieces = lambda *a, **k: calls.append(1) or apply(*a, **k)
        out = r.render_packed(r.occupancy.init_state(), o, d, 2048, **seeds)
        loss = (out.rgb ** 2).mean()
        grads = torch.autograd.grad(loss, list(r.parameters()))
        assert len(calls) == (2 if remat else 1)
        with torch.inference_mode():
            r.render_packed(r.occupancy.init_state(), o, d, 2048, **seeds)
        assert len(calls) == (3 if remat else 2)
        results[remat] = (float(loss.detach()), [g.numpy() for g in grads])
    _assert_step_close(results[True], results[False])


def test_remat_rule():
    """None takes the JAX rule (vanilla above 2,000,000 samples a step);
    True and False set it."""
    for method, batch, want in (("vanilla", 2048, False), ("vanilla", 8192, True), ("kplanes", 8192, False)):
        cfg = TrainConfig(method=method, batch_size=batch, field_scale=0.07, occupancy_res=8)
        assert cfg.sample_cap > 2_000_000 or not want
        assert build_renderer(cfg, 1.0, None, device="meta").remat_field is want
    for remat in (True, False):
        cfg = TrainConfig(method="kplanes", remat_field=remat, field_scale=0.07, occupancy_res=8)
        assert build_renderer(cfg, 1.0, None, device="meta").remat_field is remat


def test_cli_vanilla(scene, tmp_path):
    """`python -m tinynerf_tpu_torch --method vanilla --remat on` trains (0
    steps: the final render and checkpoint) and renders the checkpoint back
    with --render_only."""
    base = ["--data", str(scene), "--datatype", "synthetic", "--method", "vanilla", "--batch_size", "64",
            "--n_samples", "32", "--field_scale", "0.07", "--device", "cpu", "--remat", "on"]
    cli_main(base + ["--output", str(tmp_path / "runs"), "--steps", "0"])
    (exp,) = (tmp_path / "runs").iterdir()
    assert exp.name.endswith("_vanilla_aabb_32") and (exp / "ckpt_0.pkl").exists()
    assert json.loads((exp / "metrics_test.json").read_text())
    cli_main(base + ["--output", str(exp), "--render_only"])
    assert (exp / "render_0000.png").exists() and (exp / "metrics_render.json").exists()
