"""The port's Cobafa pieces against the JAX package's: the oct cell-pack
build, `sawtooth`, the cell/weight rule, `trilinear_lookup_oct` and its
table gradient, the field (JAX's `lookup_mode="quad"`, the oct layout its
TPU runs), its dropout, the registry and the parameter interchange.

Inputs are made with numpy from a seed; parameters are initialized by the
JAX package and carried across with `tinynerf_tpu_torch.convert`.  The
field is the small one of tests/torch_world.py (`COBAFA_CFG`: basis grids
8/8/8/8/10/12, channels 8/8/8/4/4/4, coefficients 8^3 x 6).

Tolerances: the oct build and `sawtooth` bit-equal (a relayout with one
rounding; the same floor mod); the lookup at an f32 gather 1e-6 and its
table gradient 1e-5 (tests/test_interp.py:113-114: f32 sums in another
order); the field 1e-4 at f32 compute and 2e-2 at bf16 (tests/torch_world.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.models import make_model as jmake_model
from tinynerf_tpu.ops import interp as jinterp
from tinynerf_tpu.ops.octbuild import build_oct_pallas, build_oct_ref
from tinynerf_tpu_torch.convert import load_params, param_tree, params_to_numpy, tree_leaves_with_path
from tinynerf_tpu_torch.models import CobafaFeatureField, make_model
from tinynerf_tpu_torch.models import cobafa as tcobafa
from tinynerf_tpu_torch.ops import interp, octbuild
from tinynerf_tpu_torch.train import TrainConfig, build_renderer, make_optimizer
from torch_world import BF16_ATOL, COBAFA_CFG

torch.set_num_threads(2)

T = torch.from_numpy
SCALE = COBAFA_CFG["field_scale"]
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-4), "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_ATOL)}
OCT_SHAPES = [(5, 6, 7, 3), (9, 9, 9, 4), (9, 17, 9, 4), (6, 6, 6, 8), (7, 5, 6, 6)]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _points(n=500, seed=0):
    """Points in [-1, 1]^3 with the box's corners, faces and centre."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    x[:4] = [[-1, -1, -1], [1, 1, 1], [0, 0, 0], [1, -1, 0.5]]
    return x


@pytest.mark.parametrize("shape", OCT_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_oct_plain_bit_equal_to_jax(shape, dtype):
    """The plain build against JAX's reference and its Pallas kernel in
    interpret mode (the kernel the CUDA build replaces), and the wrapper on
    a CPU tensor runs the plain version without counting a launch."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = octbuild.build_oct_plain(T(t), tdt)
    r0, r1, r2, f = shape
    assert got.dtype == tdt and tuple(got.shape) == ((r0 - 1) * (r1 - 1) * (r2 - 1), 8 * f)
    ref = np.asarray(build_oct_ref(jnp.asarray(t), jdt), np.float32)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    if shape[0] < 9:  # the interpret-mode kernel is slow; tests/test_octbuild.py covers all shapes
        pallas = np.asarray(build_oct_pallas(jnp.asarray(t), jdt, interpret=True), np.float32)
        np.testing.assert_array_equal(got.float().numpy(), pallas)
    before = octbuild.build_oct.launches
    assert torch.equal(octbuild.build_oct(T(t), tdt), got)
    assert octbuild.build_oct.launches == before


def test_build_oct_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        octbuild.build_oct(torch.empty(4, 4, 4, 2, device="meta"))
    with pytest.raises(ValueError):
        octbuild.build_oct(torch.zeros(1, 4, 4, 2))
    with pytest.raises(TypeError):
        octbuild.build_oct(torch.zeros(3, 4, 4, 2), torch.float16)


def test_sawtooth_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    x[:6, 0] = [-1.0, -0.5, -0.25, 0.0, 0.5, 1.0]
    for f in np.linspace(2.0, 8.0, 6):
        got = interp.sawtooth(T(x), float(f)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jinterp.sawtooth(jnp.asarray(x), float(f))))
        assert got.min() >= -1.0 and got.max() < 1.0
    assert (x < 0).mean() > 0.4  # half the inputs are negative


@pytest.mark.parametrize("res", [(5, 6, 7), (8, 8, 8), (12, 9, 10)])
def test_cell_3d_matches_jax(res):
    x = _points(seed=2)
    cell, w = interp._cell_3d(T(x), *res)
    jcell, jw = jinterp._cell_3d(jnp.asarray(x), *res)
    np.testing.assert_array_equal(cell.numpy(), np.asarray(jcell))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    # +1 lands in the last cell with t == 1: weight 1 on the far corner
    assert cell[1] == np.prod([r - 1 for r in res]) - 1 and w[1, 7] == 1.0


@pytest.mark.parametrize("gather", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 6, 7, 3), (8, 8, 8, 6), (12, 10, 9, 4)])
def test_trilinear_lookup_oct_matches_jax(gather, shape):
    """Value and table gradient (for a random cotangent) against JAX's
    custom-vjp lookup; the coordinate gradient is not taken (none)."""
    rng = np.random.default_rng(3)
    table = rng.normal(size=shape).astype(np.float32)
    x = _points(700, seed=4).reshape(7, 100, 3)
    cot = rng.normal(size=(7, 100, shape[-1])).astype(np.float32)
    tdt, jdt = getattr(torch, gather), getattr(jnp, gather)
    t = T(table).requires_grad_()
    out = interp.trilinear_lookup_oct(t, T(x), tdt)
    out.backward(T(cot))
    ref, vjp = jax.vjp(lambda tt: jinterp.trilinear_lookup_oct(tt, jnp.asarray(x), jdt), jnp.asarray(table))
    (gref,) = vjp(jnp.asarray(cot))
    assert out.shape == (7, 100, shape[-1]) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gref), atol=1e-5)
    assert np.count_nonzero(t.grad.numpy()) > 0.5 * table.size


@pytest.fixture(scope="module")
def fields():
    """(JAX field in quad mode, its params, the port field holding them)."""
    jfield, jsig, jrgb = jmake_model("cobafa", field_scale=SCALE)
    jfield = dataclasses.replace(jfield, lookup_mode="quad")
    kf, ks, kr = jax.random.split(jax.random.PRNGKey(0), 3)
    params = jax.jit(lambda: {"field": jfield.init(kf), "sigma": jsig.init(ks), "rgb": jrgb.init(kr)})()
    renderer = build_renderer(TrainConfig(**COBAFA_CFG), 1.0, None, device="cpu")
    load_params(renderer, jax.tree_util.tree_map(np.asarray, params))
    return jfield, params, renderer


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cobafa_field_matches_jax(fields, dtype):
    jfield, params, renderer = fields
    tdt, jdt, tol = DTYPES[dtype]
    x = _points(seed=5)
    with torch.no_grad():
        (got,) = renderer.field.apply_pieces(T(x), tdt)
    ref = jax.jit(jfield.apply, static_argnums=2)(params["field"], jnp.asarray(x), jdt)
    assert got.dtype == tdt and got.shape == (500, 128)
    np.testing.assert_allclose(got.float().numpy(), _np(ref), atol=tol, rtol=tol)
    with torch.no_grad():
        sigma = renderer.sigma_decoder(renderer.field(T(x), tdt), tdt)
    assert sigma.shape == (500,) and torch.isfinite(sigma).all()


def test_cobafa_field_gradient_matches_jax(fields):
    """Gradients of every field leaf (the grids through the oct backward,
    the MLP) for a random cotangent on the features, at f32."""
    jfield, params, renderer = fields
    x = _points(seed=6)
    cot = np.random.default_rng(7).normal(size=(500, 128)).astype(np.float32)
    renderer.zero_grad(set_to_none=True)
    (renderer.field(T(x)) * T(cot)).sum().backward()
    g = jax.grad(lambda p: jnp.sum(jfield.apply(p, jnp.asarray(x)) * cot))(params["field"])
    f = renderer.field
    pairs = [(b.grad, jb) for b, jb in zip(f.basis, g["basis"])] + [(f.coef.grad, g["coef"])]
    pairs += [(w.grad, jl["w"]) for w, jl in zip(f.mlp.w, g["mlp"])]
    pairs += [(b.grad, jl["b"]) for b, jl in zip(f.mlp.b, g["mlp"])]
    for got, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4 * np.abs(ref).max())


def test_dropout_mask():
    """Keep fraction ~0.99, survivors scaled by 1/0.99, the same mask from
    the same words (and another from other words), identity without a seed."""
    field = make_model("cobafa", field_scale=SCALE, generator=torch.Generator().manual_seed(0))[0]
    y = torch.rand(4000, 8) + 0.5
    a = tcobafa.dropout(y, [11, 12], 0)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.99) < 0.003
    torch.testing.assert_close(a[kept], y[kept] / 0.99, rtol=0, atol=0)
    assert torch.equal(tcobafa.dropout(y, torch.tensor([11, 12]), 0), a)
    assert not torch.equal(tcobafa.dropout(y, [11, 13], 0), a)
    assert not torch.equal(tcobafa.dropout(y, [11, 12], 8) != 0, kept)  # another level's ids
    x = T(_points(seed=8))
    with torch.no_grad():
        plain = field(x)
        assert torch.equal(field(x), plain)
        assert torch.equal(field(x, dropout_seed=[1, 2]), field(x, dropout_seed=[1, 2]))
        assert not torch.equal(field(x, dropout_seed=[1, 2]), plain)


@pytest.mark.parametrize("field_scale", [0.1, 0.5, 1.0])
def test_make_model_cobafa_matches_jax(field_scale):
    jfield, jsig, jrgb = jmake_model("cobafa", field_scale=field_scale)
    field, sig, rgb = make_model("cobafa", field_scale=field_scale)
    assert isinstance(field, CobafaFeatureField)
    assert field.basis_res == jfield.basis_res and field.coef_res == jfield.coef_res
    assert field.freqs == jfield.freqs and field.channels == jfield.channels
    assert field.feature_dim == jfield.feature_dim == 128
    shapes = jax.eval_shape(lambda: {"field": jfield.init(jax.random.PRNGKey(0)),
                                     "sigma": jsig.init(jax.random.PRNGKey(1)),
                                     "rgb": jrgb.init(jax.random.PRNGKey(2))})
    renderer = build_renderer(TrainConfig(method="cobafa", field_scale=field_scale), 1.0, None, device="meta")
    leaves = list(tree_leaves_with_path(param_tree(renderer)))
    assert [tuple(t.shape) for _, t in leaves] == [tuple(s.shape) for s in jax.tree_util.tree_leaves(shapes)]
    if field_scale == 1.0:  # the field: ~22.0M parameters
        assert sum(t.numel() for path, t in leaves if path[0] == "field") == 21_991_356


def test_cobafa_init():
    """U(0.5, 1.5) grids, He-uniform MLP weights with zero biases,
    reproducible from the generator's seed."""
    a = make_model("cobafa", field_scale=SCALE, generator=torch.Generator().manual_seed(3))[0]
    b = make_model("cobafa", field_scale=SCALE, generator=torch.Generator().manual_seed(3))[0]
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    grids = torch.cat([p.detach().flatten() for p in list(a.basis) + [a.coef]])
    assert 0.5 <= float(grids.min()) and float(grids.max()) <= 1.5
    for w, bias in zip(a.mlp.w, a.mlp.b):
        bound = np.sqrt(6.0 / w.shape[0])
        assert float(w.detach().abs().max()) <= bound and float(w.detach().abs().max()) > 0.8 * bound
        assert float(bias.detach().abs().max()) == 0.0


def test_convert_round_trip_and_optimizer_groups(fields):
    """JAX params in and out unchanged; the grids are tables (no weight
    decay, the 1e-2 table lr against the MLP's 3e-3), the MLPs decay."""
    _, params, renderer = fields
    back = params_to_numpy(renderer)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    bad = jax.tree_util.tree_map(np.asarray, params)
    bad["field"]["basis"] = bad["field"]["basis"][:-1]
    with pytest.raises(ValueError, match="basis"):
        load_params(renderer, bad)
    opt = make_optimizer(TrainConfig(**COBAFA_CFG), renderer)
    groups = {path[:2]: (dec, tab) for path, dec, tab in zip(opt.paths, opt.decay, opt.table)}
    assert groups[("field", "basis")] == (False, True) and groups[("field", "coef")] == (False, True)
    assert groups[("field", "mlp")] == (True, False) and groups[("sigma", "mlp")] == (True, False)
    assert opt.table_ratio == pytest.approx(1e-2 / 3e-3)
