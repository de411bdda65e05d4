"""Every lookup layout of the K-Planes and Cobafa fields against the JAX
package: the corner form (`_corners_2d`, `_corners_3d`), the plain, mixed
and quad lookups and their table gradients, the fused fine table of
`fwd_mode="fusedfine"`, the single-projection multiscale op, both fields'
`apply_pieces` in every `lookup_mode` (and `fwd_mode`, `scatter_dtype`,
`gather_dtype`), the options `dropout_p`, `mlp_init_mode` and `init_mode`,
the parameter interchange in every layout, and the card's resolution of
the K-Planes backward (no `index_add_` on a CUDA device).

Inputs are made with numpy from a seed; parameters are initialized by the
JAX package and carried across with `tinynerf_tpu_torch.convert`.  Small
sizes: planes 9/17/33 (field_scale 0.07) and Cobafa grids 8-12^3
(tests/torch_world.py).  Tolerances:
  * corner indices and weights equal; the fused fine table and its quad
    table bit-equal at bf16, float8 and f32 (the same roundings in the
    same order);
  * lookups 1e-6 (f32 lerps of the same rounded corners), fields 1e-5 at f32
    compute (tests/test_torch_models.py);
  * table gradients with f32 sums 1e-6 of the largest magnitude for one
    lookup, 1e-5 through a field (the port sums each value's terms in
    window-sorted order, JAX's scatter in its own);
  * the bf16 scatter: JAX rounds every term and every partial sum of a
    value to bf16, the port sums in f32 and rounds once, so the two differ
    by up to (m + 2) 2^-8 S, m the value's terms and S the sum of their
    magnitudes (each of JAX's m adds and term roundings, and the port's
    one rounding, errs by at most a bf16 ulp, 2^-8, of a partial sum <= S:
    XLA's CPU scatter does not round every add to nearest, and errs by up
    to 1% of a value of two or three terms); the port's value is its f32
    gradient rounded to bf16, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.models import make_model as jmake_model
from tinynerf_tpu.ops import interp as jinterp
from tinynerf_tpu_torch.convert import load_params, param_tree, params_to_numpy, tree_leaves_with_path
from tinynerf_tpu_torch.models import make_model
from tinynerf_tpu_torch.models import cobafa as tcobafa
from tinynerf_tpu_torch.models.kplanes import DIMENSION_PAIRS
from tinynerf_tpu_torch.ops import interp, octbuild, table_grad
from tinynerf_tpu_torch.train import TrainConfig, build_renderer
from torch_world import CFG, COBAFA_CFG

torch.set_num_threads(2)

T = torch.from_numpy
GATHERS = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float8": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
           "float32": (torch.float32, jnp.float32)}
SCATTERS = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
ULP = 2.0**-8  # a bf16 ulp, relative
# JAX's float8 boundaries (tests/test_torch_gather_dtype.py)
FP8_BOUNDARY = np.array([464, -464, 464.0001, 480, -480, 2**-10, 2**-9 * 1.5, 447, 448, 449, -0.0], np.float32)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _coords(n, dims, seed):
    """Coordinates in [-1.05, 1.05] (beyond the table clamps) with the
    corners and centre of the box."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.05, 1.05, (n, dims)).astype(np.float32)
    c[0], c[1], c[2] = 1.0, -1.0, 0.0
    c[3, 0] = 1.0
    return c


def _bf16_bound(count, abs_sum):
    """The bf16-scatter difference bound (module docstring) per value."""
    return (count + 2) * ULP * abs_sum * 1.001 + 1e-30


# ---------------------------------------------------------------- the ops


@pytest.mark.parametrize("shape", [(9, 17), (5, 5), (2, 3), (8, 9, 10), (3, 2, 4)], ids=str)
def test_corners_match_jax(shape):
    c = _coords(400, len(shape), sum(shape))
    corners, jcorners = (interp._corners_2d, jinterp._corners_2d) if len(shape) == 2 else \
        (interp._corners_3d, jinterp._corners_3d)
    idx, w = corners(T(c), *shape)
    jidx, jw = jcorners(jnp.asarray(c), *shape)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


def _lookup_case(dims, seed, f=6, n=300):
    rng = np.random.default_rng(seed)
    shape = (9, 17) if dims == 2 else (8, 9, 10)
    table = rng.uniform(0, 1, shape + (f,)).astype(np.float32)
    table.reshape(-1)[rng.choice(table.size, FP8_BOUNDARY.size, replace=False)] = FP8_BOUNDARY
    return table, _coords(n, dims, seed + 1), rng.normal(size=(n, f)).astype(np.float32)


def _port(fn, table, coords, cot):
    t = T(table).clone().requires_grad_()
    out = fn(t, T(coords))
    (out * T(cot)).sum().backward()
    return out.detach().numpy(), t.grad.numpy()


def _jax(fn, table, coords, cot):
    out, vjp = jax.vjp(lambda t: fn(t, jnp.asarray(coords)), jnp.asarray(table))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


def _counts_and_abs_sums(table, coords, cot):
    """Per table value: the terms JAX's scatter adds into it and the sum of
    their magnitudes (the corner form, as `_bilinear_mixed_bwd` and
    `_trilinear_mixed_bwd` scatter them)."""
    shape, f = table.shape[:-1], table.shape[-1]
    corners = jinterp._corners_2d if len(shape) == 2 else jinterp._corners_3d
    idx, w = corners(jnp.asarray(coords), *shape)
    idx, w = np.asarray(idx).reshape(-1), np.asarray(w)
    count = np.bincount(idx, minlength=int(np.prod(shape)))
    abs_sum = np.zeros((int(np.prod(shape)), f))
    np.add.at(abs_sum, idx, np.abs((w[:, :, None] * cot[:, None, :]).reshape(-1, f)))
    return count.reshape(shape + (1,)), abs_sum.reshape(table.shape)


@pytest.mark.parametrize("dims", [2, 3])
def test_plain_lookup_matches_jax(dims):
    """`bilinear_lookup` / `trilinear_lookup` (f32 gathers) against JAX's
    plain autodiff lookups: values and table gradients."""
    table, coords, cot = _lookup_case(dims, 10 + dims)
    port_fn, jax_fn = ((interp.bilinear_lookup, jinterp.bilinear_lookup) if dims == 2 else
                       (interp.trilinear_lookup, jinterp.trilinear_lookup))
    out, grad = _port(port_fn, table, coords, cot)
    ref, jgrad = _jax(jax_fn, table, coords, cot)
    assert out.shape == (coords.shape[0], table.shape[-1]) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(grad, jgrad, atol=1e-6 * np.abs(jgrad).max())
    assert np.count_nonzero(grad) > 0.5 * grad.size


MIXED_CASES = [(2, g, s) for g in GATHERS for s in SCATTERS] + [(3, g, s) for g in ("bfloat16", "float32")
                                                                 for s in SCATTERS]


@pytest.mark.parametrize("dims,gather,scatter", MIXED_CASES, ids=lambda v: str(v))
def test_mixed_lookup_matches_jax(dims, gather, scatter):
    """`bilinear_lookup_mixed` / `trilinear_lookup_mixed` against JAX's for
    each gather and scatter type: values, and table gradients (f32 sums;
    the bf16 scatter within its bound, and equal to the port's f32 gradient
    rounded once)."""
    table, coords, cot = _lookup_case(dims, 20 + dims)
    (tg, jg), (ts, js) = GATHERS[gather], SCATTERS[scatter]
    port_fn, jax_fn = ((interp.bilinear_lookup_mixed, jinterp.bilinear_lookup_mixed) if dims == 2 else
                       (interp.trilinear_lookup_mixed, jinterp.trilinear_lookup_mixed))
    out, grad = _port(lambda t, c: port_fn(t, c, tg, ts), table, coords, cot)
    ref, jgrad = _jax(lambda t, c: jax_fn(t, c, jg, js), table, coords, cot)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)
    if scatter == "float32":
        np.testing.assert_allclose(grad, jgrad, atol=1e-6 * np.abs(jgrad).max())
    else:
        _, grad32 = _port(lambda t, c: port_fn(t, c, tg, torch.float32), table, coords, cot)
        np.testing.assert_array_equal(grad, T(grad32).to(torch.bfloat16).float().numpy())
        count, abs_sum = _counts_and_abs_sums(table, coords, cot)
        assert np.all(np.abs(grad - jgrad) <= _bf16_bound(count, abs_sum))
        assert not np.array_equal(grad, jgrad)  # JAX's chain of bf16 adds does differ


@pytest.mark.parametrize("gather", sorted(GATHERS))
def test_quad_lookup_matches_jax(gather):
    """`bilinear_lookup_quad` against JAX's: values and table gradients."""
    table, coords, cot = _lookup_case(2, 30)
    tg, jg = GATHERS[gather]
    out, grad = _port(lambda t, c: interp.bilinear_lookup_quad(t, c, tg), table, coords, cot)
    ref, jgrad = _jax(lambda t, c: jinterp.bilinear_lookup_quad(t, c, jg), table, coords, cot)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(grad, jgrad, atol=1e-6 * np.abs(jgrad).max())


def _scales(seed, f=4, res=(5, 9, 17), boundary=True):
    rng = np.random.default_rng(seed)
    out = []
    for r in res:
        t = (rng.uniform(0, 1, (r, r, f)) * 3.0).astype(np.float32)
        if boundary:
            t.reshape(-1)[rng.choice(t.size, FP8_BOUNDARY.size, replace=False)] = FP8_BOUNDARY
        out.append(t)
    return out


@pytest.mark.parametrize("gather", sorted(GATHERS))
def test_fused_fine_table_bit_equal_to_jax(gather):
    """The fused fine table (each scale rounded to the gather type, held in
    bf16 or f32, upsampled in that type) and its quad table, bit for bit
    against JAX's `_multiscale_value(fwd_impl="fusedfine")` steps, with
    JAX's float8 boundaries among the values."""
    tg, jg = GATHERS[gather]
    tables = _scales(40)
    hold = jnp.float32 if jg == jnp.float32 else jnp.bfloat16
    jfine = jnp.concatenate([jinterp.upsample_to(jnp.asarray(t).astype(jg).astype(hold), 17, 17) for t in tables],
                            axis=-1)
    fine = interp.fused_fine_table([T(t) for t in tables], tg)
    assert fine.shape == (17, 17, 12) and fine.dtype == torch.float32  # the hold type's values, widened
    np.testing.assert_array_equal(fine.view(torch.int32).numpy(), _np(jfine).view(np.int32))
    assert np.isnan(_np(jfine)).any() == (gather == "float8")  # +-480 are NaN in float8
    quad = octbuild.build_quad(fine, tg)
    jquad = jinterp._build_quad(jfine, jg)
    np.testing.assert_array_equal(quad.view(torch.uint8).numpy(), np.asarray(jquad).view(np.uint8))


@pytest.mark.parametrize("bwd_impl", ["scatter", "sorted"])
@pytest.mark.parametrize("fwd_impl", ["perscale", "fusedfine"])
@pytest.mark.parametrize("gather", sorted(GATHERS))
def test_multiscale_lookup_matches_jax(gather, fwd_impl, bwd_impl):
    """`bilinear_lookup_multiscale` (one projection) against JAX's, both
    forwards: values and each scale's gradient (JAX's CPU scatter; the
    port's scatter or sorted windows on the CPU)."""
    tg, jg = GATHERS[gather]
    tables = _scales(50, boundary=False)
    rng = np.random.default_rng(51)
    coords = _coords(400, 2, 52)
    cot = rng.normal(size=(400, 12)).astype(np.float32)
    ts = [T(t).clone().requires_grad_() for t in tables]
    out = interp.bilinear_lookup_multiscale(ts, T(coords), tg, bwd_impl, fwd_impl)
    (out * T(cot)).sum().backward()
    ref, vjp = jax.vjp(lambda tt: jinterp.bilinear_lookup_multiscale(tt, jnp.asarray(coords), jg, "scatter",
                                                                     fwd_impl), tuple(jnp.asarray(t) for t in tables))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    for t, jgrad in zip(ts, vjp(jnp.asarray(cot))[0]):
        jgrad = np.asarray(jgrad)
        np.testing.assert_allclose(t.grad.numpy(), jgrad, atol=1e-6 * np.abs(jgrad).max())
    if gather != "float32":  # fusedfine rounds the upsampled midpoints once more
        per = interp.bilinear_lookup_multiscale([T(t) for t in tables], T(coords), tg, bwd_impl, "perscale")
        assert (fwd_impl == "perscale") == torch.equal(out.detach(), per.detach())


# ------------------------------------------------------------- the fields


@pytest.fixture(scope="module")
def kplanes_params():
    jfield = jmake_model("kplanes", field_scale=CFG["field_scale"])[0]
    return jfield, jax.jit(jfield.init)(jax.random.PRNGKey(4))


KPLANES_LAYOUTS = {  # id: (lookup_mode, fwd_mode, scatter_dtype, gather_dtypes)
    "fused_perscale": ("fused", "perscale", "float32", ("bfloat16", "float8", "float32")),
    "fused_fusedfine": ("fused", "fusedfine", "float32", ("bfloat16", "float8", "float32")),
    "quad": ("quad", "perscale", "float32", ("bfloat16", "float8", "float32")),
    "mixed": ("mixed", "perscale", "float32", ("bfloat16", "float8", "float32")),
    "mixed_bf16_scatter": ("mixed", "perscale", "bfloat16", ("bfloat16",)),
    "plain": ("plain", "perscale", "float32", ("float32",)),
}
KPLANES_CASES = [(k, g) for k, v in KPLANES_LAYOUTS.items() for g in v[3]]


def _kplanes_field(layout, gather, jparams):
    lookup, fwd, scatter, _ = KPLANES_LAYOUTS[layout]
    field = make_model("kplanes", field_scale=CFG["field_scale"], gather_dtype=gather, lookup_mode=lookup,
                       fwd_mode=fwd, scatter_dtype=scatter)[0]
    with torch.no_grad():
        for s, scale in enumerate(jparams["planes"]):
            for p, plane in enumerate(scale):
                field.planes[s][p].copy_(T(np.array(plane)))
    return field


@pytest.mark.parametrize("layout,gather", KPLANES_CASES, ids=lambda v: str(v))
def test_kplanes_field_layouts_match_jax(kplanes_params, layout, gather):
    """`apply_pieces` of the K-Planes field in every layout against the JAX
    field with the same options, parameters carried over: each scale's
    features at f32 compute and every plane's gradient for a random
    cotangent."""
    jfield, jparams = kplanes_params
    lookup, fwd, scatter, _ = KPLANES_LAYOUTS[layout]
    jf = dataclasses.replace(jfield, lookup_mode=lookup, fwd_mode=fwd, scatter_dtype=scatter, gather_dtype=gather,
                             bwd_mode="scatter")
    field = _kplanes_field(layout, gather, jparams)
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    x[:2] = [[-1, -1, -1], [1, 1, 1]]
    cot = rng.normal(size=(500, field.feature_dim)).astype(np.float32)
    before = octbuild.build_quad.launches
    got = field.apply_pieces(T(x))
    assert octbuild.build_quad.launches == before  # CPU tensors: the plain versions
    ref, vjp = jax.vjp(lambda p: jf.apply_pieces(p, jnp.asarray(x)), jparams)
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    torch.sum(torch.cat(got, -1) * T(cot)).backward()
    jgrad = vjp(tuple(jnp.asarray(cot[:, s * 32 : (s + 1) * 32]) for s in range(3)))[0]
    ours = [p.grad.numpy() for s in field.planes for p in s]
    theirs = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrad["planes"])]
    assert len(ours) == len(theirs) == 9
    if scatter == "float32":
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max())
        return
    # the bf16 scatter: the port's f32 gradient rounded once, within the
    # bound of JAX's chain; each plane's terms are w * cot * (the other two
    # planes' lookups, all >= 0 on U(0, 1) planes), so the sum of their
    # magnitudes is the f32 gradient for |cot|
    f32 = _kplanes_field(layout, gather, jparams)
    f32.scatter_dtype = "float32"
    torch.sum(torch.cat(f32.apply_pieces(T(x)), -1) * T(cot)).backward()
    g32 = [p.grad for s in f32.planes for p in s]
    f32.zero_grad()
    torch.sum(torch.cat(f32.apply_pieces(T(x)), -1) * T(np.abs(cot))).backward()
    abs_sums = [p.grad.numpy() for s in f32.planes for p in s]
    for k, (a, b, a32, s_abs) in enumerate(zip(ours, theirs, g32, abs_sums)):
        np.testing.assert_array_equal(a, a32.to(torch.bfloat16).float().numpy())
        i, j = DIMENSION_PAIRS[k % 3]
        res = field.resolutions[k // 3]
        idx, _ = jinterp._corners_2d(jnp.asarray(x[:, [i, j]]), res, res)
        count = np.bincount(np.asarray(idx).reshape(-1), minlength=res * res).reshape(res, res, 1)
        assert np.all(np.abs(a - b) <= _bf16_bound(count, s_abs)), k


@pytest.fixture(scope="module")
def cobafa_params():
    jfield, jsig, jrgb = jmake_model("cobafa", field_scale=COBAFA_CFG["field_scale"])
    kf, ks, kr = jax.random.split(jax.random.PRNGKey(0), 3)
    params = jax.jit(lambda: {"field": jfield.init(kf), "sigma": jsig.init(ks), "rgb": jrgb.init(kr)})()
    return jfield, params


COBAFA_LAYOUTS = {  # id: (port lookup_mode, JAX lookup_mode, scatter_dtype)
    "auto": ("auto", "quad", "float32"),  # the port's "auto" is the oct layout on every device
    "quad": ("quad", "quad", "float32"),
    "mixed": ("mixed", "mixed", "float32"),
    "mixed_bf16_scatter": ("mixed", "mixed", "bfloat16"),
    "plain": ("plain", "plain", "float32"),
}


def _cobafa_renderer(params, lookup, gather, scatter):
    r = build_renderer(TrainConfig(**COBAFA_CFG), 1.0, None, device="cpu")
    load_params(r, jax.tree_util.tree_map(np.asarray, params))
    r.field.lookup_mode, r.field.gather_dtype, r.field.scatter_dtype = lookup, gather, scatter
    return r


def _cobafa_grads(field):
    return [p.grad.numpy() for p in (*field.basis, field.coef, *field.mlp.w, *field.mlp.b)]


def _jax_cobafa_grads(g):
    return [np.asarray(v) for v in (*g["basis"], g["coef"], *(l["w"] for l in g["mlp"]),
                                    *(l["b"] for l in g["mlp"]))]


@pytest.mark.parametrize("gather", ["bfloat16", "float32"])
@pytest.mark.parametrize("layout", sorted(COBAFA_LAYOUTS))
def test_cobafa_field_layouts_match_jax(cobafa_params, layout, gather):
    """The Cobafa field in every `lookup_mode` against the JAX field with
    the same options (the port's "auto" against JAX's "quad"), at f32
    compute: the features (tests/test_torch_cobafa.py's 1e-4) and every
    field leaf's gradient (grids through the oct backward, the MLP; 1e-4 of
    the leaf's max there).  With the bf16 scatter the grids' gradients are
    the f32 ones rounded once, within 2^-5 of the largest of JAX's bf16
    chain (the op test above bounds that chain value by value)."""
    jfield, params = cobafa_params
    lookup, jlookup, scatter = COBAFA_LAYOUTS[layout]
    jf = dataclasses.replace(jfield, lookup_mode=jlookup, gather_dtype=gather, scatter_dtype=scatter)
    r = _cobafa_renderer(params, lookup, gather, scatter)
    x = np.random.default_rng(5).uniform(-1, 1, (500, 3)).astype(np.float32)
    cot = np.random.default_rng(7).normal(size=(500, 128)).astype(np.float32)
    before = octbuild.build_oct.launches
    got = r.field(T(x))
    assert octbuild.build_oct.launches == before
    ref, vjp = jax.vjp(lambda p: jf.apply(p, jnp.asarray(x)), params["field"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    (got * T(cot)).sum().backward()
    ours, theirs = _cobafa_grads(r.field), _jax_cobafa_grads(vjp(jnp.asarray(cot))[0])
    n_grids = len(r.field.basis) + 1
    if scatter == "bfloat16":
        r32 = _cobafa_renderer(params, lookup, gather, "float32")
        (r32.field(T(x)) * T(cot)).sum().backward()
        for a, a32 in zip(ours[:n_grids], _cobafa_grads(r32.field)):
            np.testing.assert_array_equal(a, T(a32).to(torch.bfloat16).float().numpy())
    for k, (a, b) in enumerate(zip(ours, theirs)):
        tol = 2.0**-5 if scatter == "bfloat16" and k < n_grids else 1e-4
        np.testing.assert_allclose(a, b, atol=tol * np.abs(b).max())


def test_cobafa_auto_is_the_oct_layout_here_and_mixed_in_jax_off_a_tpu(cobafa_params):
    """The port's "auto" runs the oct layout on every device (the JAX
    accelerator's choice); JAX's "auto" is "mixed" off a TPU: the same
    values from two layouts."""
    jfield, params = cobafa_params
    r = _cobafa_renderer(params, "auto", "bfloat16", "float32")
    x = T(np.random.default_rng(3).uniform(-1, 1, (64, 3)).astype(np.float32))
    with torch.no_grad():
        auto = r.field(x)
        r.field.lookup_mode = "quad"
        assert torch.equal(r.field(x), auto)
    assert jax.default_backend() != "tpu"
    np.testing.assert_allclose(auto.numpy(), np.asarray(dataclasses.replace(jfield, lookup_mode="mixed").apply(
        params["field"], jnp.asarray(x.numpy()))), atol=1e-4, rtol=1e-4)


# ----------------------------------------------------------- the options


def test_unknown_options_raise():
    for kw in (dict(lookup_mode="fuse"), dict(fwd_mode="fine"), dict(scatter_dtype="float16"),
               dict(gather_dtype="float16")):
        with pytest.raises(ValueError):
            make_model("kplanes", field_scale=0.07, **kw)
    for kw in (dict(lookup_mode="fused"), dict(scatter_dtype="float8"), dict(mlp_init_mode="xavier")):
        with pytest.raises(ValueError):
            make_model("cobafa", field_scale=0.1, **kw)
    with pytest.raises(ValueError):
        make_model("vanilla", field_scale=0.07, init_mode="xavier")
    field = make_model("kplanes", field_scale=0.07)[0]
    field.lookup_mode = "quads"  # an attribute set later is checked at the call
    with pytest.raises(ValueError, match="lookup_mode"):
        field.apply_pieces(torch.zeros(4, 3))
    with pytest.raises(ValueError, match="fwd_impl"):
        interp.multiscale_lookup_multiproj([[torch.zeros(5, 5, 2)]], [torch.zeros(3, 2)], fwd_impl="fine")


@pytest.mark.parametrize("method,option", [("cobafa", "mlp_init_mode"), ("vanilla", "init_mode")])
def test_mlp_init_modes(method, option):
    """"he" (the default): He-uniform weights and zero biases; "torch" (the
    reference's): U(+-1/sqrt(fan_in)) weights and biases, as the JAX
    package's `linear_init` draws them; the same shapes either way."""
    he = make_model(method, field_scale=0.1, generator=torch.Generator().manual_seed(0))[0]
    ref = make_model(method, field_scale=0.1, generator=torch.Generator().manual_seed(0), **{option: "torch"})[0]
    assert getattr(he, option) == "he" and getattr(ref, option) == "torch"
    for field, mode in ((he, "he"), (ref, "torch")):
        for w, b in zip(field.mlp.w, field.mlp.b):
            bound = np.sqrt(6.0 / w.shape[0]) if mode == "he" else 1.0 / np.sqrt(w.shape[0])
            assert 0.9 * bound < float(w.detach().abs().max()) <= bound
            if mode == "he":
                assert float(b.detach().abs().max()) == 0.0
            else:
                assert 0 < float(b.detach().abs().max()) <= bound
    assert [p.shape for p in he.parameters()] == [p.shape for p in ref.parameters()]


def test_cobafa_dropout_p():
    """`dropout_p` sets the keep rate of the train-time mask (survivors
    scaled by 1 / (1 - p)); 0 turns dropout off, as in the JAX field."""
    y = torch.rand(4000, 8) + 0.5
    half = tcobafa.dropout(y, [5, 6], 0, 0.5)
    kept = half != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.02
    torch.testing.assert_close(half[kept], y[kept] / 0.5, rtol=0, atol=0)
    assert torch.equal(tcobafa.dropout(y, [5, 6], 0), tcobafa.dropout(y, [5, 6], 0, tcobafa.DROPOUT_P))
    field = make_model("cobafa", field_scale=0.1, generator=torch.Generator().manual_seed(0), dropout_p=0.0)[0]
    assert field.dropout_p == 0.0 and make_model("cobafa", field_scale=0.1)[0].dropout_p == 0.01
    x = T(_coords(64, 3, 9).clip(-1, 1))
    with torch.no_grad():
        assert torch.equal(field(x, dropout_seed=[1, 2]), field(x))
        field.dropout_p = 0.3
        assert not torch.equal(field(x, dropout_seed=[1, 2]), field(x))


LAYOUT_OPTIONS = {
    "kplanes": [dict(lookup_mode=m) for m in ("fused", "quad", "mixed", "plain")]
    + [dict(fwd_mode="fusedfine"), dict(lookup_mode="mixed", scatter_dtype="bfloat16")],
    "cobafa": [dict(lookup_mode=m) for m in ("auto", "quad", "mixed", "plain")]
    + [dict(dropout_p=0.0, mlp_init_mode="torch")],
    "vanilla": [dict(init_mode="torch")],
}


@pytest.mark.parametrize("method,options", [(m, o) for m, opts in LAYOUT_OPTIONS.items() for o in opts],
                         ids=lambda v: str(v))
def test_convert_carries_parameters_in_every_layout(method, options):
    """`make_model` passes the options through; the parameter shapes are
    the JAX field's with the same options, and JAX parameters load into the
    port's field and come back out unchanged (`convert.py` needs nothing
    per layout)."""
    scale = 0.1 if method == "cobafa" else 0.07
    field = make_model(method, field_scale=scale, **options)[0]
    for k, v in options.items():
        assert getattr(field, k) == v
    cfg = dict(CFG, method=method, field_scale=scale)
    jfield, jsig, jrgb = jmake_model(method, field_scale=scale)
    jfield = dataclasses.replace(jfield, **options)
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    params = jax.jit(lambda: {"field": jfield.init(keys[0]), "sigma": jsig.init(keys[1]),
                              "rgb": jrgb.init(keys[2])})()
    r = build_renderer(TrainConfig(**cfg), 1.0, None, device="cpu")
    for k, v in options.items():
        setattr(r.field, k, v)
    leaves = [tuple(t.shape) for _, t in tree_leaves_with_path(param_tree(r))]
    assert leaves == [tuple(p.shape) for p in jax.tree_util.tree_leaves(params)]
    load_params(r, jax.tree_util.tree_map(np.asarray, params))
    back = params_to_numpy(r)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


# ------------------------------------------- the K-Planes backward's route


RESOLUTION_CASES = [  # (device, n_cells, n, bwd_impl, resolved)
    ("cuda", 512 * 512, 3_276_800, "auto", "sorted_bf16"),
    ("cuda", 512 * 512, 3_276_800, "sorted_bf16", "sorted_bf16"),
    ("cuda", 512 * 512, 3_276_800, "sorted", "sorted"),
    ("cuda", 512 * 512, 3_276_800, "scatter", "sorted"),
    ("cuda", 512 * 512, 819_200, "scatter", "sorted"),
    ("cpu", 512 * 512, 3_276_800, "auto", "scatter"),
    ("cpu", 512 * 512, 3_276_800, "sorted", "scatter"),  # JAX's rule: 10 + 22 key bits pass 31
    ("cpu", 512 * 512, 2**21, "sorted_bf16", "sorted_bf16"),
    ("cpu", 512 * 512, 2**21 + 1, "sorted_bf16", "scatter"),
]


@pytest.mark.parametrize("device,n_cells,n,bwd_impl,resolved", RESOLUTION_CASES, ids=lambda v: str(v))
def test_bwd_resolution_never_reaches_index_add_on_the_card(device, n_cells, n, bwd_impl, resolved):
    """On a CUDA device the fused backward never resolves to the scatter
    (`index_add_`), at batch 8192 x 400 samples (3,276,800) too, and
    "scatter" is the f32 payload's pipeline; the CPU keeps JAX's rule.  No
    card is needed to build the device object."""
    assert interp._resolve_bwd_impl(bwd_impl, torch.device(device), n_cells, n) == resolved
    with pytest.raises(ValueError):
        interp._resolve_bwd_impl("bitonic", torch.device(device), n_cells, n)


def test_card_window_at_batch_8192_takes_the_key_value_sort():
    """At batch 8192 x 400 samples the card keeps windows of 64 cells (the
    register kernel's, summed in a fixed order) and sorts by key and
    value, since 4096 windows and 3,276,800 samples pass 32 key bits."""
    n, n_cells = 3_276_800, 512 * 512
    w = table_grad.default_window(torch.device("cuda"), 4 * 96)
    assert w == table_grad.OWNER_WINDOW == 64
    assert not table_grad.window_keys_fit(n_cells, w, n)
    assert table_grad.window_keys_fit(n_cells, w, 819_200)  # the default step: packed keys
    assert table_grad.default_window(torch.device("cpu"), 4 * 96) == 256
