"""Port models (tinynerf_tpu_torch.models) against the JAX package's.

Parameters are initialized by the JAX package and carried across with
`tinynerf_tpu_torch.convert`; inputs are made with numpy from a seed.

Tolerances: f32 compute 1e-5 (matmuls and sin/cos differ between the two
frameworks only in the last ulps).  bf16 compute: the two frameworks round
to bf16 at the same places, but an f32 sum that lands on a different side
of a bf16 rounding boundary moves a value by one bf16 ulp (2^-8 relative),
so bf16 outputs are held to 2e-2 absolute (sigmoid/exp outputs of order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.models import make_model as jmake_model
from tinynerf_tpu.models import mlp as jmlp
from tinynerf_tpu.models.encodings import positional_encoding as jposenc
from tinynerf_tpu_torch.convert import load_params, params_to_numpy
from tinynerf_tpu_torch.models import MLP, make_model, mlp
from tinynerf_tpu_torch.models.encodings import positional_encoding
from tinynerf_tpu_torch.train import TrainConfig, build_renderer

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
SCALE = 0.07  # resolutions 9 / 17 / 33
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5), "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}
T = torch.from_numpy


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def models():
    """(jax modules, jax params, port modules holding the same params)."""
    jfield, jsig, jrgb = jmake_model("kplanes", field_scale=SCALE)
    kf, ks, kr = jax.random.split(KEY, 3)
    params = jax.jit(lambda: {"field": jfield.init(kf), "sigma": jsig.init(ks), "rgb": jrgb.init(kr)})()
    renderer = build_renderer(TrainConfig(field_scale=SCALE), 1.0, None, device="cpu")
    load_params(renderer, jax.tree_util.tree_map(np.asarray, params))
    return (jfield, jsig, jrgb), params, (renderer.field, renderer.sigma_decoder, renderer.rgb_decoder)


def test_convert_round_trip(models):
    _, params, (field, sig, rgb) = models
    renderer = build_renderer(TrainConfig(field_scale=SCALE), 1.0, None, device="cpu")
    load_params(renderer, jax.tree_util.tree_map(np.asarray, params))
    back = params_to_numpy(renderer)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    bad = jax.tree_util.tree_map(np.asarray, params)
    bad["sigma"]["mlp"][0]["w"] = bad["sigma"]["mlp"][0]["w"][:-1]
    with pytest.raises(ValueError, match="sigma"):
        load_params(renderer, bad)


def _points(n=400, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    x[:3] = [[-1, -1, -1], [1, 1, 1], [0, 0, 0]]
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return x, d


@pytest.mark.parametrize("field_scale", [0.07, 0.25, 1.0])
def test_make_model_matches_jax_resolutions(field_scale):
    jfield, jsig, jrgb = jmake_model("kplanes", field_scale=field_scale)
    field, sig, rgb = make_model("kplanes", field_scale=field_scale)
    assert field.resolutions == jfield.resolutions
    assert field.feature_dim == jfield.feature_dim
    assert [tuple(p.shape) for s in field.planes for p in s] == [
        (r, r, 32) for r in jfield.resolutions for _ in range(3)
    ]
    assert [tuple(w.shape) for w in rgb.mlp.w] == [
        (a, b) for a, b in zip([147, 64, 64, 64, 64], [64, 64, 64, 64, 3])
    ]
    assert [tuple(w.shape) for w in sig.mlp.w] == [(96, 64), (64, 1)]


def test_make_model_other_methods_not_ported():
    for method in ("vanilla", "cobafa"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_model(method)


def test_init_from_generator():
    """torch-default init U(+-1/sqrt(fan_in)) and U(0,1) planes, reproducible
    from the generator's seed."""
    a = make_model("kplanes", field_scale=SCALE, generator=torch.Generator().manual_seed(3))
    b = make_model("kplanes", field_scale=SCALE, generator=torch.Generator().manual_seed(3))
    for pa, pb in zip((p for m in a for p in m.parameters()), (p for m in b for p in m.parameters())):
        assert torch.equal(pa, pb)
    field, sig, _ = a
    planes = torch.cat([p.detach().flatten() for s in field.planes for p in s])
    assert 0.0 <= float(planes.min()) and float(planes.max()) <= 1.0
    for w, bias in zip(sig.mlp.w, sig.mlp.b):
        bound = 1.0 / np.sqrt(w.shape[0])
        assert float(w.detach().abs().max()) <= bound and float(bias.detach().abs().max()) <= bound


def test_positional_encoding_matches_jax():
    x, _ = _points()
    for n_freqs in (4, 8, 10):
        ref = np.asarray(jposenc(jnp.asarray(x), n_freqs))
        np.testing.assert_allclose(positional_encoding(T(x), n_freqs).numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mlp_applies_match_jax(dtype):
    tdt, jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(1)
    layers = MLP(20, 32, 2, 5, generator=torch.Generator().manual_seed(0))
    params = layers.layers()
    jparams = [{"w": jnp.asarray(l["w"].detach().numpy()), "b": jnp.asarray(l["b"].detach().numpy())}
               for l in params]
    x = rng.normal(size=(64, 20)).astype(np.float32)
    pieces = (x[:, :7], x[:, 7:10], x[:, 10:])
    seg = rng.integers(0, 8, 64)
    ray = rng.normal(size=(8, 7)).astype(np.float32)
    with torch.no_grad():
        got = {
            "linear": mlp.linear_apply(params[0], T(x), tdt),
            "mlp": mlp.mlp_apply(params, T(x), tdt),
            "split": mlp.mlp_apply_split(params, tuple(T(p) for p in pieces), tdt),
            "per_ray": mlp.mlp_apply_split_per_ray(
                params, (T(ray),), T(seg), tuple(T(p) for p in pieces[1:]), tdt),
        }
    ref = {
        "linear": jmlp.linear_apply(jparams[0], jnp.asarray(x), jdt),
        "mlp": jmlp.mlp_apply(jparams, jnp.asarray(x), jdt),
        "split": jmlp.mlp_apply_split(jparams, tuple(jnp.asarray(p) for p in pieces), jdt),
        "per_ray": jmlp.mlp_apply_split_per_ray(
            jparams, (jnp.asarray(ray),), jnp.asarray(seg), tuple(jnp.asarray(p) for p in pieces[1:]), jdt),
    }
    for k in got:
        assert got[k].dtype == tdt, k
        np.testing.assert_allclose(got[k].float().numpy(), _np(ref[k]), atol=tol * 4, rtol=tol, err_msg=k)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kplanes_field_matches_jax(models, dtype):
    (jfield, _, _), params, (field, _, _) = models
    tdt, jdt, tol = DTYPES[dtype]
    x, _ = _points()
    with torch.no_grad():
        got = field.apply_pieces(T(x), tdt)
    ref = jax.jit(jfield.apply_pieces, static_argnums=2)(params["field"], jnp.asarray(x), jdt)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.dtype == tdt
        np.testing.assert_allclose(g.float().numpy(), _np(r), atol=tol, rtol=tol)
    with torch.no_grad():
        cat = field(T(x), tdt)
    np.testing.assert_allclose(cat.float().numpy(), _np(jnp.concatenate(ref, axis=-1)), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decoders_match_jax(models, dtype):
    (jfield, jsig, jrgb), params, (field, sig, rgb) = models
    tdt, jdt, tol = DTYPES[dtype]
    x, d = _points()
    seg = np.repeat(np.arange(40), 10)  # 10 samples per ray
    d_ray = d[::10]
    jfeats = jax.jit(jfield.apply_pieces, static_argnums=2)(params["field"], jnp.asarray(x), jdt)
    with torch.no_grad():
        feats = field.apply_pieces(T(x), tdt)
        sigma = sig(feats, tdt)
        color = rgb(feats, T(d_ray[seg]), tdt)
        color_ray = rgb.apply_per_ray(feats, T(d_ray), T(seg), tdt)
    ref_sigma = jax.jit(jsig.apply, static_argnums=2)(params["sigma"], jfeats, jdt)
    ref_color = jax.jit(jrgb.apply, static_argnums=3)(params["rgb"], jfeats, jnp.asarray(d_ray[seg]), jdt)
    ref_ray = jax.jit(jrgb.apply_per_ray, static_argnums=4)(
        params["rgb"], jfeats, jnp.asarray(d_ray), jnp.asarray(seg), jdt)
    assert sigma.shape == (400,) and color.shape == color_ray.shape == (400, 3)
    np.testing.assert_allclose(sigma.numpy(), _np(ref_sigma), rtol=tol * 2, atol=tol)
    np.testing.assert_allclose(color.numpy(), _np(ref_color), atol=tol)
    np.testing.assert_allclose(color_ray.numpy(), _np(ref_ray), atol=tol)
    # the per-ray branch is the same function as the per-sample one
    np.testing.assert_allclose(color_ray.numpy(), color.numpy(), atol=tol)
