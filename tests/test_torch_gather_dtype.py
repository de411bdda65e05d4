"""The fields' gather dtypes and the K-Planes plane init range against the
JAX package: the quad build's float8_e4m3fn and f32 output (kernel 7's
plain version), the K-Planes field and its deterministic train step with
float8 and f32 gathers, Cobafa's f32 gathers ("float32", and "float8",
which the JAX field maps to f32), and `init_range`.

Inputs are made with numpy from a seed; parameters are initialized by the
JAX package and carried across with `tinynerf_tpu_torch.convert`.  The
field and step setup is tests/torch_world.py's (planes 9/17/33; Cobafa
basis grids 8/8/8/8/10/12).  Tolerances: the builds bit-equal, as bytes
(a relayout with one rounding, JAX's float8 rule written out in
`ops/octbuild.py:to_float8_e4m3fn`, whose boundaries torch's own cast does
not keep); the K-Planes field 1e-5 (f32 lerps in another order); the step
as tests/test_torch_train_slice.py holds it (loss 1e-5 relative, gradients
1e-4 of each leaf's largest); Cobafa 1e-4 (tests/test_torch_cobafa.py).
The init range draws from torch's generator, which JAX's cannot match, so
only its range and mean are checked.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.models import make_model as jmake_model
from tinynerf_tpu.ops import interp as jinterp
from tinynerf_tpu.parallel import make_mesh
from tinynerf_tpu.train import TrainConfig as JConfig
from tinynerf_tpu.train import loop as jloop
from tinynerf_tpu_torch.convert import load_params, tree_leaves_with_path
from tinynerf_tpu_torch.models import make_model
from tinynerf_tpu_torch.models.kplanes import GATHER_DTYPE, GATHER_DTYPES
from tinynerf_tpu_torch.ops import octbuild
from tinynerf_tpu_torch.train import TrainConfig, build_renderer, make_optimizer, make_train_step
from torch_world import CFG, COBAFA_CFG, make_scene, make_world

torch.set_num_threads(2)

T = torch.from_numpy
JDTYPES = {"float8": jnp.float8_e4m3fn, "float32": jnp.float32}

# the float8 boundaries: JAX's NaN above 464 and at +-inf, 464 itself to
# 448, the sign of NaN and of zero, subnormals down to 2^-9 and half of it
BOUNDARY = np.array([464, -464, 464.0001, -464.0001, 480, -480, np.inf, -np.inf, np.nan, -np.nan,
                     -0.0, 0.0, 2**-10, 2**-9 * 1.5, 2**-9 * 0.5, 2**-9 * 2.5, 2**-6, 447, 448, 449,
                     1e3, -1e30, 0.1, -3.3], np.float32)


def _bytes(x) -> np.ndarray:
    """The raw bytes of a numpy / jax array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    a = np.asarray(x)
    return a.view(np.uint8)


def _tables(seed: int) -> list:
    """Tables holding the boundary values among U(0, 1) values, plain
    U(0, 1) planes, and a wide-range table."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((9, 9, 32), (17, 5, 6), (5, 7, 3), (2, 2, 1)):
        t = rng.uniform(0, 1, shape).astype(np.float32)
        flat = t.reshape(-1)
        pos = rng.choice(flat.size, size=min(flat.size, BOUNDARY.size), replace=False)
        flat[pos] = BOUNDARY[: pos.size]
        out.append(t)
    out.append(rng.uniform(0, 1, (33, 33, 8)).astype(np.float32))
    out.append((rng.normal(size=(9, 17, 4)) * 2.0 ** rng.integers(-12, 10, (9, 17, 4))).astype(np.float32))
    return out


@pytest.mark.parametrize("gather", ["float8", "float32"])
def test_build_quad_plain_bytes_equal_to_jax(gather):
    """`build_quad_plain` in float8 and f32, as bytes, against the JAX
    `_build_quad` (the off-TPU form of the Pallas build)."""
    tdt, jdt = GATHER_DTYPES[gather], JDTYPES[gather]
    for t in _tables(3):
        ours = octbuild.build_quad_plain(T(t), tdt)
        r0, r1, f = t.shape
        assert ours.dtype == tdt and ours.shape == ((r0 - 1) * (r1 - 1), 4 * f)
        before = octbuild.build_quad.launches, octbuild.build_quad.fp8_launches
        np.testing.assert_array_equal(_bytes(octbuild.build_quad(T(t), tdt)), _bytes(ours))
        assert (octbuild.build_quad.launches, octbuild.build_quad.fp8_launches) == before  # CPU: plain
        ref = jinterp._build_quad(jnp.asarray(t), jdt)
        np.testing.assert_array_equal(_bytes(ours), _bytes(ref))


def test_float8_cast_bytes_equal_to_jax_where_torch_saturates():
    """The cast alone over the boundaries and 300,000 values of every
    magnitude: JAX's bytes everywhere, while torch's own cast differs at
    |x| > 464 (it saturates), which is why the port writes the rule out."""
    rng = np.random.default_rng(0)
    x = np.concatenate([BOUNDARY, rng.uniform(-500, 500, 100_000), rng.uniform(0, 1, 100_000),
                        rng.normal(size=100_000) * 2.0 ** rng.integers(-20, 10, 100_000)]).astype(np.float32)
    ours = _bytes(octbuild.to_float8_e4m3fn(T(x)))
    ref = _bytes(jnp.asarray(x).astype(jnp.float8_e4m3fn))
    np.testing.assert_array_equal(ours, ref)
    torch_cast = _bytes(T(x).to(torch.float8_e4m3fn))
    differ = torch_cast != ref
    assert differ.any() and np.all(~(np.abs(x[differ]) <= 464))


def test_oct_build_refuses_float8():
    with pytest.raises(TypeError, match="out_dtype"):
        octbuild.build_oct(torch.zeros(3, 3, 3, 2), torch.float8_e4m3fn)


@pytest.fixture(scope="module")
def kplanes_fields():
    jfield = jmake_model("kplanes", field_scale=CFG["field_scale"])[0]
    jparams = jax.jit(jfield.init)(jax.random.PRNGKey(4))
    return jfield, jparams


@pytest.mark.parametrize("gather", ["float8", "float32"])
def test_kplanes_field_gather_dtype_matches_jax(kplanes_fields, gather):
    """The field's forward at f32 compute with float8 and f32 gathers
    against the JAX field with the same `gather_dtype`, parameters carried
    over; and the two gathers do differ (float8 rounds the planes)."""
    jfield, jparams = kplanes_fields
    jf = dataclasses.replace(jfield, gather_dtype=gather)
    field = make_model("kplanes", field_scale=CFG["field_scale"], gather_dtype=gather)[0]
    assert field.gather_dtype == gather
    with torch.no_grad():
        for s, scale in enumerate(jparams["planes"]):
            for p, plane in enumerate(scale):
                field.planes[s][p].copy_(T(np.array(plane)))
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    x[:2] = [[-1, -1, -1], [1, 1, 1]]
    with torch.no_grad():
        got = torch.cat(field.apply_pieces(T(x)), -1).numpy()
    ref = np.asarray(jax.jit(jf.apply)(jparams, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    field.gather_dtype = "bfloat16"
    with torch.no_grad():
        bf16 = torch.cat(field.apply_pieces(T(x)), -1).numpy()
    assert np.abs(bf16 - got).max() > 1e-4


def test_field_options_refuse_unknown_gather():
    with pytest.raises(ValueError, match="gather_dtype"):
        make_model("kplanes", field_scale=0.07, gather_dtype="float16")
    assert GATHER_DTYPES["bfloat16"] is GATHER_DTYPE
    with pytest.raises(TypeError):
        make_model("vanilla", field_scale=0.07, gather_dtype="float8")  # the vanilla field has no gathers


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return make_world(make_scene(tmp_path_factory.mktemp("gather_scene") / "spheres"))


def test_kplanes_step_with_float8_gathers_matches_jax(world):
    """One deterministic step with float8 gathers against JAX's
    `make_train_step(deterministic=True)` of the same field: the loss, and
    every gradient leaf."""
    n_cand = 64
    jr = world["jr"]
    jr = dataclasses.replace(jr, field=dataclasses.replace(jr.field, gather_dtype="float8"))
    rng = np.random.default_rng(9)
    # rays of a test view with random colors, the same 64 for both
    o = np.asarray(world["jset"].rays_o[0]).reshape(-1, 3)
    d = np.asarray(world["jset"].rays_d[0]).reshape(-1, 3)
    pick = rng.choice(o.shape[0], n_cand, replace=False)
    rays = (o[pick], d[pick], rng.uniform(0, 1, (n_cand, 3)).astype(np.float32))

    jcfg = JConfig(compute_dtype="float32", **CFG)
    jopt = jloop.make_optimizer(jcfg)
    jstep = jloop.make_train_step(jr, jopt, jcfg, make_mesh(jax.devices()[:1]), n_cand=n_cand,
                                  deterministic=True)
    params = jax.tree_util.tree_map(jnp.array, world["params"])
    _, _, m = jstep(params, jopt.init(params), jr.occupancy.init_state(), *(jnp.asarray(a) for a in rays),
                    jax.random.PRNGKey(0))

    cfg = TrainConfig(compute_dtype="float32", **CFG)
    r = build_renderer(cfg, world["pset"].scene_scale, world["pset"].bg_color, device="cpu")
    load_params(r, jax.tree_util.tree_map(np.asarray, world["params"]))
    r.field.gather_dtype = "float8"
    step = make_train_step(r, make_optimizer(cfg, r), cfg, n_cand=n_cand, deterministic=True)
    ours = step(r.occupancy.init_state(), *(T(a) for a in rays))
    assert float(ours["loss"]) == pytest.approx(float(m["loss"]), rel=1e-5)
    g = [np.asarray(v) for _, v in tree_leaves_with_path(ours["grads"])]
    jg = [np.asarray(v) for v in jax.tree_util.tree_leaves(m["grads"])]
    assert len(g) == len(jg) > 0
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max())
    assert sum(int(np.count_nonzero(a)) for a in g if a.ndim == 3) > 100  # the planes got gradients


@pytest.fixture(scope="module")
def cobafa_params():
    jfield, jsig, jrgb = jmake_model("cobafa", field_scale=COBAFA_CFG["field_scale"])
    kf, ks, kr = jax.random.split(jax.random.PRNGKey(0), 3)
    params = jax.jit(lambda: {"field": jfield.init(kf), "sigma": jsig.init(ks), "rgb": jrgb.init(kr)})()
    return jfield, params


@pytest.mark.parametrize("gather", ["float32", "float8"])
def test_cobafa_gather_dtype_matches_jax(cobafa_params, gather):
    """Cobafa with `gather_dtype` "float32" and "float8" (both f32 in the
    JAX field) against the JAX field in quad mode, at f32 compute."""
    jfield, params = cobafa_params
    jf = dataclasses.replace(jfield, lookup_mode="quad", gather_dtype=gather)
    r = build_renderer(TrainConfig(**COBAFA_CFG), 1.0, None, device="cpu")
    load_params(r, jax.tree_util.tree_map(np.asarray, params))
    r.field.gather_dtype = gather
    x = np.random.default_rng(5).uniform(-1, 1, (500, 3)).astype(np.float32)
    with torch.no_grad():
        (got,) = r.field.apply_pieces(T(x))
    ref = np.asarray(jax.jit(jf.apply)(params["field"], jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)
    # and not the bf16 default's values
    r.field.gather_dtype = "bfloat16"
    with torch.no_grad():
        (bf16,) = r.field.apply_pieces(T(x))
    assert np.abs(bf16.numpy() - got.numpy()).max() > 1e-4


@pytest.mark.parametrize("method", ["kplanes", "cobafa"])
def test_init_range(method):
    """`init_range=(0.5, 1.5)`: every table inside [0.5, 1.5) with a mean
    near 1; the defaults keep U(0, 1) planes and U(0.5, 1.5) grids."""
    gen = torch.Generator().manual_seed(0)
    field = make_model(method, field_scale=0.07, generator=gen, init_range=(0.5, 1.5))[0]
    tables = torch.cat([p.detach().reshape(-1) for p in field.parameters() if p.dim() >= 3])
    assert tables.numel() > 10_000
    assert float(tables.min()) >= 0.5 and float(tables.max()) < 1.5
    assert float(tables.mean()) == pytest.approx(1.0, abs=0.01)
    default = make_model(method, field_scale=0.07, generator=torch.Generator().manual_seed(0))[0]
    lo = 0.0 if method == "kplanes" else 0.5
    tables = torch.cat([p.detach().reshape(-1) for p in default.parameters() if p.dim() >= 3])
    assert float(tables.min()) >= lo and float(tables.max()) < lo + 1.0
    assert float(tables.mean()) == pytest.approx(lo + 0.5, abs=0.01)
