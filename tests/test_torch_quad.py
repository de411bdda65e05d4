"""The quad cell-pack build (kernel 7's plain version) and the K-Planes
forward through it, against the JAX package and the port's former
direct-gather forward.

`build_quad_plain` must be bit-equal to `build_quad_ref` and to the Pallas
kernel `build_quad_pallas` in interpret mode, at every F (odd ones too: a
bf16 quad row of an odd F is not a whole number of 16-byte chunks, which the
CUDA kernel must handle) in both output types.  The forward through the quad
table must be bit-equal to the direct gather of the four corner rows it
replaces (kept below as the reference: rounding to the gather type is
elementwise, so a row of the rounded table is the rounded corner rows), and
within 1e-6 of JAX's (the bilinear weights of the two frameworks differ in
the last ulp, tests/test_torch_ops.py).  The K-Planes field and its table
gradients are held to the tolerances of tests/test_torch_models.py (f32
1e-5, bf16 compute 2e-2) and tests/test_torch_train_ops.py (gradients 1e-5
of their max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.models import make_model as jmake_model
from tinynerf_tpu.ops import interp as jinterp
from tinynerf_tpu.ops import octbuild as joctbuild
from tinynerf_tpu_torch.models import make_model
from tinynerf_tpu_torch.ops import interp, octbuild

torch.set_num_threads(2)

T = torch.from_numpy
DTYPES = ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32))
# planes of the default field cut to test size, odd and small channel counts
# (the JAX tests build F = 2, 6, 8), and the smallest plane
QUAD_SHAPES = [(9, 9, 32), (17, 17, 32), (9, 17, 6), (5, 7, 3), (6, 5, 1), (2, 2, 2), (4, 3, 8)]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("shape", QUAD_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtypes", DTYPES, ids=("bf16", "f32"))
def test_build_quad_plain_bit_equal_to_jax(shape, dtypes):
    tdt, jdt = dtypes
    table = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    ours = octbuild.build_quad_plain(T(table), tdt)
    r0, r1, f = shape
    assert ours.shape == ((r0 - 1) * (r1 - 1), 4 * f) and ours.dtype == tdt
    before = octbuild.build_quad.launches
    assert torch.equal(octbuild.build_quad(T(table), tdt), ours)  # CPU tensor: the plain version
    assert octbuild.build_quad.launches == before
    ref = joctbuild.build_quad_ref(jnp.asarray(table), jdt)
    pallas = joctbuild.build_quad_pallas(jnp.asarray(table), jdt, interpret=True)
    np.testing.assert_array_equal(ours.float().numpy(), _np(ref))
    np.testing.assert_array_equal(ours.float().numpy(), _np(pallas))


def test_build_quad_refuses_bad_input():
    with pytest.raises(ValueError, match=r"\[r0, r1, F\]"):
        octbuild.build_quad(torch.zeros(1, 4, 2))
    with pytest.raises(ValueError, match=r"\[r0, r1, F\]"):
        octbuild.build_quad(torch.zeros(4, 4, 4, 2))
    with pytest.raises(TypeError, match="out_dtype"):
        octbuild.build_quad(torch.zeros(4, 4, 2), torch.float16)


def _direct_gather(table, coords, gather_dtype):
    """The former forward: the four corner rows gathered straight from the
    f32 table, rounded to `gather_dtype`, lerped in f32."""
    r0, r1, f = table.shape
    x0, y0, w = interp._cell_origin(coords, r0, r1)
    base = x0 * r1 + y0
    offsets = torch.tensor((0, 1, r1, r1 + 1))
    rows = table.reshape(r0 * r1, f)[base[..., None] + offsets]
    return torch.sum(rows.to(gather_dtype).float() * w[..., None], dim=-2)


@pytest.mark.parametrize("dtypes", DTYPES, ids=("bf16", "f32"))
def test_quad_lookup_bit_equal_to_direct_gather_and_close_to_jax(dtypes):
    tdt, jdt = dtypes
    rng = np.random.default_rng(3)
    for r0, r1, f in ((9, 17, 32), (33, 33, 8), (5, 6, 3)):
        table = rng.uniform(0, 1, (r0, r1, f)).astype(np.float32)
        coords = rng.uniform(-1.05, 1.05, (3, 200, 2)).astype(np.float32)
        coords[0, :4] = [[-1, -1], [1, 1], [1, -1], [0, 0]]  # edges and the last cell
        ours = interp._quad_lookup_fwd_value(T(table), T(coords), tdt)
        assert ours.shape == (3, 200, f) and ours.dtype == torch.float32
        assert torch.equal(ours, _direct_gather(T(table), T(coords), tdt))
        ref = jinterp._quad_lookup_fwd_value(jnp.asarray(table), jnp.asarray(coords), jdt)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kplanes_field_through_quad_tables_matches_jax(dtype):
    """The field's forward at f32 and bf16 compute, and at f32 its plane
    gradients (the backward is unchanged: the fine-grid scatter on the
    CPU), against the JAX field's default (fused, per-scale) lookup."""
    tdt, jdt, tol = {"float32": (torch.float32, jnp.float32, 1e-5),
                     "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}[dtype]
    jfield = jmake_model("kplanes", field_scale=0.07)[0]
    jparams = jax.jit(jfield.init)(jax.random.PRNGKey(4))
    field = make_model("kplanes", field_scale=0.07)[0]
    with torch.no_grad():
        for s, scale in enumerate(jparams["planes"]):
            for p, plane in enumerate(scale):
                field.planes[s][p].copy_(T(np.array(plane)))
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    x[:2] = [[-1, -1, -1], [1, 1, 1]]
    before = octbuild.build_quad.launches
    got = field.apply_pieces(T(x), tdt)
    assert octbuild.build_quad.launches == before  # CPU tensors: the plain build
    ref = jax.jit(jfield.apply_pieces, static_argnums=2)(jparams, jnp.asarray(x), jdt)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.float().detach().numpy(), _np(r), atol=tol, rtol=tol)
    if dtype != "float32":
        return
    cot = rng.normal(size=(500, field.feature_dim)).astype(np.float32)
    torch.sum(torch.cat(got, -1) * T(cot)).backward()
    jgrad = jax.grad(lambda p: jnp.sum(jfield.apply(p, jnp.asarray(x), jnp.float32) * cot))(jparams)
    ours = [p.grad.numpy() for s in field.planes for p in s]
    theirs = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrad["planes"])]
    assert len(ours) == len(theirs) == 9
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max())
