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


# --------------------------------------------------------------------------
# The CUDA kernel's arithmetic (csrc/octbuild.cu, quad build), as numpy
# models: the kernel cannot run without a card.  Values are carried as bit
# patterns (uint32 f32, uint16 bf16, uint8 float8), so equality is
# bit-equality.
# --------------------------------------------------------------------------

# the float8 cast's boundaries (tests/test_torch_gather_dtype.py's, and the
# branch points of the kernel's integer compares: 2^-6 and 464 themselves)
FP8_BOUNDARY = np.array([464, -464, 464.0001, -464.0001, 480, -480, np.inf, -np.inf, np.nan, -np.nan,
                         -0.0, 0.0, 2**-10, -(2**-10), 2**-9 * 1.5, 2**-9 * 0.5, 2**-9 * 2.5, 2**-6,
                         2**-6 * (1 - 2**-24), 2**-7 * 1.9375, 447, 448, 449, 1e3, -1e30, 0.1, -3.3],
                        np.float32)
BITS = {torch.float32: np.uint32, torch.bfloat16: np.uint16, torch.float8_e4m3fn: np.uint8}
OUT_DTYPES = (torch.bfloat16, torch.float32, torch.float8_e4m3fn)
OUT_IDS = ("bf16", "f32", "fp8")


def to_fp8_model(x: np.ndarray) -> np.ndarray:
    """The kernel's `to_bits(float, uint8_t)`, operation by operation: the
    magnitude's bits compared with 464 and 2^-6; subnormals as the f32 sum
    |x| * 512 + 2^23 (the product exact, the sum rounded once to an integer,
    nearest even, as the kernel's fma); normals by the rounding add and the
    shift, rebiased before it."""
    bits = x.astype(np.float32).view(np.uint32)
    mag = bits & np.uint32(0x7FFFFFFF)
    with np.errstate(over="ignore", invalid="ignore"):
        sub = (mag.view(np.float32) * np.float32(512) + np.float32(2**23)).view(np.uint32) - np.uint32(0x4B000000)
    normal = (mag + np.uint32(0x7FFFF) + ((mag >> np.uint32(20)) & np.uint32(1)) - np.uint32(960 << 20)) >> np.uint32(20)
    code = np.where(mag > np.uint32(0x43E80000), np.uint32(0x7F), np.where(mag < np.uint32(0x3C800000), sub, normal))
    return (code | ((bits >> np.uint32(24)) & np.uint32(0x80))).astype(np.uint8)


def test_fp8_cast_model_bytes_equal_to_plain_and_jax():
    rng = np.random.default_rng(1)
    x = np.concatenate([FP8_BOUNDARY, rng.uniform(-500, 500, 50_000), rng.uniform(0, 2**-5, 50_000),
                        rng.normal(size=50_000) * 2.0 ** rng.integers(-20, 10, 50_000)]).astype(np.float32)
    ours = to_fp8_model(x)
    np.testing.assert_array_equal(ours, octbuild.to_float8_e4m3fn(T(x)).view(torch.uint8).numpy())
    np.testing.assert_array_equal(ours, np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).view(np.uint8))


def _round_bits(flat: np.ndarray, out_dtype) -> np.ndarray:
    """Every table value rounded once to `out_dtype`, as its bit pattern."""
    if out_dtype == torch.float8_e4m3fn:
        return to_fp8_model(flat)
    return T(flat).to(out_dtype).view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[out_dtype]) \
        .numpy().view(BITS[out_dtype])


def fast_div(x: int, d: int) -> int:
    """x // d by the kernel's reciprocal, exact while x * d < 2^32."""
    assert x * d < 2**32
    return (x * (2**32 // d + 1)) >> 32


def build_quad_blocks(table: np.ndarray, out_dtype, band: int, lines: int, vec: bool) -> np.ndarray:
    """The kernel's grid over one f32 table [r0, r1, F].  Vector path (F =
    32): block (j band, i band) stages table lines i0 .. i0 + lines from
    cell j0 on (runs of (band + 1) F values, float4 by float4, padded
    apart), then copies whole 16-byte chunks of its rows from there, each
    from one corner pair's run.  Generic path: a block per i and band of j,
    a thread writing 4 values walking (corner, channel)."""
    r0, r1, f = table.shape
    m0, m1 = r0 - 1, r1 - 1
    src = _round_bits(table.reshape(-1), out_dtype)
    size = src.dtype.itemsize
    out = np.full(m0 * m1 * 4 * f, np.iinfo(src.dtype).max, src.dtype)  # unwritten values show
    band, lines = min(band, m1), min(lines, m0)
    if not vec:
        for i in range(m0):
            for j0 in range(0, m1, band):
                nj = min(band, m1 - j0)
                line0, run = (i * r1 + j0) * f, (i * m1 + j0) * f
                for q in range(nj * f):
                    r = q // f
                    start = (q - r * f) * 4
                    corner, ch = divmod(start, f)
                    for e in range(4):
                        out[(run + q) * 4 + e] = src[line0 + (corner >> 1) * r1 * f + (r + (corner & 1)) * f + ch]
                        ch += 1
                        if ch == f:
                            ch, corner = 0, corner + 1
        return out.reshape(m0 * m1, 4 * f)
    assert f == 32
    run4 = (band + 1) * f // 4
    nbytes = run4 * 4 * size
    nbytes += (64 + 128 - nbytes % 128) % 128
    stride, per_chunk, cpr = nbytes // size, 16 // size, f * size // 4
    assert (lines + 1) * run4 * run4 < 2**32
    for i0 in range(0, m0, lines):
        ni = min(lines, m0 - i0)
        for j0 in range(0, m1, band):
            nj = min(band, m1 - j0)
            smem = np.full((lines + 1) * stride, np.iinfo(src.dtype).max, src.dtype)
            base, n4 = (i0 * r1 + j0) * f, (nj + 1) * f // 4
            for x in range((ni + 1) * run4):
                ln = fast_div(x, run4)
                at = x - ln * run4
                if at < n4:
                    g = base + ln * r1 * f + at * 4
                    assert g % 4 == 0  # an aligned float4
                    smem[ln * stride + at * 4 : ln * stride + at * 4 + 4] = src[g : g + 4]
            for li in range(ni):
                dst = ((i0 + li) * m1 + j0) * cpr
                for q in range(nj * cpr):
                    r, c = divmod(q, cpr)
                    e = c * per_chunk
                    dx = e >= 2 * f
                    at = (li + dx) * stride + r * f + (e - 2 * f if dx else e)
                    assert (at * size) % 16 == 0  # a 16-byte read in shared memory
                    assert e % (2 * f) + per_chunk <= 2 * f  # inside one corner pair's run
                    out[(dst + q) * per_chunk : (dst + q + 1) * per_chunk] = smem[at : at + per_chunk]
    return out.reshape(m0 * m1, 4 * f)


# F = 32 (the vector path's width) square and not, then other F (the
# generic path only)
MODEL_SHAPES = [(9, 9, 32), (5, 17, 32), (17, 4, 32), (5, 7, 12), (6, 5, 4), (4, 6, 8), (5, 7, 3), (2, 2, 2),
                (9, 17, 6)]


@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("out_dtype", OUT_DTYPES, ids=OUT_IDS)
def test_quad_kernel_model_bit_equal_to_plain_and_jax(shape, out_dtype):
    rng = np.random.default_rng(sum(shape))
    table = (rng.normal(size=shape) * 2.0 ** rng.integers(-12, 10, shape)).astype(np.float32)
    if out_dtype == torch.float8_e4m3fn:
        table.reshape(-1)[rng.integers(0, table.size, FP8_BOUNDARY.size)] = FP8_BOUNDARY
    plain = octbuild.build_quad_plain(T(table), out_dtype)
    plain_bits = plain.view({torch.float32: torch.int32, torch.bfloat16: torch.int16,
                             torch.float8_e4m3fn: torch.uint8}[out_dtype]).numpy().view(BITS[out_dtype])
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float8_e4m3fn: jnp.float8_e4m3fn}
    ref = np.asarray(joctbuild.build_quad_ref(jnp.asarray(table), jdt[out_dtype])).view(BITS[out_dtype])
    np.testing.assert_array_equal(plain_bits, ref)
    launch = {(1, 1), (3, 2), (octbuild.QUAD_BAND, octbuild.QUAD_LINES)}
    for vec in (True, False) if shape[2] == 32 else (False,):
        for band, lines in sorted(launch):
            np.testing.assert_array_equal(build_quad_blocks(table, out_dtype, band, lines, vec), plain_bits)


def test_quad_vector_loads_needs_f_of_4_and_an_aligned_start():
    """The wrapper's path choice: 16-byte loads only where F % 4 == 0 and
    the table's first value lies on a 16-byte boundary (CPU allocations are
    aligned as the card's are: a view with a storage offset may not be)."""
    odd = torch.zeros(6, 5, 3)  # r1 F = 15: t[1:] starts 60 bytes in
    assert not octbuild.quad_vector_loads(odd) and not octbuild.quad_vector_loads(odd[1:])
    buf = torch.zeros(1 + 4 * 5 * 32)
    assert octbuild.quad_vector_loads(buf[: 4 * 5 * 32].view(4, 5, 32))
    assert not octbuild.quad_vector_loads(buf[1:].view(4, 5, 32))  # F = 32, 4 bytes off
    assert octbuild.quad_vector_loads(buf[4 : 4 + 2 * 5 * 32].view(2, 5, 32))  # 16 bytes in
    assert octbuild.quad_vector_loads(torch.zeros(5, 7, 12)) and not octbuild.quad_vector_loads(torch.zeros(5, 7, 6))


class _Recorder:
    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        self.calls.append((name, args))


@pytest.mark.parametrize("out_dtype", OUT_DTYPES, ids=OUT_IDS)
def test_build_quad_passes_path_and_launch_shape(monkeypatch, out_dtype):
    """The wrapper's call of `tn_build_quad` with the kernel stubbed: the
    path flag from `quad_vector_loads`, the block shape QUAD_BAND,
    QUAD_LINES, QUAD_THREADS (in the range the entry point takes: at least
    one cell each way, 32 .. 512 threads in whole warps), and one launch
    counted per call (float8 ones apart as well)."""
    from tinynerf_tpu_torch.ops import cuda_lib

    assert octbuild.QUAD_BAND >= 1 and octbuild.QUAD_LINES >= 1
    assert 32 <= octbuild.QUAD_THREADS <= 512 and octbuild.QUAD_THREADS % 32 == 0
    rec = _Recorder()
    monkeypatch.setattr(cuda_lib, "runs_plain", lambda name, *t: False)
    monkeypatch.setattr(cuda_lib, "check_cuda_inputs", lambda *a: None)
    monkeypatch.setattr(cuda_lib, "library", lambda: rec)
    monkeypatch.setattr(cuda_lib, "stream_of", lambda t: 7)
    buf = torch.zeros(1 + 5 * 9 * 32)
    cases = [(buf[:-1].view(5, 9, 32), 1), (buf[1:].view(5, 9, 32), 0), (torch.zeros(6, 5, 3)[1:], 0),
             (torch.zeros(4, 4, 12), 1)]
    for table, vec in cases:
        before = octbuild.build_quad.launches, octbuild.build_quad.fp8_launches
        out = octbuild.build_quad(table, out_dtype)
        r0, r1, f = table.shape
        assert out.shape == ((r0 - 1) * (r1 - 1), 4 * f) and out.dtype == out_dtype
        name, args = rec.calls[-1]
        assert name == "tn_build_quad"
        assert args == (table.data_ptr(), r0, r1, f, out.element_size(), vec, octbuild.QUAD_BAND,
                        octbuild.QUAD_LINES, octbuild.QUAD_THREADS, out.data_ptr(), 7)
        fp8 = int(out_dtype == torch.float8_e4m3fn)
        assert (octbuild.build_quad.launches, octbuild.build_quad.fp8_launches) == (before[0] + 1, before[1] + fp8)
    assert len(rec.calls) == len(cases)
