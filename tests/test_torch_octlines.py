"""The line addressing of the oct cell-pack build (csrc/octbuild.cu), as a
numpy model kept here, bit-equal to the JAX package's build_oct_ref and to
the port's build_oct_plain.

The CUDA kernel cannot run without a card, so this file repeats its index
arithmetic: a block takes one i and a band of j and stages two slabs of
band + 1 table lines (each value rounded once on the way in, lines and
slabs padded); output row k of cell (i, j) takes corner pair (dx, dy) from
line[dx][dy][k F : k F + 2F]; a thread assembles a 16-byte chunk from units
of the widest size that divides a corner's bytes (compile-time F), or value
by value with a running (corner, channel) pair (any F); rows are split into
(j, k) by a multiplication with a host-made reciprocal.  Values are carried
as their bit patterns (uint16 for bf16, uint32 for f32), so equality is
bit-equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.ops import octbuild as joctbuild
from tinynerf_tpu_torch.ops import octbuild

torch.set_num_threads(2)

# F = 4, 6, 8 take the unit path, 3 the value-by-value path (and 8 both);
# one grid is not cubic, one has r = 2 on an axis
SHAPES = [(6, 6, 6, 4), (5, 7, 6, 6), (6, 5, 5, 8), (5, 6, 7, 3), (9, 4, 2, 4), (2, 3, 5, 8)]
DTYPES = ((torch.bfloat16, jnp.bfloat16, np.uint16), (torch.float32, jnp.float32, np.uint32))


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


def unit_bytes(corner_bytes: int) -> int:
    return next(b for b in (16, 8, 4, 2) if corner_bytes % b == 0)


def fast_div(x: int, d: int) -> int:
    """x // d by the kernel's reciprocal, exact while x * d < 2^32."""
    assert x * d < 2**32
    return (x * (2**32 // d + 1)) >> 32


def build_oct_lines(table_bits: np.ndarray, band: int, templated: bool) -> np.ndarray:
    """The kernel's grid over one table of bit patterns [r0, r1, r2, F]."""
    r0, r1, r2, f = table_bits.shape
    size = table_bits.dtype.itemsize
    m0, m1, m2 = r0 - 1, r1 - 1, r2 - 1
    per_chunk, cpr = 16 // size, f * size // 2
    line = r2 * f
    line_bytes = -(-line * size // 16) * 16
    if line_bytes % 128 == 0:
        line_bytes += 32
    line_stride = line_bytes // size
    band = min(band, m1)
    slab_bytes = (band + 1) * line_bytes
    slab_bytes += (64 + 128 - slab_bytes % 128) % 128
    slab_stride = slab_bytes // size
    flat = table_bits.reshape(-1)
    out = np.zeros((m0 * m1 * m2 * cpr, per_chunk), table_bits.dtype)  # [chunk, value]
    slabs = np.zeros(2 * slab_stride, table_bits.dtype)

    def load_slab(i, j0, nj, dst):
        src = (i * r1 + j0) * line
        for x in range((nj + 1) * line):
            ln = x // line
            slabs[dst + ln * line_stride + (x - ln * line)] = flat[src + x]

    def gather_chunk(s0, s1, at, c):
        ub = unit_bytes(f * size)
        per_unit = ub // size
        vals = []
        for u in range(16 // ub):
            e = c * per_chunk + u * per_unit
            pair, w = divmod(e, 2 * f)
            s = s1 if pair & 2 else s0
            a = s + at + (pair & 1) * line_stride + w
            assert (a * size) % ub == 0  # the unit's load is aligned
            vals.extend(slabs[a : a + per_unit])
        return vals

    def gather_chunk_any(s0, s1, at, c):
        corner = c * per_chunk // f
        ch = c * per_chunk - corner * f
        vals = []
        for _ in range(per_chunk):
            s = s1 if corner & 4 else s0
            vals.append(slabs[s + at + ((corner >> 1) & 1) * line_stride + (corner & 1) * f + ch])
            ch += 1
            if ch == f:
                ch, corner = 0, corner + 1
        return vals

    n_bands = -(-m1 // band)
    for block in range(n_bands * m0):
        band_i, i = block % n_bands, block // n_bands
        j0 = band_i * band
        nj = min(band, m1 - j0)
        for dx in (0, 1):
            load_slab(i + dx, j0, nj, dx * slab_stride)
        run = (i * m1 + j0) * m2 * cpr
        for q in range(nj * m2 * cpr):
            r, c = divmod(q, cpr)
            jj = fast_div(r, m2)
            k = r - jj * m2
            at = jj * line_stride + k * f
            out[run + q] = (gather_chunk if templated else gather_chunk_any)(0, slab_stride, at, c)
    return out.reshape(m0 * m1 * m2, 8 * f)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtypes", DTYPES, ids=("bf16", "f32"))
def test_oct_line_addressing_bit_equal_to_jax_and_plain(shape, dtypes):
    tdt, jdt, bits = dtypes
    table = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    plain = octbuild.build_oct_plain(torch.from_numpy(table), tdt)
    ref = joctbuild.build_oct_ref(jnp.asarray(table), jdt)
    np.testing.assert_array_equal(plain.float().numpy(), np.asarray(jnp.asarray(ref, jnp.float32)))
    rounded = _bits(torch.from_numpy(table).to(tdt))  # each value rounded once, on the way in
    assert rounded.dtype == bits
    f = shape[3]
    paths = [False] + ([True] if f in (4, 6, 8) else [])
    for templated in paths:
        for band in (2, 8, 1):
            ours = build_oct_lines(rounded, band, templated)
            np.testing.assert_array_equal(ours, _bits(plain), err_msg=f"{templated} {band}")


def test_oct_reciprocal_division_is_exact_in_its_range():
    rng = np.random.default_rng(0)
    for d in (1, 2, 3, 7, 31, 127, 128, 1000, 20000):
        top = min(2**32 // d - 1, 2**31)
        for x in [0, 1, d - 1, d, d + 1, top] + list(rng.integers(0, top, 200)):
            assert fast_div(int(x), d) == int(x) // d, (x, d)
