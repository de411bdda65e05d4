"""Cell-packed table builds for the trilinear (oct) and bilinear (quad)
lookups, through hand-written CUDA kernels.

Counterpart of `tinynerf_tpu/ops/octbuild.py`:

  * `build_oct` (the TPU kernel `_oct_kernel_mxu` behind
    `build_oct_pallas`): `[r0, r1, r2, F]` f32 -> `[(r0-1)(r1-1)(r2-1), 8F]`,
    row (i, j, k) of the cell grid holding the cell's eight corner rows of F
    values in `CORNERS_3D` order (Cobafa's grids);
  * `build_quad` (the TPU kernel `_quad_kernel` behind `build_quad_pallas`):
    `[r0, r1, F]` f32 -> `[(r0-1)(r1-1), 4F]`, row (i, j) holding the cell's
    four corner rows in `CORNERS_2D` order (K-Planes' planes).

Both cast to `out_dtype` (bf16 or f32; the quad build also to
float8_e4m3fn, the K-Planes field's `gather_dtype="float8"`).  On CUDA
tensors they launch `csrc/octbuild.cu`; on CPU tensors they run the plain
versions, `build_oct_plain` / `build_quad_plain` (the slice-stack forms of
`build_oct_ref` / `build_quad_ref`).  Kernel and plain version are
bit-equal: a build only moves values and rounds each once.

The float8 rounding is JAX's (`jnp.astype(jnp.float8_e4m3fn)`), written out
in `to_float8_e4m3fn`: nearest even as if the format had a code above 448,
and that code is NaN, so |x| > 464 and +-inf give NaN of x's sign while 464
itself gives 448.  torch's own cast saturates those to +-448, and CUDA's
`__nv_cvt_float_to_fp8` either saturates or not by a flag, so neither the
plain version nor the kernel relies on a library cast.
"""

from __future__ import annotations

import torch

from . import cuda_lib

# corner order: z fastest, then y, then x; ops/interp.py `_cell_3d`'s weights
# follow it
CORNERS_3D = tuple((dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1))
# corner order 00, 01, 10, 11; ops/interp.py `_cell_origin`'s weights follow it
CORNERS_2D = tuple((dx, dy) for dx in (0, 1) for dy in (0, 1))

OUT_DTYPES = (torch.bfloat16, torch.float32)
# the quad build also emits float8 (the JAX oct build is never asked for it:
# the Cobafa field maps "float8" to f32)
QUAD_OUT_DTYPES = OUT_DTYPES + (torch.float8_e4m3fn,)

# the oct kernel's block shape (csrc/octbuild.cu): a block of OCT_THREADS
# threads stages the table lines of up to OCT_BAND cells of j for one i
OCT_BAND, OCT_THREADS = 2, 256
# the quad kernel's: a block of QUAD_THREADS threads stages the table lines
# of up to QUAD_LINES cells of i by QUAD_BAND cells of j and writes their rows
QUAD_BAND, QUAD_LINES, QUAD_THREADS = 16, 4, 256


def _shape(name: str, table: torch.Tensor, out_dtype, n_axes: int, out_dtypes=OUT_DTYPES) -> tuple:
    if table.dim() != n_axes + 1 or min(table.shape[:n_axes]) < 2:
        dims = ", ".join(f"r{i}" for i in range(n_axes))
        raise ValueError(f"{name}: expected [{dims}, F] with every r >= 2, got {tuple(table.shape)}")
    if out_dtype not in out_dtypes:
        raise TypeError(f"{name}: out_dtype must be one of {out_dtypes}, got {out_dtype}")
    return tuple(table.shape)


def to_float8_e4m3fn(x: torch.Tensor) -> torch.Tensor:
    """f32 -> float8_e4m3fn by JAX's rule, bit for bit (the device function
    `to_bits(float, uint8_t)` of csrc/octbuild.cu gives the same bytes): round to nearest
    even; normals by rounding the f32 bits' low 20 mantissa bits away,
    subnormals (|x| < 2^-6, steps of 2^-9) as round(|x| * 2^9); |x| > 464,
    +-inf and NaN become NaN (0x7F) with x's sign bit."""
    bits = x.float().contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    a = mag.view(torch.float32)
    normal = (mag + (0x7FFFF + ((mag >> 20) & 1))) >> 20  # the exponent and 3 mantissa bits, rounded
    code = torch.where(a < 2.0**-6, torch.round(a * 2.0**9).to(torch.int32), normal - (120 << 3))
    code = torch.where(a > 464.0, 0x7F, code)  # false for NaN, which the next line takes
    code = torch.where(torch.isnan(a), 0x7F, code)
    code = code | ((bits >> 24) & 0x80)
    return code.to(torch.uint8).view(torch.float8_e4m3fn)


def _cast(t: torch.Tensor, out_dtype) -> torch.Tensor:
    return to_float8_e4m3fn(t) if out_dtype == torch.float8_e4m3fn else t.to(out_dtype)


def build_oct_plain(table: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version: the eight shifted slices stacked corner-major."""
    r0, r1, r2, f = _shape("build_oct", table, out_dtype, 3)
    t = table.to(out_dtype)
    q = torch.stack(
        [t[dx : dx + r0 - 1, dy : dy + r1 - 1, dz : dz + r2 - 1] for dx, dy, dz in CORNERS_3D],
        dim=-2,
    )  # [r0-1, r1-1, r2-1, 8, F]
    return q.reshape((r0 - 1) * (r1 - 1) * (r2 - 1), 8 * f)


def build_oct(table: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """`[r0, r1, r2, F]` f32 -> `[(r0-1)(r1-1)(r2-1), 8F]` of `out_dtype`:
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if cuda_lib.runs_plain("build_oct", table):
        return build_oct_plain(table, out_dtype)
    r0, r1, r2, f = _shape("build_oct", table, out_dtype, 3)
    cuda_lib.check_cuda_inputs("build_oct", torch.float32, table.shape, table)
    out = torch.empty((r0 - 1) * (r1 - 1) * (r2 - 1), 8 * f, dtype=out_dtype, device=table.device)
    if f:
        cuda_lib.library().call(
            "tn_build_oct", table.data_ptr(), r0, r1, r2, f, int(out_dtype == torch.bfloat16),
            OCT_BAND, OCT_THREADS, out.data_ptr(), cuda_lib.stream_of(table),
        )
        build_oct.launches += 1
    return out


build_oct.launches = 0


def build_quad_plain(table: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version: the four shifted slices stacked corner-major."""
    r0, r1, f = _shape("build_quad", table, out_dtype, 2, QUAD_OUT_DTYPES)
    t = _cast(table, out_dtype)
    q = torch.stack([t[dx : dx + r0 - 1, dy : dy + r1 - 1] for dx, dy in CORNERS_2D], dim=-2)
    return q.reshape((r0 - 1) * (r1 - 1), 4 * f)  # [r0-1, r1-1, 4, F] flattened


def quad_vector_loads(table: torch.Tensor) -> bool:
    """Whether the quad kernel may read `table` ([r0, r1, F] f32, contiguous)
    by 16-byte loads: F a multiple of 4 and the first value on a 16-byte
    boundary, so that every 4 values of a line are one aligned float4.  A view
    with a storage offset may start off it (`t[1:]` of an odd F, `buf[1:]`);
    it then takes the generic path, value by value."""
    return table.shape[-1] % 4 == 0 and table.data_ptr() % 16 == 0


def build_quad(table: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """`[r0, r1, F]` f32 -> `[(r0-1)(r1-1), 4F]` of `out_dtype` (bf16, f32
    or float8_e4m3fn): the kernel on a CUDA tensor (its vector path where
    F = 32 and `quad_vector_loads`, else its generic path), the plain
    version on a CPU tensor."""
    if cuda_lib.runs_plain("build_quad", table):
        return build_quad_plain(table, out_dtype)
    r0, r1, f = _shape("build_quad", table, out_dtype, 2, QUAD_OUT_DTYPES)
    cuda_lib.check_cuda_inputs("build_quad", torch.float32, table.shape, table)
    out = torch.empty((r0 - 1) * (r1 - 1), 4 * f, dtype=out_dtype, device=table.device)
    if f:
        cuda_lib.library().call(
            "tn_build_quad", table.data_ptr(), r0, r1, f, out.element_size(),
            int(quad_vector_loads(table)), QUAD_BAND, QUAD_LINES, QUAD_THREADS, out.data_ptr(),
            cuda_lib.stream_of(table),
        )
        build_quad.launches += 1
        if out_dtype == torch.float8_e4m3fn:
            build_quad.fp8_launches += 1
    return out


# every launch, and apart the launches with float8 output
build_quad.launches = 0
build_quad.fp8_launches = 0
