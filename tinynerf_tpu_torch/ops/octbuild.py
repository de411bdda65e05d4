"""Cell-packed (oct) table build for the trilinear lookup, through a
hand-written CUDA kernel.

Counterpart of `tinynerf_tpu/ops/octbuild.py`'s `build_oct_pallas` (the
TPU kernel `_oct_kernel_mxu`): `[r0, r1, r2, F]` f32 -> `[(r0-1)(r1-1)(r2-1),
8F]`, row (i, j, k) of the cell grid holding the cell's eight corner rows of
F values in `CORNERS_3D` order, cast to `out_dtype` (bf16 or f32).  On CUDA
tensors `build_oct` launches `csrc/octbuild.cu`; on CPU tensors it runs the
plain version, `build_oct_plain` (the slice-stack form of `build_oct_ref`).
Both are bit-equal: the build only moves values and rounds each once.
"""

from __future__ import annotations

import torch

from . import cuda_lib

# corner order: z fastest, then y, then x; ops/interp.py `_cell_3d`'s weights
# follow it
CORNERS_3D = tuple((dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1))

OUT_DTYPES = (torch.bfloat16, torch.float32)


def _shape(table: torch.Tensor, out_dtype) -> tuple:
    if table.dim() != 4 or min(table.shape[:3]) < 2:
        raise ValueError(f"build_oct: expected [r0, r1, r2, F] with every r >= 2, got {tuple(table.shape)}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"build_oct: out_dtype must be one of {OUT_DTYPES}, got {out_dtype}")
    return tuple(table.shape)


def build_oct_plain(table: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version: the eight shifted slices stacked corner-major."""
    r0, r1, r2, f = _shape(table, out_dtype)
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
    r0, r1, r2, f = _shape(table, out_dtype)
    cuda_lib.check_cuda_inputs("build_oct", torch.float32, table.shape, table)
    out = torch.empty((r0 - 1) * (r1 - 1) * (r2 - 1), 8 * f, dtype=out_dtype, device=table.device)
    if f:
        cuda_lib.library().call(
            "tn_build_oct", table.data_ptr(), r0, r1, r2, f,
            int(out_dtype == torch.bfloat16), out.data_ptr(), cuda_lib.stream_of(table),
        )
        build_oct.launches += 1
    return out


build_oct.launches = 0
