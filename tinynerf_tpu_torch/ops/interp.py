"""Bilinear plane lookups for the K-Planes forward.

Counterpart of the semantic pieces of `tinynerf_tpu/ops/interp.py` that the
serving forward uses: `_to_index_space`, `_cell_2d` and the per-scale value
`_quad_lookup_fwd_value`.  Tables are feature-last `[r0, r1, F]`;
coordinates are in [-1, 1] with align_corners=True semantics (-1 -> index
0, +1 -> index r-1).

The JAX package builds a cell-packed `[(r0-1)(r1-1), 4F]` table so that a
TPU gathers one row per sample; that is a TPU layout of the same values.
Here the four corner rows are gathered from the flat `[r0*r1, F]` table
directly.  Rounding to `gather_dtype` is elementwise, so rounding the
gathered rows equals gathering from a rounded table; the lerp is f32.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _to_index_space(c: torch.Tensor, res: int) -> torch.Tensor:
    """[-1,1] -> continuous index in [0, res-1], clamped to the table."""
    x = (c + 1.0) * 0.5 * (res - 1)
    return torch.clamp(x, 0.0, float(res - 1))


def _cell_origin(coords: torch.Tensor, r0: int, r1: int):
    """Cell origin (x0, y0) clipped to [0, r-2] and the bilinear weights
    [..., 4] in corner order 00, 01, 10, 11."""
    x = _to_index_space(coords[..., 0], r0)
    y = _to_index_space(coords[..., 1], r1)
    x0 = torch.clamp(torch.floor(x), 0, r0 - 2).to(torch.int32)
    y0 = torch.clamp(torch.floor(y), 0, r1 - 2).to(torch.int32)
    tx = x - x0
    ty = y - y0
    w = torch.stack(
        [(1 - tx) * (1 - ty), (1 - tx) * ty, tx * (1 - ty), tx * ty], dim=-1
    )
    return x0.long(), y0.long(), w


def _cell_2d(coords: torch.Tensor, r0: int, r1: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cell [...] row of the (r0-1)*(r1-1) cell grid, weights [..., 4]).

    The origin is clipped to [0, r-2] (unlike a corner clamp, the last cell
    interpolates with t == 1 at coord +1, which is exactly the edge value)."""
    x0, y0, w = _cell_origin(coords, r0, r1)
    return x0 * (r1 - 1) + y0, w


def _quad_lookup_fwd_value(
    table: torch.Tensor, coords: torch.Tensor,
    gather_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Bilinear lookup of `table` [r0, r1, F] at coords [..., 2] -> f32 [..., F].

    Corner rows are rounded to `gather_dtype`, then weighted and summed in
    f32."""
    r0, r1, f = table.shape
    x0, y0, w = _cell_origin(coords, r0, r1)
    base = x0 * r1 + y0  # flat row of corner 00 in the [r0*r1, F] table
    offsets = torch.tensor((0, 1, r1, r1 + 1), device=table.device)
    rows = table.reshape(r0 * r1, f)[base[..., None] + offsets]  # [..., 4, F]
    vals = rows.to(gather_dtype).float()
    return torch.sum(vals * w[..., None], dim=-2)
