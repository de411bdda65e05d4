"""Bilinear plane lookups for K-Planes and trilinear grid lookups for
Cobafa, and their table gradients.

Counterpart of the pieces of `tinynerf_tpu/ops/interp.py` that the two
fields use: `_to_index_space`, `_cell_2d`, the per-scale value
`_quad_lookup_fwd_value`, the exact 2x upsampling of nested grids and its
transpose, `multiscale_lookup_multiproj` (the lookup of every scale of every
projection under one autograd Function), and for Cobafa `_cell_3d`,
`trilinear_lookup_oct` and `sawtooth`; the plain `trilinear_lookup` of the
occupancy grid's trilinear query; and the pullback split over the ranks of
a data-parallel group (`_sharded_pullback`, the JAX `shard_axis`).  Tables
are feature-last (`[r0, r1, F]`, `[r0, r1, r2, F]`); coordinates are in
[-1, 1] with align_corners=True semantics (-1 -> index 0, +1 -> index r-1).

Both lookups go through the JAX package's cell-packed tables
(`ops/octbuild.py`, CUDA kernels on the card): each K-Planes plane is built
into a `[(r0-1)(r1-1), 4F]` quad table of `gather_dtype` (`build_quad`) and
each sample gathers one 4F row; each Cobafa grid into an oct table, one 8F
row per sample.  The lerp is f32.  Only coordinates and tables are saved for
the backward, so no packed table stays alive into it.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from .bitonic import packed_bits_ok
from .octbuild import CORNERS_3D, build_oct, build_quad
from .table_grad import default_window, table_grad_sorted


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

    The quad table of `gather_dtype` (bf16, f32 or float8_e4m3fn; corners
    rounded once), one 4F row gathered per sample in that type (a float8
    row is 4F bytes: the gather moves a quarter of f32's bytes) and widened
    to f32, the four corners weighted and summed in f32."""
    r0, r1, f = table.shape
    quad = build_quad(table, gather_dtype)
    cell, w = _cell_2d(coords, r0, r1)
    rows = quad.index_select(0, cell.reshape(-1)).float()
    vals = rows.reshape(*cell.shape, 4, f)
    return torch.sum(vals * w[..., None], dim=-2)


# --------------------------------------------------------------------------
# Exact 2x upsampling of nested align_corners grids: a bilinear interpolant
# on an (r, r) table is reproduced EXACTLY by bilinear interpolation of its
# samples on the (2r-1, 2r-1) grid (nodes kept, midpoints averaged in).  So
# every scale's gradient can be taken on the finest grid and pulled back
# through the transpose of the upsampling.
# --------------------------------------------------------------------------


def _upsample2x_axis0(x: torch.Tensor) -> torch.Tensor:
    """[r, ...] -> [2r-1, ...]: nodes kept, midpoints 0.5 * (left + right)."""
    out = x.new_empty((2 * x.shape[0] - 1,) + tuple(x.shape[1:]))
    out[0::2] = x
    out[1::2] = 0.5 * (x[:-1] + x[1:])
    return out


def upsample2x_exact(table: torch.Tensor) -> torch.Tensor:
    """[r0, r1, F] -> [2*r0-1, 2*r1-1, F], exact for bilinear interpolation."""
    t = _upsample2x_axis0(table)
    return _upsample2x_axis0(t.transpose(0, 1)).transpose(0, 1)


def upsample_to(table: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    """Repeated exact 2x upsampling up to (r0, r1); the resolutions must nest
    ((target-1) = 2^k * (source-1))."""
    while table.shape[0] < r0 or table.shape[1] < r1:
        table = upsample2x_exact(table)
    if tuple(table.shape[:2]) != (r0, r1):
        raise ValueError(f"resolutions do not nest: got {tuple(table.shape[:2])}, want {(r0, r1)}")
    return table


def _down_axis0(g: torch.Tensor) -> torch.Tensor:
    """Transpose of `_upsample2x_axis0`: [2r-1, ...] -> [r, ...],
    out[c] = g[2c] + 0.5 * (g[2c-1] + g[2c+1]) (terms past the edge are 0)."""
    out = g[0::2].clone()
    half = 0.5 * g[1::2]
    out[:-1] += half
    out[1:] += half
    return out


def _pullback_scales(fine: torch.Tensor, tables: Sequence[torch.Tensor]) -> tuple:
    """Split the fused fine-grid gradient [r, r, f_tot] feature-wise and pull
    each slice back to its table through the transpose of `upsample_to`
    (per 2x level: axis 1, then axis 0, the reverse of the upsampling)."""
    grads, off = [], 0
    for t in tables:
        g = fine[..., off : off + t.shape[-1]]
        off += t.shape[-1]
        while g.shape[0] > t.shape[0]:
            g = _down_axis0(g.transpose(0, 1)).transpose(0, 1)
            g = _down_axis0(g)
        grads.append(g.contiguous())
    return tuple(grads)


def _down_axis0_band(g: torch.Tensor) -> torch.Tensor:
    """Transpose of `_upsample2x_axis0` restricted to a band of rows.

    `g` holds the fine rows [s, s + m - 1] of a gradient, s even; the result
    is what this band gives the coarse rows [s / 2, s / 2 + m // 2]: out[c]
    = g[2c] + 0.5 * (g[2c - 1] + g[2c + 1]), with the terms outside the band
    dropped.  A neighbouring band computes them (or they lie past the edge),
    and the bands' outputs are summed, so nothing is lost.  With s = 0 and m
    odd this is the whole transpose (the column axis uses it so)."""
    m = g.shape[0]
    no = m // 2 + 1
    zero = g.new_zeros((1,) + tuple(g.shape[1:]))
    even, odd = g[0::2], g[1::2]
    if even.shape[0] < no:
        even = torch.cat([even, zero])
    up = torch.cat([zero, odd])  # g[2c - 1]
    dn = odd if odd.shape[0] == no else torch.cat([odd, zero])  # g[2c + 1]
    return even + 0.5 * (up + dn)


def sharded_pullback_unit(r_fine: int, resolutions: Sequence[int]) -> int:
    """Row granularity of the pullback's bands: a band starts on a multiple
    of 2^k_max, so every halving level keeps even starts."""
    return 2 ** max(int(round(math.log2((r_fine - 1) // (r - 1)))) for r in resolutions)


def pullback_band(loc: torch.Tensor, tables: Sequence[torch.Tensor], r_fine: int,
                  band_idx: int, n_bands: int) -> tuple:
    """Each table's share of the gradient from band `band_idx` of `n_bands`:
    `loc` holds fine rows [band_idx * band, (band_idx + 1) * band) of the
    summed fine gradient (zero rows past r_fine).  Each scale's slice is
    pulled back through its levels (columns whole, rows by band) and placed
    in a zero full-shape gradient; the bands' outputs sum to
    `_pullback_scales` of the whole fine gradient
    (`tinynerf_tpu/ops/interp.py:_sharded_pullback`)."""
    band = loc.shape[0]
    rows_pad = band * n_bands
    s0 = band_idx * band
    grads, off = [], 0
    for t in tables:
        f = t.shape[-1]
        k = int(round(math.log2((r_fine - 1) // (t.shape[0] - 1))))
        g = loc[..., off : off + f]
        off += f
        for _ in range(k):
            g = _down_axis0_band(g.transpose(0, 1)).transpose(0, 1)
            g = _down_axis0_band(g)
        start = s0 // 2**k
        full = torch.zeros(rows_pad // 2**k + (1 if k else 0), t.shape[1], f, dtype=torch.float32,
                           device=loc.device)
        full[start : start + g.shape[0]] = g
        grads.append(full[: t.shape[0]].contiguous())
    return tuple(grads)


def _sharded_pullback(gq_by_proj, tables_by_proj, r_fine: int, f_tot: int, group) -> list:
    """The fused pullback split over the ranks of `group`: each rank's
    fine gradient (of its own samples) is padded to band * N rows and
    reduce-scattered over rows, so each rank holds its band of the SUMMED
    fine gradient and pulls back only that band.  The per-rank table
    gradients are partials whose sum over ranks is the replicated gradient;
    the step's all-reduce or reduce-scatter completes them."""
    unit = sharded_pullback_unit(r_fine, [t.shape[0] for t in tables_by_proj[0]])
    band = -(-r_fine // (unit * group.world)) * unit
    out = []
    for gq, tables in zip(gq_by_proj, tables_by_proj):
        fine = _fine_from_quad(gq, r_fine, f_tot)
        fine = torch.cat([fine, fine.new_zeros(band * group.world - r_fine, r_fine, f_tot)])
        loc = group.reduce_scatter_sum(fine)
        out.extend(pullback_band(loc, tables, r_fine, group.rank, group.world))
    return out


def _fine_from_quad(gq: torch.Tensor, r_fine: int, f_tot: int) -> torch.Tensor:
    """[n_cells, 4*f_tot] corner-major quad gradient -> [r, r, f_tot]: each
    corner slice lands on its cell's corner node."""
    r = r_fine - 1
    gq4 = gq.reshape(r, r, 4 * f_tot)
    fine = torch.zeros(r_fine, r_fine, f_tot, dtype=torch.float32, device=gq.device)
    c = 0
    for dx in (0, 1):
        for dy in (0, 1):
            fine[dx : dx + r, dy : dy + r] += gq4[..., c * f_tot : (c + 1) * f_tot]
            c += 1
    return fine


def _resolve_bwd_impl(bwd_impl: str, device: torch.device, n_cells: int, n: int) -> str:
    """"auto" is the sorted-window pipeline with the bf16 payload on a CUDA
    device (the JAX package's default on its accelerator) and the scatter
    on the CPU; any sorted form falls back to the scatter when the packed
    keys do not fit 31 bits (the JAX rule, `interp.py:895-896`).  The
    scatter is the accumulation kernel's plain version, so on a CUDA device
    it is taken only by that rule, never on request."""
    impl = bwd_impl
    if impl == "auto":
        impl = "sorted_bf16" if device.type == "cuda" else "scatter"
    if impl not in ("scatter", "sorted", "sorted_bf16"):
        raise ValueError(f"unknown bwd_impl {bwd_impl!r}")
    if impl == "scatter" and device.type == "cuda":
        raise ValueError("bwd_impl='scatter' runs on CPU tensors only; on a CUDA device "
                         "the table gradient goes through the sort and accumulation kernels")
    if impl.startswith("sorted") and not packed_bits_ok(-(-n_cells // 256), n):
        impl = "scatter"
    return impl


class _MultiProj(torch.autograd.Function):
    """Forward: the per-scale lookups through quad tables.  Backward: the
    gradient of every projection's tables, taken on its finest grid
    (`_multiproj_bwd`).  Only coordinates and tables are saved."""

    @staticmethod
    def forward(ctx, gather_dtype, bwd_impl, shard_group, n_proj, n_scales, *inputs):
        coords, tables = inputs[:n_proj], inputs[n_proj:]
        ctx.save_for_backward(*inputs)
        ctx.meta = (bwd_impl, shard_group, n_proj, n_scales)
        return tuple(
            _quad_lookup_fwd_value(tables[p * n_scales + s], coords[p], gather_dtype)
            for p in range(n_proj) for s in range(n_scales)
        )

    @staticmethod
    def backward(ctx, *grads):
        bwd_impl, shard_group, n_proj, n_scales = ctx.meta
        saved = ctx.saved_tensors
        coords, tables = saved[:n_proj], saved[n_proj:]
        by_proj = [tables[p * n_scales : (p + 1) * n_scales] for p in range(n_proj)]
        r_fine = max(t.shape[0] for t in by_proj[0])
        f_tot = sum(t.shape[-1] for t in by_proj[0])
        n_cells = (r_fine - 1) * (r_fine - 1)
        n = coords[0][..., 0].numel()
        impl = _resolve_bwd_impl(bwd_impl, coords[0].device, n_cells, n)

        cells, ws, gs = [], [], []
        for p in range(n_proj):
            cell, w = _cell_2d(coords[p], r_fine, r_fine)
            cells.append(cell.reshape(n))
            ws.append(w.reshape(n, 4))
            pieces = [
                grads[p * n_scales + s] if grads[p * n_scales + s] is not None
                else torch.zeros_like(coords[p][..., :1]).expand(*coords[p].shape[:-1], t.shape[-1])
                for s, t in enumerate(by_proj[p])
            ]
            gs.append(torch.cat(pieces, dim=-1).reshape(n, f_tot).float())

        if impl.startswith("sorted"):
            gq_all = table_grad_sorted(
                torch.stack(gs), torch.stack(ws), torch.stack(cells), n_cells,
                payload_dtype=torch.bfloat16 if impl == "sorted_bf16" else torch.float32,
            )
            gq_by_proj = [gq_all[p] for p in range(n_proj)]
        else:
            # one scatter per projection, corner-major rows [c0(f_tot), .., c3]
            gq_by_proj = [
                torch.zeros(n_cells, 4 * f_tot, dtype=torch.float32, device=gs[p].device)
                .index_add_(0, cells[p], (ws[p][:, :, None] * gs[p][:, None, :]).reshape(n, 4 * f_tot))
                for p in range(n_proj)
            ]
        if shard_group is not None:
            table_grads = _sharded_pullback(gq_by_proj, by_proj, r_fine, f_tot, shard_group)
        else:
            table_grads = []
            for p in range(n_proj):
                fine = _fine_from_quad(gq_by_proj[p], r_fine, f_tot)
                table_grads.extend(_pullback_scales(fine, by_proj[p]))
        return (None,) * 5 + (None,) * n_proj + tuple(table_grads)


def multiscale_lookup_multiproj(
    tables_by_proj: Sequence[Sequence[torch.Tensor]],
    coords_by_proj: Sequence[torch.Tensor],
    gather_dtype: torch.dtype = torch.bfloat16,
    bwd_impl: str = "auto",
    shard_group=None,
) -> Tuple[Tuple[torch.Tensor, ...], ...]:
    """Per-projection multiscale bilinear lookups with one shared backward.

    tables_by_proj: per projection, its planes [r_s, r_s, F] whose (r - 1)
    nest by powers of two; coords_by_proj: per projection [..., 2] in
    [-1, 1].  Returns, per projection, the per-scale lookups [..., F] as a
    tuple (the JAX op returns their feature concat; the pieces go straight
    into the K-Planes product without that copy).

    The backward follows `tinynerf_tpu/ops/interp.py:_multiproj_bwd`: the
    cell and corner weights of every sample on the finest grid, the
    corner-packed fine-cell gradient by the sorted-window pipeline
    (`ops/table_grad.py`, all projections in one sort and one accumulation)
    or by one scatter per projection (`bwd_impl`: "auto", "sorted",
    "sorted_bf16" or "scatter"), then the fine table and each scale's table
    through the upsampling transpose.  Coordinates get no gradient (sample
    positions come from the no-grad march).

    `shard_group` (a `parallel.DataGroup`, the JAX `shard_axis`): every
    rank of the group calls the backward together, and the pullback is
    split over them by row bands (`_sharded_pullback`); the table gradients
    are then per-rank partials that sum over ranks to the full ones."""
    n_proj, n_scales = len(tables_by_proj), len(tables_by_proj[0])
    flat = [t for ts in tables_by_proj for t in ts]
    out = _MultiProj.apply(gather_dtype, bwd_impl, shard_group, n_proj, n_scales, *coords_by_proj, *flat)
    return tuple(tuple(out[p * n_scales : (p + 1) * n_scales]) for p in range(n_proj))


# --------------------------------------------------------------------------
# Trilinear lookups on 3-D grids (Cobafa).
# --------------------------------------------------------------------------


def _cell_3d(coords: torch.Tensor, r0: int, r1: int, r2: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cell [...] row of the (r0-1)(r1-1)(r2-1) cell grid, weights [..., 8]
    in `CORNERS_3D` order).  Origins are clipped to [0, r-2], so at coord +1
    the last cell interpolates with t == 1."""
    x = _to_index_space(coords[..., 0], r0)
    y = _to_index_space(coords[..., 1], r1)
    z = _to_index_space(coords[..., 2], r2)
    x0 = torch.clamp(torch.floor(x), 0, r0 - 2).to(torch.int32)
    y0 = torch.clamp(torch.floor(y), 0, r1 - 2).to(torch.int32)
    z0 = torch.clamp(torch.floor(z), 0, r2 - 2).to(torch.int32)
    tx, ty, tz = x - x0, y - y0, z - z0
    cell = (x0.long() * (r1 - 1) + y0) * (r2 - 1) + z0
    wx, wy, wz = (1 - tx, tx), (1 - ty, ty), (1 - tz, tz)
    w = torch.stack([wx[dx] * wy[dy] * wz[dz] for dx, dy, dz in CORNERS_3D], dim=-1)
    return cell, w


def oct_table_grad(g: torch.Tensor, w: torch.Tensor, cell: torch.Tensor, n_cells: int) -> torch.Tensor:
    """The corner-packed cell gradient of an oct lookup: [n_cells, 8F] f32,
    row c the sum over the samples in cell c of concat_k(w[i, k] * g[i]).
    g [n, F], w [n, 8] f32, cell [n].  The scatter of
    `tinynerf_tpu/ops/interp.py:_trilinear_oct_bwd` taken as K-Planes takes
    its own: the samples sorted by window of cells (`table_grad_sorted`: the
    radix sort, by key and value where the windows and samples pass 32 bits),
    then each window summed in a fixed order by the accumulation kernel, in
    f32 rows padded to 16 bytes; on the CPU their plain versions."""
    n, f = g.shape
    w_window = default_window(g.device, n_cells, n, 8 * f, packed_keys=False)
    return table_grad_sorted(g.float()[None], w[None], cell.reshape(1, n), n_cells, w_window,
                             payload_dtype=torch.float32, row_align=4)[0]


def oct_grad_to_grid(gq: torch.Tensor, shape) -> torch.Tensor:
    """The corner-packed cell gradient [cells, 8F] back onto the grid
    `shape` [r0, r1, r2, F]: its eight corner slices added at their shifts,
    in `CORNERS_3D` order."""
    r0, r1, r2, f = shape
    m = (r0 - 1, r1 - 1, r2 - 1)
    gq = gq.reshape(*m, 8 * f)
    grad = torch.zeros(r0, r1, r2, f, dtype=torch.float32, device=gq.device)
    for c, (dx, dy, dz) in enumerate(CORNERS_3D):
        grad[dx : dx + m[0], dy : dy + m[1], dz : dz + m[2]] += gq[..., c * f : (c + 1) * f]
    return grad


class _TrilinearOct(torch.autograd.Function):
    """Forward: the oct table (`build_oct`), one row gather per sample, the
    f32 lerp.  Backward: `tinynerf_tpu/ops/interp.py:_trilinear_oct_bwd`,
    the corner-packed cell gradient (`oct_table_grad`: sorted by window,
    summed in a fixed order), then its eight corner slices added back onto
    the grid.  Only the coordinates are saved: the cell and weights are
    recomputed, and no oct table is kept alive across the backward."""

    @staticmethod
    def forward(ctx, table, coords, gather_dtype):
        r0, r1, r2, f = table.shape
        oct_t = build_oct(table, gather_dtype)
        cell, w = _cell_3d(coords, r0, r1, r2)
        rows = oct_t[cell.reshape(-1)].float().reshape(*cell.shape, 8, f)
        del oct_t
        ctx.save_for_backward(coords)
        ctx.table_shape = (r0, r1, r2, f)
        return torch.sum(rows * w[..., None], dim=-2)

    @staticmethod
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        r0, r1, r2, f = ctx.table_shape
        cell, w = _cell_3d(coords, r0, r1, r2)
        n = cell.numel()
        m = (r0 - 1, r1 - 1, r2 - 1)
        gq = oct_table_grad(g.reshape(n, f), w.reshape(n, 8), cell.reshape(n), m[0] * m[1] * m[2])
        return oct_grad_to_grid(gq, (r0, r1, r2, f)), None, None


def trilinear_lookup_oct(
    table: torch.Tensor, coords: torch.Tensor, gather_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Trilinear lookup of `table` [r0, r1, r2, F] at coords [..., 3] in
    [-1, 1] -> f32 [..., F], corners rounded to `gather_dtype` (the oct
    table's type).  Gradients flow to the table only (sample positions come
    from the no-grad march)."""
    return _TrilinearOct.apply(table, coords, gather_dtype)


def trilinear_lookup(table: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Plain trilinear lookup of `table` [r0, r1, r2, F] at coords [..., 3]
    in [-1, 1] -> f32 [..., F] (`tinynerf_tpu/ops/interp.py:trilinear_lookup`,
    the occupancy grid's trilinear query): the eight corners of the floor
    cell, each upper corner clamped to the table, weighted and summed in
    `CORNERS_3D` order."""
    r0, r1, r2, f = table.shape
    x = _to_index_space(coords[..., 0], r0)
    y = _to_index_space(coords[..., 1], r1)
    z = _to_index_space(coords[..., 2], r2)
    x0, y0, z0 = (torch.floor(v).long() for v in (x, y, z))
    lo = (x0, y0, z0)
    hi = (torch.clamp(x0 + 1, max=r0 - 1), torch.clamp(y0 + 1, max=r1 - 1), torch.clamp(z0 + 1, max=r2 - 1))
    t = (x - x0, y - y0, z - z0)
    flat = table.reshape(r0 * r1 * r2, f)
    idx = torch.stack([((lo, hi)[dx][0] * r1 + (lo, hi)[dy][1]) * r2 + (lo, hi)[dz][2]
                       for dx, dy, dz in CORNERS_3D], dim=-1)
    w = torch.stack([(1 - t[0], t[0])[dx] * (1 - t[1], t[1])[dy] * (1 - t[2], t[2])[dz]
                     for dx, dy, dz in CORNERS_3D], dim=-1)
    vals = flat[idx].float()  # [..., 8, F]
    return torch.sum(vals * w[..., None], dim=-2)


def sawtooth(x: torch.Tensor, f: float) -> torch.Tensor:
    """Periodic tiling encoding 2 * ((f x) mod 1) - 1 in [-1, 1): floor mod
    (`torch.remainder`, as `jnp.mod`), so negative inputs wrap upward."""
    return 2.0 * torch.remainder(f * x, 1.0) - 1.0
