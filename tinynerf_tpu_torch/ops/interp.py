"""Bilinear plane lookups for K-Planes and trilinear grid lookups for
Cobafa, and their table gradients.

Counterpart of `tinynerf_tpu/ops/interp.py`: `_to_index_space`, the corner
form (`_corners_2d`, `_corners_3d`, `_weighted_gather`) and the cell form
(`_cell_2d`, `_cell_3d`) of the interpolation; every lookup layout the
fields take:

  * `bilinear_lookup` / `trilinear_lookup`: f32 corner gathers, the JAX
    plain autodiff lookups (`lookup_mode="plain"`; the trilinear one is also
    the occupancy grid's trilinear query);
  * `bilinear_lookup_mixed` / `trilinear_lookup_mixed`: the corner gathers
    from the table rounded to `gather_dtype` (`lookup_mode="mixed"`);
  * `bilinear_lookup_quad`: one 4F row per sample from the plane's quad
    table (`build_quad`, kernel 7 on the card; K-Planes `lookup_mode="quad"`)
    and `trilinear_lookup_oct`, one 8F row from the grid's oct table
    (`build_oct`; Cobafa's default);
  * `multiscale_lookup_multiproj` (every scale of every projection under one
    autograd Function; K-Planes' default `lookup_mode="fused"`) and
    `bilinear_lookup_multiscale` (one projection), with the per-scale
    forward or the fused fine table's (`fwd_impl`), the exact 2x upsampling
    of nested grids and its transpose, and the pullback split over the
    ranks of a data-parallel group (`_sharded_pullback`, the JAX
    `shard_axis`);

and `sawtooth`.  Tables are feature-last (`[r0, r1, F]`, `[r0, r1, r2,
F]`); coordinates are in [-1, 1] with align_corners=True semantics (-1 ->
index 0, +1 -> index r-1).  Every lerp is f32.

Every table gradient takes the cell route, whatever the forward's layout:
the corner-packed cell gradient summed in a fixed order (`table_grad`'s
window sort and accumulation, kernels 4 and 5 on the card; Cobafa's oct
rows through `oct_table_grad`), then folded onto the table (the 2D
pad-adds, `oct_fold`).  Where the JAX package scatters corner rows
(`_bilinear_mixed_bwd`, autodiff of the plain lookups), that is the same
sum in another f32 order: a corner-clamped sample at coord +1 puts its
weight on the same rows as the cell form, and the cell form's other rows
get an exact zero.  Coordinates get no gradient: sample positions come
from the no-grad march (JAX's plain autodiff would give them one).  Only
coordinates and tables are saved for a backward, so no packed table stays
alive into it.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from . import table_grad
from .bitonic import packed_bits_ok
from .octbuild import CORNERS_3D, _cast, build_oct, build_quad, oct_fold
from .table_grad import default_window, table_grad_sorted
from ..utils.trace import span


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


def _corners_2d(coords: torch.Tensor, r0: int, r1: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The corner form of bilinear interpolation: (idx [..., 4] flat rows of
    the table, w [..., 4]) over corners 00, 01, 10, 11 of the floor cell,
    each upper corner clamped to the table (at coord +1 both corners of an
    axis are its last row, and t = 0)."""
    x = _to_index_space(coords[..., 0], r0)
    y = _to_index_space(coords[..., 1], r1)
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    x1 = torch.clamp(x0 + 1, max=r0 - 1)
    y1 = torch.clamp(y0 + 1, max=r1 - 1)
    tx = x - x0
    ty = y - y0
    x0, y0, x1, y1 = x0.long(), y0.long(), x1.long(), y1.long()
    idx = torch.stack([x0 * r1 + y0, x0 * r1 + y1, x1 * r1 + y0, x1 * r1 + y1], dim=-1)
    w = torch.stack([(1 - tx) * (1 - ty), (1 - tx) * ty, tx * (1 - ty), tx * ty], dim=-1)
    return idx, w


def _corners_3d(coords: torch.Tensor, r0: int, r1: int, r2: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The corner form of trilinear interpolation: (idx [..., 8], w [..., 8])
    in `CORNERS_3D` order, upper corners clamped to the table."""
    res = (r0, r1, r2)
    v = [_to_index_space(coords[..., a], res[a]) for a in range(3)]
    lo = [torch.floor(v[a]).to(torch.int32) for a in range(3)]
    hi = [torch.clamp(lo[a] + 1, max=res[a] - 1).long() for a in range(3)]
    t = [v[a] - lo[a] for a in range(3)]
    lo = [c.long() for c in lo]
    corner = lambda d, a: (lo, hi)[d][a]
    idx = torch.stack([(corner(dx, 0) * r1 + corner(dy, 1)) * r2 + corner(dz, 2) for dx, dy, dz in CORNERS_3D],
                      dim=-1)
    wt = [(1 - t[a], t[a]) for a in range(3)]
    w = torch.stack([wt[0][dx] * wt[1][dy] * wt[2][dz] for dx, dy, dz in CORNERS_3D], dim=-1)
    return idx, w


def _weighted_gather(flat_table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                     gather_dtype=None) -> torch.Tensor:
    """Corner rows of `flat_table` [M, F] (rounded to `gather_dtype` first,
    if given) at idx [..., C], widened to f32 and summed with the weights w
    [..., C] over the corners -> [..., F] f32."""
    t = flat_table if gather_dtype is None else _cast(flat_table, gather_dtype)
    vals = t[idx].float()  # [..., C, F]
    return torch.sum(vals * w[..., None], dim=-2)


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


def _upsample2x_axis0(x: torch.Tensor, round_fn=None) -> torch.Tensor:
    """[r, ...] -> [2r-1, ...]: nodes kept, midpoints 0.5 * (left + right),
    each rounded by `round_fn` if given."""
    out = x.new_empty((2 * x.shape[0] - 1,) + tuple(x.shape[1:]))
    out[0::2] = x
    mid = 0.5 * (x[:-1] + x[1:])
    out[1::2] = mid if round_fn is None else round_fn(mid)
    return out


def upsample2x_exact(table: torch.Tensor, round_fn=None) -> torch.Tensor:
    """[r0, r1, F] -> [2*r0-1, 2*r1-1, F], exact for bilinear interpolation
    (up to `round_fn`'s rounding of the midpoints)."""
    t = _upsample2x_axis0(table, round_fn)
    return _upsample2x_axis0(t.transpose(0, 1), round_fn).transpose(0, 1)


def upsample_to(table: torch.Tensor, r0: int, r1: int, round_fn=None) -> torch.Tensor:
    """Repeated exact 2x upsampling up to (r0, r1); the resolutions must nest
    ((target-1) = 2^k * (source-1))."""
    while table.shape[0] < r0 or table.shape[1] < r1:
        table = upsample2x_exact(table, round_fn)
    if tuple(table.shape[:2]) != (r0, r1):
        raise ValueError(f"resolutions do not nest: got {tuple(table.shape[:2])}, want {(r0, r1)}")
    return table


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> its nearest-even bf16 value, as f32, a NaN keeping its sign and
    top payload bits (XLA's conversion; torch's own cast gives every NaN the
    positive canonical bits)."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + (0x7FFF + ((bits >> 16) & 1))) & ~0xFFFF
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    return torch.where(nan, (bits | 0x400000) & ~0xFFFF, rounded).view(torch.float32)


def _float8_to_f32(t: torch.Tensor) -> torch.Tensor:
    """float8_e4m3fn -> f32, exact; a NaN as sign | 0x7FC00000, the bits
    JAX's conversion gives it."""
    f = t.float()
    bits = f.view(torch.int32)
    return torch.where(torch.isnan(f), (bits & -(2**31)) | 0x7FC00000, bits).view(torch.float32)


def fused_fine_table(tables: Sequence[torch.Tensor], gather_dtype=torch.bfloat16) -> torch.Tensor:
    """The fused fine table of `fwd_impl="fusedfine"`, as the JAX package
    builds it (`tinynerf_tpu/ops/interp.py:_multiscale_value`): each scale
    rounded to `gather_dtype`, held in bf16 (f32 at f32: a float8 value is
    exact in bf16), upsampled to the finest resolution in that type (each
    midpoint 0.5 * (a + b), its f32 value rounded to the hold type, once
    per level, as bf16 arithmetic rounds it) and concatenated feature-wise
    -> [r_fine, r_fine, f_tot] f32 holding the hold type's values bit for
    bit, NaN signs included (a float8 NaN, |x| > 464).  Nodes keep the
    per-scale path's values; midpoints round once more."""
    r_fine = max(t.shape[0] for t in tables)
    if gather_dtype == torch.float32:
        cast, round_fn = [t.float() for t in tables], None
    elif gather_dtype == torch.float8_e4m3fn:
        cast, round_fn = [_float8_to_f32(_cast(t, gather_dtype)) for t in tables], _bf16_round
    else:
        cast, round_fn = [_bf16_round(t.float()) for t in tables], _bf16_round
    return torch.cat([upsample_to(t, r_fine, r_fine, round_fn) for t in cast], dim=-1)


def _fused_fine_pieces(tables: Sequence[torch.Tensor], coords: torch.Tensor, gather_dtype) -> tuple:
    """The fused-fine forward of one projection: one quad table of the fused
    fine table (`build_quad`, kernel 7 on the card, rounds its f32 values
    to `gather_dtype`), one [4 f_tot] row gathered per
    sample, the four corners weighted and added in corner order (JAX's lane
    slices).  Returns the per-scale pieces [..., F_s] f32, each reduced
    from its own columns of the row (the same f32 operations, element by
    element, as reducing the whole row and slicing it)."""
    fine = fused_fine_table(tables, gather_dtype)
    r_fine, f_tot = fine.shape[0], fine.shape[-1]
    quad = build_quad(fine, gather_dtype)
    del fine
    cell, w = _cell_2d(coords, r_fine, r_fine)
    rows = quad.index_select(0, cell.reshape(-1))
    del quad
    rows = rows.reshape(*cell.shape, 4 * f_tot)
    pieces, off = [], 0
    for t in tables:
        f = t.shape[-1]
        out = None
        for c in range(4):
            term = rows[..., c * f_tot + off : c * f_tot + off + f].float() * w[..., c : c + 1]
            out = term if out is None else out + term
        pieces.append(out)
        off += f
    return tuple(pieces)


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


def _quad_fold(gq: torch.Tensor, r0: int, r1: int, f: int) -> torch.Tensor:
    """[(r0-1)(r1-1), 4F] corner-major cell gradient -> [r0, r1, F]: each
    corner slice lands on its cell's corner node, added in corner order from
    0 (the pad-adds of `tinynerf_tpu/ops/interp.py:_bilinear_quad_bwd`)."""
    m0, m1 = r0 - 1, r1 - 1
    gq4 = gq.reshape(m0, m1, 4 * f)
    out = torch.zeros(r0, r1, f, dtype=torch.float32, device=gq.device)
    c = 0
    for dx in (0, 1):
        for dy in (0, 1):
            out[dx : dx + m0, dy : dy + m1] += gq4[..., c * f : (c + 1) * f]
            c += 1
    return out


def _fine_from_quad(gq: torch.Tensor, r_fine: int, f_tot: int) -> torch.Tensor:
    """[n_cells, 4*f_tot] corner-major quad gradient -> [r, r, f_tot]."""
    return _quad_fold(gq, r_fine, r_fine, f_tot)


def _resolve_bwd_impl(bwd_impl: str, device: torch.device, n_cells: int, n: int) -> str:
    """How the fused lookup's table gradient is summed.  "auto" is the
    sorted-window pipeline with the bf16 payload on a CUDA device (the JAX
    package's default on its accelerator) and the scatter on the CPU.

    On a CUDA device nothing falls back and nothing reaches `index_add_`:
    the sorted forms take the key-value sort where the packed keys do not
    fit (`table_grad_sorted`), and "scatter", the JAX package's f32 scatter
    values, is the f32 payload's pipeline ("sorted"): the same f32 sums in a
    fixed order.  The CPU keeps the JAX rule: a sorted form falls back to
    the scatter (`index_add_`) when the packed keys of windows of 256 cells
    do not fit 31 bits (`tinynerf_tpu/ops/interp.py:895-896`)."""
    impl = bwd_impl
    if impl == "auto":
        impl = "sorted_bf16" if device.type == "cuda" else "scatter"
    if impl not in ("scatter", "sorted", "sorted_bf16"):
        raise ValueError(f"unknown bwd_impl {bwd_impl!r}")
    if device.type == "cuda":
        return "sorted" if impl == "scatter" else impl
    if impl.startswith("sorted") and not packed_bits_ok(-(-n_cells // 256), n):
        impl = "scatter"
    return impl


FWD_IMPLS = ("perscale", "fusedfine")


class _MultiProj(torch.autograd.Function):
    """Forward: the per-scale lookups through quad tables, or, with
    `fwd_impl="fusedfine"`, one gather per projection from its fused fine
    table.  Backward (the same for both): the gradient of every
    projection's tables, taken on its finest grid (`_multiproj_bwd`).  Only
    coordinates and tables are saved."""

    @staticmethod
    def forward(ctx, gather_dtype, bwd_impl, fwd_impl, shard_group, n_proj, n_scales, *inputs):
        coords, tables = inputs[:n_proj], inputs[n_proj:]
        ctx.save_for_backward(*inputs)
        ctx.meta = (bwd_impl, shard_group, n_proj, n_scales)
        if fwd_impl == "fusedfine":
            return tuple(piece for p in range(n_proj) for piece in
                         _fused_fine_pieces(tables[p * n_scales : (p + 1) * n_scales], coords[p], gather_dtype))
        if fwd_impl != "perscale":
            raise ValueError(f"unknown fwd_impl {fwd_impl!r}; expected one of {FWD_IMPLS}")
        return tuple(
            _quad_lookup_fwd_value(tables[p * n_scales + s], coords[p], gather_dtype)
            for p in range(n_proj) for s in range(n_scales)
        )

    @staticmethod
    def backward(ctx, *grads):
        with span("field.table_grad"):
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
                # the CPU's scatter (never on a CUDA device: `_resolve_bwd_impl`),
                # one per projection, corner-major rows [c0(f_tot), .., c3]
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
            return (None,) * 6 + (None,) * n_proj + tuple(table_grads)


def multiscale_lookup_multiproj(
    tables_by_proj: Sequence[Sequence[torch.Tensor]],
    coords_by_proj: Sequence[torch.Tensor],
    gather_dtype: torch.dtype = torch.bfloat16,
    bwd_impl: str = "auto",
    shard_group=None,
    fwd_impl: str = "perscale",
) -> Tuple[Tuple[torch.Tensor, ...], ...]:
    """Per-projection multiscale bilinear lookups with one shared backward.

    tables_by_proj: per projection, its planes [r_s, r_s, F] whose (r - 1)
    nest by powers of two; coords_by_proj: per projection [..., 2] in
    [-1, 1].  Returns, per projection, the per-scale lookups [..., F] as a
    tuple (the JAX op returns their feature concat; the pieces go straight
    into the K-Planes product without that copy).

    `fwd_impl` (the JAX op's): "perscale", one quad table and one 4F row
    gather per scale, or "fusedfine", one gather of a [4 f_tot] row per
    sample from the projection's fused fine table (`fused_fine_table`: the
    upsampled midpoints round to `gather_dtype` once more than "perscale").

    The backward follows `tinynerf_tpu/ops/interp.py:_multiproj_bwd` for
    either forward: the cell and corner weights of every sample on the
    finest grid, the corner-packed fine-cell gradient by the sorted-window
    pipeline (`ops/table_grad.py`, all projections in one sort and one
    accumulation) or, on the CPU, by one scatter per projection (`bwd_impl`:
    "auto", "sorted", "sorted_bf16" or "scatter"; `_resolve_bwd_impl`),
    then the fine table and each scale's table through the upsampling
    transpose.  Coordinates get no gradient (sample positions come from the
    no-grad march).

    `shard_group` (a `parallel.DataGroup`, the JAX `shard_axis`): every
    rank of the group calls the backward together, and the pullback is
    split over them by row bands (`_sharded_pullback`); the table gradients
    are then per-rank partials that sum over ranks to the full ones."""
    n_proj, n_scales = len(tables_by_proj), len(tables_by_proj[0])
    flat = [t for ts in tables_by_proj for t in ts]
    out = _MultiProj.apply(gather_dtype, bwd_impl, fwd_impl, shard_group, n_proj, n_scales, *coords_by_proj, *flat)
    return tuple(tuple(out[p * n_scales : (p + 1) * n_scales]) for p in range(n_proj))


def bilinear_lookup_multiscale(
    tables: Sequence[torch.Tensor], coords: torch.Tensor, gather_dtype: torch.dtype = torch.bfloat16,
    bwd_impl: str = "auto", fwd_impl: str = "perscale",
) -> torch.Tensor:
    """The single-projection op (`tinynerf_tpu/ops/interp.py:
    bilinear_lookup_multiscale`): planes [r_s, r_s, F] of one projection at
    coords [..., 2] -> the feature concat of the per-scale lookups [...,
    n_scales * F], `multiscale_lookup_multiproj` over that one projection."""
    pieces = multiscale_lookup_multiproj([tables], [coords], gather_dtype, bwd_impl, fwd_impl=fwd_impl)[0]
    return torch.cat(pieces, dim=-1)


# --------------------------------------------------------------------------
# Single-table lookups with the cell-route backward: the quad layout, and
# the corner form (mixed and plain) in 2D and 3D.
# --------------------------------------------------------------------------


def _cell_route_grad(g: torch.Tensor, coords: torch.Tensor, shape: tuple) -> torch.Tensor:
    """The table gradient [*shape] f32 of a bilinear ([r0, r1, F]) or
    trilinear ([r0, r1, r2, F]) lookup at coords for the cotangent g [...,
    F]: the corner-packed cell gradient summed in a fixed order, then folded
    onto the table.  2D: `table_grad_sorted` (one item of 4 corners a
    sample, the f32 payload) and the pad-adds; 3D: `oct_table_grad` and
    `oct_fold` (Cobafa's oct backward)."""
    f = shape[-1]
    if len(shape) == 3:
        r0, r1 = shape[:2]
        cell, w = _cell_2d(coords, r0, r1)
        n = cell.numel()
        gq = table_grad_sorted(g.reshape(1, n, f).float(), w.reshape(1, n, 4), cell.reshape(1, n),
                               (r0 - 1) * (r1 - 1), payload_dtype=torch.float32)[0]
        return _quad_fold(gq, r0, r1, f)
    r0, r1, r2 = shape[:3]
    cell, w = _cell_3d(coords, r0, r1, r2)
    n = cell.numel()
    gq = oct_table_grad(g.reshape(n, f).float().contiguous(), w.reshape(n, 8), cell.reshape(n),
                        (r0 - 1) * (r1 - 1) * (r2 - 1))
    return oct_fold(gq, shape)


class _QuadLookup(torch.autograd.Function):
    """`tinynerf_tpu/ops/interp.py:bilinear_lookup_quad`.  Forward: the
    plane's quad table (`build_quad`), one 4F row per sample, the f32 lerp.
    Backward: `_cell_route_grad`."""

    @staticmethod
    def forward(ctx, table, coords, gather_dtype):
        ctx.save_for_backward(coords)
        ctx.table_shape = tuple(table.shape)
        return _quad_lookup_fwd_value(table, coords, gather_dtype)

    @staticmethod
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        with span("field.table_grad"):
            return _cell_route_grad(g, coords, ctx.table_shape), None, None


def bilinear_lookup_quad(table: torch.Tensor, coords: torch.Tensor,
                         gather_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Bilinear lookup of `table` [r0, r1, F] at coords [..., 2] through the
    cell-packed layout: the quad table of `gather_dtype` (bf16, f32 or
    float8_e4m3fn), one 4F row a sample -> f32 [..., F]."""
    return _QuadLookup.apply(table, coords, gather_dtype)


class _CornerLookup(torch.autograd.Function):
    """The corner form of `tinynerf_tpu/ops/interp.py`'s plain and mixed
    lookups in 2D and 3D.  Forward: the corner rows of the table (rounded to
    `gather_dtype`, or f32 for None), the f32 lerp.  Backward:
    `_cell_route_grad`, its f32 sums rounded once to bf16 where
    `scatter_dtype` is bf16."""

    @staticmethod
    def forward(ctx, table, coords, gather_dtype, scatter_dtype):
        shape = tuple(table.shape)
        corners = _corners_2d if len(shape) == 3 else _corners_3d
        idx, w = corners(coords, *shape[:-1])
        ctx.save_for_backward(coords)
        ctx.meta = (shape, scatter_dtype)
        return _weighted_gather(table.reshape(-1, shape[-1]), idx, w, gather_dtype)

    @staticmethod
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        shape, scatter_dtype = ctx.meta
        with span("field.table_grad"):
            grad = _cell_route_grad(g, coords, shape)
            if scatter_dtype == torch.bfloat16:
                grad = grad.to(torch.bfloat16).float()
            return grad, None, None, None


SCATTER_DTYPES = (torch.float32, torch.bfloat16)


def _corner_lookup(table, coords, gather_dtype, scatter_dtype, n_axes: int) -> torch.Tensor:
    if table.dim() != n_axes + 1 or coords.shape[-1] != n_axes:
        raise ValueError(f"expected a table of {n_axes} axes and features and coords [..., {n_axes}], got "
                         f"{tuple(table.shape)} and {tuple(coords.shape)}")
    if scatter_dtype not in SCATTER_DTYPES:
        raise ValueError(f"scatter_dtype must be one of {SCATTER_DTYPES}, got {scatter_dtype}")
    return _CornerLookup.apply(table, coords, gather_dtype, scatter_dtype)


def bilinear_lookup(table: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Plain bilinear lookup of `table` [r0, r1, F] at coords [..., 2] ->
    f32 [..., F] (`tinynerf_tpu/ops/interp.py:bilinear_lookup`): f32 corner
    gathers, the four corners weighted and summed in corner order."""
    return _corner_lookup(table, coords, None, torch.float32, 2)


def bilinear_lookup_mixed(table: torch.Tensor, coords: torch.Tensor, gather_dtype=torch.bfloat16,
                          scatter_dtype=torch.float32) -> torch.Tensor:
    """`tinynerf_tpu/ops/interp.py:bilinear_lookup_mixed`: the corner rows
    gathered from the table rounded to `gather_dtype` (bf16, f32 or
    float8_e4m3fn by JAX's rule), lerped in f32.  The table gradient sums in
    f32 in a fixed order; with `scatter_dtype` bf16 it is rounded to bf16
    once at the end, where JAX adds each term in bf16 in XLA's order (a
    difference of up to ~2^-8 of the largest value; ROADMAP.md Queue 3)."""
    return _corner_lookup(table, coords, gather_dtype, scatter_dtype, 2)


def trilinear_lookup_mixed(table: torch.Tensor, coords: torch.Tensor, gather_dtype=torch.bfloat16,
                           scatter_dtype=torch.float32) -> torch.Tensor:
    """`tinynerf_tpu/ops/interp.py:trilinear_lookup_mixed`, the 3D form of
    `bilinear_lookup_mixed` on [r0, r1, r2, F] at coords [..., 3]; its
    backward is Cobafa's oct gradient (F <= 8 on a CUDA device)."""
    return _corner_lookup(table, coords, gather_dtype, scatter_dtype, 3)


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
    `tinynerf_tpu/ops/interp.py:_trilinear_oct_bwd` in a fixed order: the
    samples sorted by window of cells (`table_grad.sort_windows`: the radix
    sort, by key and value where the windows and samples pass 32 bits), then
    each cell's samples summed in that order by `table_grad.oct_accumulate`,
    which reads the rows through the permutation; on the CPU their plain
    versions."""
    n, f = g.shape
    w_window = default_window(g.device, 8 * f, oct_rows=True)
    n_cells_pad = -(-n_cells // w_window) * w_window
    cell = cell.to(torch.int32).reshape(1, n)
    perm, offsets = table_grad.sort_windows(cell, n_cells_pad, w_window)
    gq = table_grad.oct_accumulate(g.float().contiguous(), w.contiguous(), cell[0], perm[0], offsets[0],
                                   n_cells_pad, w_window)
    return gq[:n_cells]


class _TrilinearOct(torch.autograd.Function):
    """Forward: the oct table (`build_oct`), one row gather per sample, the
    f32 lerp.  Backward: `tinynerf_tpu/ops/interp.py:_trilinear_oct_bwd`,
    the corner-packed cell gradient (`oct_table_grad`: sorted by window,
    summed in a fixed order), then folded back onto the grid (`oct_fold`,
    the eight corner slices added in order, one launch on the card).  Only
    the coordinates are saved: the cell and weights are recomputed, and no
    oct table is kept alive across the backward."""

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
        with span("field.table_grad"):
            cell, w = _cell_3d(coords, r0, r1, r2)
            n = cell.numel()
            m = (r0 - 1, r1 - 1, r2 - 1)
            gq = oct_table_grad(g.reshape(n, f), w.reshape(n, 8), cell.reshape(n), m[0] * m[1] * m[2])
            return oct_fold(gq, (r0, r1, r2, f)), None, None


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
    in [-1, 1] -> f32 [..., F] (`tinynerf_tpu/ops/interp.py:trilinear_lookup`:
    Cobafa's `lookup_mode="plain"`, and the occupancy grid's trilinear
    query): the eight corners of the floor cell, each upper corner clamped
    to the table, weighted and summed in `CORNERS_3D` order; its backward
    is Cobafa's oct gradient (F <= 8 on a CUDA device)."""
    return _corner_lookup(table, coords, None, torch.float32, 3)


def sawtooth(x: torch.Tensor, f: float) -> torch.Tensor:
    """Periodic tiling encoding 2 * ((f x) mod 1) - 1 in [-1, 1): floor mod
    (`torch.remainder`, as `jnp.mod`), so negative inputs wrap upward."""
    return 2.0 * torch.remainder(f * x, 1.0) - 1.0
