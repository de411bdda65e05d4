"""Sorted-window table-gradient accumulation.

Counterpart of `tinynerf_tpu/ops/table_grad.py`.  The backward of a
cell-packed bilinear lookup is a scatter-add of per-sample rows
concat_c(w[i, c] * g[i, :]) into the rows cell[i] of a [n_cells, nc * F]
table.  The samples are first grouped by table WINDOW (W consecutive cells)
with the radix sort of `ops/bitonic.py`, then each window is accumulated
by `windowed_accumulate`: on CUDA tensors the hand-written kernel of
`csrc/table_grad.cu` (a window's samples staged in shared memory once by
bulk asynchronous copies; each cell's sums kept in one warp's registers,
or, for shapes too large for that, a window's tile in shared memory with
f32 atomics; a window split over several work items summed in item order,
so that the register kernel's sums repeat themselves bit for bit), on CPU
tensors its plain version, decode + `index_add_`.  On a CUDA device the
pipeline sorts by windows of 64 cells where the JAX package takes 256
(`default_window`).  Where a window id and a sample index do not fit one
int32 together, the sort carries the index as a value
(`sort_by_window_pairs`).

One packed payload row per sample, so the sorted stream costs one
permutation gather, in either of the JAX package's encodings (keyed on the
payload dtype):

  f32  - [g(F) | w(nc) | cell | pad] f32, rows padded to a multiple of 128;
  bf16 - [g(F) | w_hi(nc) | w_lo(nc) | cell % W | pad] bf16: half the bytes;
         the weights ride as an exact-ish (hi, lo) pair, the cell as its
         offset inside the window (< 256, exact in bf16), and only g is
         rounded to bf16 (~2^-8 relative).

The JAX layout pads rows to 128 values (a TPU's lanes); the kernel needs
only rows of a multiple of 16 bytes (`pack_payload`'s `row_align`).

Cobafa's oct rows (8 corners x F <= 8, the scatter of the JAX package's
`_trilinear_oct_bwd`) take no payload: `oct_accumulate` reads row perm[j]
of g, w and cell itself (`csrc/table_grad.cu` `tn_oct_accumulate`, windows
of OCT_WINDOW cells, the same work list, slots and ordered combine), on CPU
tensors its plain version, a gather through the permutation and
`index_add_` in row order.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .bitonic import _bits, pack_keys, sort_i32, sort_pairs_i32, unpack_keys


# samples of one window walked by one work item of the accumulation kernel
ACCUM_CHUNK = 1024
# the shapes of one of its blocks, smallest first: (bytes of the f32 tile of a
# window's cells x corners, stages of the staging ring, bytes per stage,
# threads).  A tile of up to 96 KB leaves an SM room for two blocks, so one
# writes its tile out while the other accumulates; a larger tile has the SM
# to itself; a window that does not fit the largest is split over blocks
ACCUM_SHAPES = ((96 * 1024, 2, 8192, 544), (192 * 1024, 2, 16384, 1024))
# windows of up to OWNER_WINDOW cells x up to 4 corners x up to 96 values,
# or x up to 8 corners of up to 64 values in all (payload rows; Cobafa's
# oct rows take `oct_accumulate`), go
# to the kernel that keeps every cell's sums in one warp's registers: the
# rows per stage of its ring (32, 64 or 128) and the ring's bytes (as many
# stages as fit, at most 8); 0 bytes would send them to the tile kernel too
ACCUM_OWNER_STAGE_ROWS = 128
ACCUM_OWNER_RING_BYTES = 192 * 1024
OWNER_WINDOW = 64
# cells per window of the oct accumulation, on every device (the JAX
# package's window): a work item writes up to 256 x 64 f32 sums
OCT_WINDOW = 256


def pack_payload(g, w_corners, cell, w_window: int, payload_dtype=torch.float32, row_align: int = 128):
    """One payload row per sample, in the encoding of `payload_dtype` (the
    module docstring), rows padded to a multiple of `row_align` values (128,
    the JAX layout; 16 bytes is the least the kernel takes): [P, n, fp]."""
    p, n, f_dim = g.shape
    nc = w_corners.shape[-1]
    if payload_dtype == torch.bfloat16:
        w_hi = w_corners.to(torch.bfloat16)
        w_lo = (w_corners - w_hi.float()).to(torch.bfloat16)
        local = (cell % w_window)[:, :, None].to(torch.bfloat16)
        parts = [g.to(torch.bfloat16), w_hi, w_lo, local]
        fp = f_dim + 2 * nc + 1
    else:
        parts = [g.float(), w_corners.float(), cell[:, :, None].float()]
        fp = f_dim + nc + 1
    fp_pad = -(-fp // row_align) * row_align
    if fp_pad > fp:
        parts.append(torch.zeros(p, n, fp_pad - fp, dtype=payload_dtype, device=g.device))
    return torch.cat(parts, dim=-1)


def _payload_layout(packed_s: torch.Tensor, f_dim: int, n_corners: int) -> bool:
    """Checks the row width; returns True for the bf16 encoding."""
    bf16 = packed_s.dtype == torch.bfloat16
    if packed_s.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"windowed_accumulate: payload must be f32 or bf16, got {packed_s.dtype}")
    fp = packed_s.shape[-1]
    if fp < f_dim + (2 if bf16 else 1) * n_corners + 1 or (fp * packed_s.element_size()) % 16:
        raise ValueError(f"windowed_accumulate: payload rows of {fp} do not fit the layout")
    return bf16


def windowed_accumulate_plain(packed_s, offsets, f_dim, n_corners, n_cells_pad, w_window):
    """Plain PyTorch `windowed_accumulate`: decode the payload, scatter-add."""
    p, _, _ = packed_s.shape
    bf16 = _payload_layout(packed_s, f_dim, n_corners)
    nw = n_cells_pad // w_window
    nc, f = n_corners, f_dim
    out = torch.zeros(p, n_cells_pad, nc * f, dtype=torch.float32, device=packed_s.device)
    for pi in range(p):
        off = offsets[pi].long()
        rows = packed_s[pi, : int(off[-1])].float()
        g = rows[:, :f]
        if bf16:
            w = rows[:, f : f + nc] + rows[:, f + nc : f + 2 * nc]
            window = torch.repeat_interleave(torch.arange(nw, device=off.device), off.diff())
            cell = window * w_window + rows[:, f + 2 * nc].long()
        else:
            w = rows[:, f : f + nc]
            cell = rows[:, f + nc].long()
        out[pi].index_add_(0, cell, (w[:, :, None] * g[:, None, :]).reshape(-1, nc * f))
    return out


def windowed_accumulate(
    packed_s: torch.Tensor,  # [P, M, fp] f32 or bf16, window-sorted
    offsets: torch.Tensor,  # [P, NW + 1] int32 window sample ranges
    f_dim: int,
    n_corners: int,
    n_cells_pad: int,
    w_window: int,
) -> torch.Tensor:
    """-> [P, n_cells_pad, nc*F] f32: per cell, the sum over its samples of
    concat_c(w[i, c] * g[i, :]).  Cells without samples are exactly 0."""
    if cuda_lib.runs_plain("windowed_accumulate", packed_s, offsets):
        return windowed_accumulate_plain(
            packed_s, offsets, f_dim, n_corners, n_cells_pad, w_window)
    p, m, fp = packed_s.shape
    bf16 = _payload_layout(packed_s, f_dim, n_corners)
    if n_cells_pad % w_window:
        raise ValueError("windowed_accumulate: n_cells_pad must be a multiple of w_window")
    nw = n_cells_pad // w_window
    cuda_lib.check_cuda_inputs("windowed_accumulate", packed_s.dtype, (p, m, fp), packed_s)
    cuda_lib.check_cuda_inputs("windowed_accumulate", torch.int32, (p, nw + 1), offsets)
    # the kernel writes every element (an empty window's zeros too)
    out = torch.empty(p, n_cells_pad, n_corners * f_dim, dtype=torch.float32,
                      device=packed_s.device)
    if p and nw:
        # the kernel's work list, made on the device into `scratch`: window
        # (p, v) is split into max(1, ceil(count / ACCUM_CHUNK)) chunks; the
        # exclusive scan of that, then 4 ints per chunk (max_items bounds the
        # chunks without a sync), then the list of split windows
        max_items = p * nw + p * -(-m // ACCUM_CHUNK)
        scratch = torch.empty(p * nw + 4 + 4 * max_items + p * nw + 1, dtype=torch.int32,
                              device=packed_s.device)
        # the split windows' later chunks, each with a slot of partial sums
        # and its flags: fewer than count / ACCUM_CHUNK per window, so
        # p * (m // ACCUM_CHUNK) slots bound them without a sync
        max_slots = p * (m // ACCUM_CHUNK)
        partials = torch.empty(max(1, max_slots), w_window, n_corners * f_dim, dtype=torch.float32,
                               device=packed_s.device)
        flag_capacity = max_slots * max(32, n_corners * w_window)
        flags = torch.empty(max(1, flag_capacity), dtype=torch.int32, device=packed_s.device)
        tile = w_window * n_corners * f_dim * 4
        tile_bytes, stages, stage_bytes, threads = next(
            (shape for shape in ACCUM_SHAPES if tile <= shape[0]), ACCUM_SHAPES[-1])
        stage_rows = max(1, stage_bytes // (fp * packed_s.element_size()))
        owner_stages = min(8, ACCUM_OWNER_RING_BYTES // (ACCUM_OWNER_STAGE_ROWS * fp * packed_s.element_size()))
        cuda_lib.library().call(
            "tn_windowed_accumulate", packed_s.data_ptr(), offsets.data_ptr(),
            scratch.data_ptr(), max_items, ACCUM_CHUNK, p, m, fp, f_dim, n_corners,
            nw, w_window, int(bf16), tile_bytes, stages, stage_rows, threads,
            owner_stages if owner_stages >= 2 else 0, ACCUM_OWNER_STAGE_ROWS // 32, partials.data_ptr(),
            max_slots, flags.data_ptr(), flag_capacity, out.data_ptr(), cuda_lib.stream_of(packed_s),
        )
        windowed_accumulate.launches += 1
    return out


windowed_accumulate.launches = 0


KEY_BITS = 32  # of the packed sort keys: window id over sample index


def default_window(device: torch.device, width: int, oct_rows: bool = False) -> int:
    """The window the pipeline sorts by: OCT_WINDOW cells for Cobafa's oct
    rows (`oct_rows`, `oct_accumulate`) on every device; otherwise 256
    cells, the JAX package's, on the CPU, and on a CUDA device the largest
    power of two <= OWNER_WINDOW whose f32 tile [W, width] fits the tile
    kernel's smallest block shape, so that one block reads each sample once
    (and up to 4 corners x 96 values, or 8 corners of up to 64 values in
    all, are summed in registers, in a fixed order), at any number of cells
    and samples: where the packed keys of those windows do not fit,
    `table_grad_sorted` sorts by key and value."""
    if oct_rows:
        return OCT_WINDOW
    w = 256
    if device.type == "cuda":
        while w > 1 and (w > OWNER_WINDOW or w * width * 4 > ACCUM_SHAPES[0][0]):
            w //= 2
    return w


def window_keys(cell: torch.Tensor, n_cells_pad: int, w_window: int):
    """The packed sort keys of `sort_by_window`: (window << idx_bits) |
    sample index -> (keys [P, n] int32, idx_bits, window_bits, bias).  Keys
    of all 32 bits carry the window id less `bias` = 2^(window_bits - 1), so
    that bit 31 is a sign and the signed order is the windows' order; shorter
    keys have no bias."""
    n = cell.shape[-1]
    nw = n_cells_pad // w_window
    idx_bits, window_bits = _bits(n), _bits(nw)
    if not window_keys_fit(n_cells_pad, w_window, n):
        raise ValueError(f"sort_by_window: {nw} windows x {n} samples do not fit {KEY_BITS} key bits")
    shift = w_window.bit_length() - 1
    if (1 << shift) != w_window:
        raise ValueError("sort_by_window: w_window must be a power of two")
    bias = (1 << (window_bits - 1)) if idx_bits + window_bits == 32 else 0
    return pack_keys((cell.to(torch.int32) >> shift) - bias, idx_bits), idx_bits, window_bits, bias


def _window_offsets(bucket: torch.Tensor, nw: int) -> torch.Tensor:
    """[P, NW + 1] int32 sample ranges of the ascending window ids `bucket`."""
    p = bucket.shape[0]
    queries = torch.arange(nw + 1, dtype=torch.int32, device=bucket.device)
    return torch.searchsorted(bucket.contiguous(), queries.expand(p, nw + 1).contiguous()).to(torch.int32)


def window_keys_fit(n_cells_pad: int, w_window: int, n: int) -> bool:
    """Whether `sort_by_window`'s packed keys (window id over sample index)
    fit KEY_BITS."""
    return _bits(n_cells_pad // w_window) + _bits(n) <= KEY_BITS


def sort_by_window_pairs(cell: torch.Tensor, n_cells_pad: int, w_window: int):
    """`sort_by_window` for any number of windows and samples: the window
    ids sorted as keys by their bits, the sample index carried as a value
    (`sort_pairs_i32`).  The sort is stable, so a window's samples keep
    their input order, as the packed keys' index bits keep it."""
    p, n = cell.shape
    nw = n_cells_pad // w_window
    shift = w_window.bit_length() - 1
    if (1 << shift) != w_window:
        raise ValueError("sort_by_window: w_window must be a power of two")
    window = cell.to(torch.int32) >> shift
    iota = torch.arange(n, dtype=torch.int32, device=cell.device).expand(p, n).contiguous()
    bucket, perm = sort_pairs_i32(window.contiguous(), iota, begin_bit=0, end_bit=_bits(nw))
    return perm, _window_offsets(bucket, nw)


def sort_by_window(cell: torch.Tensor, n_cells_pad: int, w_window: int):
    """Partition samples by table window.

    cell: [P, n] int32 cell ids in [0, n_cells_pad).  Returns (perm [P, n]
    int32 gather indices grouped by ascending window, offsets [P, NW + 1]
    int32 window sample ranges).  Within-window order is arbitrary."""
    nw = n_cells_pad // w_window
    keys, idx_bits, window_bits, bias = window_keys(cell, n_cells_pad, w_window)
    # the keys' low idx_bits are an ascending iota, so a stable sort by the
    # window bits alone is the full ascending sort
    skeys = sort_i32(keys, begin_bit=idx_bits, end_bit=idx_bits + window_bits)
    bucket, perm = unpack_keys(skeys, idx_bits)
    return perm, _window_offsets(bucket + bias, nw)


def sort_windows(cell: torch.Tensor, n_cells_pad: int, w_window: int):
    """`sort_by_window` where its packed keys fit KEY_BITS, else
    `sort_by_window_pairs`: (perm [P, n], offsets [P, NW + 1]), each
    window's samples in their input order."""
    fits = window_keys_fit(n_cells_pad, w_window, cell.shape[-1])
    return (sort_by_window if fits else sort_by_window_pairs)(cell, n_cells_pad, w_window)


def oct_accumulate_plain(g, w, cell, perm, n_cells_pad):
    """Plain PyTorch `oct_accumulate`: the rows gathered through the
    permutation, then one `index_add_` in that order."""
    idx = perm.long()
    f = g.shape[-1]
    contrib = (w[idx][:, :, None] * g[idx][:, None, :]).reshape(-1, 8 * f)
    out = torch.zeros(n_cells_pad, 8 * f, dtype=torch.float32, device=g.device)
    return out.index_add_(0, cell[idx].long(), contrib)


def oct_accumulate(
    g: torch.Tensor,  # [n, F] f32 cotangents, 1 <= F <= 8
    w: torch.Tensor,  # [n, 8] f32 corner weights (CORNERS_3D order)
    cell: torch.Tensor,  # [n] int32 cell ids in [0, n_cells_pad)
    perm: torch.Tensor,  # [n] int32 sample indices grouped by window (`sort_windows`)
    offsets: torch.Tensor,  # [NW + 1] int32 window ranges of perm
    n_cells_pad: int,
    w_window: int,
) -> torch.Tensor:
    """-> [n_cells_pad, 8F] f32: per cell, the sum over its samples of
    concat_k(w[i, k] * g[i]), each cell's samples taken in perm's order (a
    split window's chunks summed apart, then added in order).  Cells without
    samples, and samples whose cotangent is all zero, add exactly 0."""
    if cuda_lib.runs_plain("oct_accumulate", g, w, cell, perm, offsets):
        return oct_accumulate_plain(g, w, cell, perm, n_cells_pad)
    n, f = g.shape
    if not 1 <= f <= 8 or n_cells_pad % w_window:
        raise ValueError(f"oct_accumulate: F = {f} (1..8), {n_cells_pad} cells in windows of {w_window}")
    nw = n_cells_pad // w_window
    cuda_lib.check_cuda_inputs("oct_accumulate", torch.float32, (n, f), g)
    cuda_lib.check_cuda_inputs("oct_accumulate", torch.float32, (n, 8), w)
    cuda_lib.check_cuda_inputs("oct_accumulate", torch.int32, (n,), cell, perm)
    cuda_lib.check_cuda_inputs("oct_accumulate", torch.int32, (nw + 1,), offsets)
    # the kernel writes every element (an empty window's zeros too)
    out = torch.empty(n_cells_pad, 8 * f, dtype=torch.float32, device=g.device)
    # windowed_accumulate's work list, slots and flags, for one projection
    # and one flag per slot
    max_items = nw + -(-n // ACCUM_CHUNK)
    scratch = torch.empty(nw + 4 + 4 * max_items + nw + 1, dtype=torch.int32, device=g.device)
    max_slots = n // ACCUM_CHUNK
    partials = torch.empty(max(1, max_slots), w_window, 8 * f, dtype=torch.float32, device=g.device)
    flags = torch.empty(max(1, 32 * max_slots), dtype=torch.int32, device=g.device)
    cuda_lib.library().call(
        "tn_oct_accumulate", g.data_ptr(), w.data_ptr(), cell.data_ptr(), perm.data_ptr(),
        offsets.data_ptr(), scratch.data_ptr(), max_items, ACCUM_CHUNK, n, f, nw, w_window,
        partials.data_ptr(), max_slots, flags.data_ptr(), 32 * max_slots, out.data_ptr(),
        cuda_lib.stream_of(g),
    )
    oct_accumulate.launches += 1
    return out


oct_accumulate.launches = 0


def table_grad_sorted(
    g: torch.Tensor,  # [P, n, F] cotangents f32
    w_corners: torch.Tensor,  # [P, n, nc] corner lerp weights f32
    cell: torch.Tensor,  # [P, n] int cell ids in [0, n_cells)
    n_cells: int,
    w_window: int | None = None,  # None: `default_window`
    payload_dtype: torch.dtype = torch.float32,
    row_align: int = 128,
) -> torch.Tensor:
    """`zeros(n_cells, nc*F).index_add_(0, cell, concat_c(w[..., c, None] * g))`
    per projection, built from sort_by_window (or, where its packed keys do
    not fit, sort_by_window_pairs) + one packed permutation gather +
    windowed_accumulate.  Returns [P, n_cells, nc*F] f32."""
    p, n, f_dim = g.shape
    nc = w_corners.shape[-1]
    if w_window is None:
        w_window = default_window(g.device, nc * f_dim)
    n_cells_pad = -(-n_cells // w_window) * w_window
    sort = sort_by_window if window_keys_fit(n_cells_pad, w_window, n) else sort_by_window_pairs
    perm, offsets = sort(cell, n_cells_pad, w_window)
    packed = pack_payload(g, w_corners, cell, w_window, payload_dtype, row_align)
    fp = packed.shape[-1]
    # one flat row gather for all projections
    gidx = perm.long() + (torch.arange(p, device=g.device) * n)[:, None]
    packed_s = packed.reshape(p * n, fp).index_select(0, gidx.reshape(-1))
    out = windowed_accumulate(packed_s.reshape(p, n, fp), offsets, f_dim, nc, n_cells_pad, w_window)
    return out[:, :n_cells]


def windowed_accumulate_ref(g_s, w_s, cell_s, n_cells):
    """Plain scatter-add reference: [P, n_cells, nc*F] f32."""
    p, n, f_dim = g_s.shape
    nc = w_s.shape[-1]
    out = torch.zeros(p, n_cells, nc * f_dim, dtype=torch.float32, device=g_s.device)
    for pi in range(p):
        contrib = (w_s[pi, :, :, None] * g_s[pi, :, None, :]).reshape(n, nc * f_dim)
        out[pi].index_add_(0, cell_s[pi].long(), contrib)
    return out
