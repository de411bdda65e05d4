"""Sorted-window table-gradient accumulation.

Counterpart of `tinynerf_tpu/ops/table_grad.py`.  The backward of a
cell-packed bilinear lookup is a scatter-add of per-sample rows
concat_c(w[i, c] * g[i, :]) into the rows cell[i] of a [n_cells, nc * F]
table.  The samples are first grouped by table WINDOW (W consecutive cells)
with the bitonic sort (`ops/bitonic.py`), then each window is accumulated
by `windowed_accumulate`: on CUDA tensors the hand-written kernel of
`csrc/table_grad.cu` (one shared-memory band of cells per block and chunk
of a window's samples, f32 atomics), on CPU tensors its plain version,
decode + `index_add_`.

One packed payload row per sample, so the sorted stream costs one
permutation gather, in either of the JAX package's encodings (keyed on the
payload dtype):

  f32  - [g(F) | w(nc) | cell | pad] f32, rows padded to a multiple of 128;
  bf16 - [g(F) | w_hi(nc) | w_lo(nc) | cell % W | pad] bf16: half the bytes;
         the weights ride as an exact-ish (hi, lo) pair, the cell as its
         offset inside the window (< 256, exact in bf16), and only g is
         rounded to bf16 (~2^-8 relative).
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .bitonic import _bits, pack_keys, packed_bits_ok, sort_i32, unpack_keys


# samples of one window walked by one block of the accumulation kernel
ACCUM_CHUNK = 1024


def pack_payload(g, w_corners, cell, w_window: int, payload_dtype=torch.float32):
    """One payload row per sample, in the encoding of `payload_dtype` (the
    module docstring), rows padded to a multiple of 128: [P, n, fp]."""
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
    fp_pad = -(-fp // 128) * 128
    if fp_pad > fp:
        parts.append(torch.zeros(p, n, fp_pad - fp, dtype=payload_dtype, device=g.device))
    return torch.cat(parts, dim=-1)


def _payload_layout(packed_s: torch.Tensor, f_dim: int, n_corners: int) -> bool:
    """Checks the row width; returns True for the bf16 encoding."""
    bf16 = packed_s.dtype == torch.bfloat16
    if packed_s.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"windowed_accumulate: payload must be f32 or bf16, got {packed_s.dtype}")
    fp = packed_s.shape[-1]
    if fp < f_dim + (2 if bf16 else 1) * n_corners + 1 or fp % 128:
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
    out = torch.zeros(p, n_cells_pad, n_corners * f_dim, dtype=torch.float32,
                      device=packed_s.device)
    if p and nw:
        # the kernel's work list: window (p, v) is split into
        # ceil(count / ACCUM_CHUNK) chunks; chunk_start is their exclusive scan
        counts = (offsets[:, 1:] - offsets[:, :-1]).reshape(-1)
        chunk_start = torch.cat([
            counts.new_zeros(1), torch.cumsum((counts + ACCUM_CHUNK - 1) // ACCUM_CHUNK, 0),
        ]).to(torch.int32)
        max_chunks = p * nw + p * -(-m // ACCUM_CHUNK)  # >= the total, known without a sync
        cuda_lib.library().call(
            "tn_windowed_accumulate", packed_s.data_ptr(), offsets.data_ptr(),
            chunk_start.data_ptr(), max_chunks, ACCUM_CHUNK, p, m, fp, f_dim, n_corners,
            nw, w_window, int(bf16), out.data_ptr(), cuda_lib.stream_of(packed_s),
        )
        windowed_accumulate.launches += 1
    return out


windowed_accumulate.launches = 0


def sort_by_window(cell: torch.Tensor, n_cells_pad: int, w_window: int):
    """Partition samples by table window.

    cell: [P, n] int32 cell ids in [0, n_cells_pad).  Returns (perm [P, n]
    int32 gather indices grouped by ascending window, offsets [P, NW + 1]
    int32 window sample ranges).  Within-window order is arbitrary."""
    p, n = cell.shape
    nw = n_cells_pad // w_window
    if not packed_bits_ok(nw, n):
        raise ValueError(f"sort_by_window: {nw} windows x {n} samples do not fit 31 bits")
    shift = w_window.bit_length() - 1
    if (1 << shift) != w_window:
        raise ValueError("sort_by_window: w_window must be a power of two")
    idx_bits = _bits(n)
    skeys = sort_i32(pack_keys(cell.to(torch.int32) >> shift, idx_bits))
    bucket, perm = unpack_keys(skeys, idx_bits)
    queries = torch.arange(nw + 1, dtype=torch.int32, device=cell.device)
    offsets = torch.searchsorted(bucket.contiguous(), queries.expand(p, nw + 1).contiguous())
    return perm, offsets.to(torch.int32)


def table_grad_sorted(
    g: torch.Tensor,  # [P, n, F] cotangents f32
    w_corners: torch.Tensor,  # [P, n, nc] corner lerp weights f32
    cell: torch.Tensor,  # [P, n] int cell ids in [0, n_cells)
    n_cells: int,
    w_window: int = 256,
    payload_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """`zeros(n_cells, nc*F).index_add_(0, cell, concat_c(w[..., c, None] * g))`
    per projection, built from sort_by_window + one packed permutation
    gather + windowed_accumulate.  Returns [P, n_cells, nc*F] f32."""
    p, n, f_dim = g.shape
    nc = w_corners.shape[-1]
    n_cells_pad = -(-n_cells // w_window) * w_window
    perm, offsets = sort_by_window(cell, n_cells_pad, w_window)
    packed = pack_payload(g, w_corners, cell, w_window, payload_dtype)
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
