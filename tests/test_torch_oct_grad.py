"""Cobafa's oct table gradient in the port's two steps, on the CPU:

  * the accumulation through the sort's permutation (`ops/table_grad.py:
    oct_accumulate`; its plain version a gather through perm and one
    `index_add_`), bit-equal to the payload route it replaced (`pack_payload`
    in f32 with rows of 4 values, the permutation gather, then
    `windowed_accumulate_plain`), on `OCT_CASES` of
    test_torch_fixed_order.py (the 33-key-bit case included);
  * the fold of the cell gradient onto the grid (`ops/octbuild.py:
    oct_fold`), bit-equal to numpy and jnp transcriptions of the JAX
    package's pad-add loop (`tinynerf_tpu/ops/interp.py:_trilinear_oct_bwd`);
  * the whole backward of `trilinear_lookup_oct` bit-equal to the payload
    route followed by the eight shifted adds;
  * numpy models of what `csrc/table_grad.cu`'s oct kernel does that no
    CPU run reaches: its in-block placement of a chunk's rows in cell order
    (counts, an exclusive scan, then 32 rows at a time ranked among the
    rows of their cell), and its work items' slots, one flag each, added
    in item order whatever order the items finish in.

Tolerances: the plain versions bit-equal (the same products summed in the
same order); the model's sums 1e-5 of the largest (its chunks' sums, then
the chunks', against one pass) and bit-equal between completion orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fixed_order import OCT_CASES, _points, _work_list

from tinynerf_tpu_torch.models import make_model
from tinynerf_tpu_torch.ops import interp, octbuild, table_grad

torch.set_num_threads(2)

T = torch.from_numpy


def _oct_inputs(shape, n, seed, pad=0.3):
    """cell [n] int64, w [n, 8] of `_cell_3d` at seeded points, and g [n, F]
    whose last `pad` share is zero (a pad tail, all at one point)."""
    rng = np.random.default_rng(seed)
    x = _points(n, seed)
    n_pad = int(pad * n)
    x[n - n_pad :] = x[5]
    g = rng.normal(size=(n, shape[-1])).astype(np.float32)
    g[n - n_pad :] = 0.0
    cell, w = interp._cell_3d(T(x), *shape[:3])
    return cell, w, T(g)


def _payload_route(g, w, cell, n_cells_pad, w_window):
    """The payload route's plain version: the f32 payload of rows of 4 values, gathered
    through the window sort's permutation, then decoded and scattered."""
    perm, offsets = table_grad.sort_windows(cell.to(torch.int32)[None], n_cells_pad, w_window)
    rows = table_grad.pack_payload(g[None], w[None], cell[None], w_window, torch.float32, row_align=4)
    rows = rows[0, perm[0].long()][None]
    return table_grad.windowed_accumulate_plain(rows, offsets, g.shape[1], 8, n_cells_pad, w_window)[0]


@pytest.mark.parametrize("case", sorted(OCT_CASES))
def test_oct_accumulate_plain_bit_equal_to_payload_route(case):
    shape, n, w_window = OCT_CASES[case]
    n_cells = int(np.prod([r - 1 for r in shape[:3]]))
    w_window = w_window or table_grad.default_window(torch.device("cpu"), 8 * shape[-1], oct_rows=True)
    n_cells_pad = -(-n_cells // w_window) * w_window
    cell, w, g = _oct_inputs(shape, n, 3)
    cell32 = cell.to(torch.int32)
    perm, offsets = table_grad.sort_windows(cell32[None], n_cells_pad, w_window)
    got = table_grad.oct_accumulate(g, w, cell32, perm[0], offsets[0], n_cells_pad, w_window)
    ref = _payload_route(g, w, cell, n_cells_pad, w_window)
    assert got.shape == (n_cells_pad, 8 * shape[-1]) and got.dtype == torch.float32
    assert torch.equal(got, ref)
    assert torch.equal(got, table_grad.oct_accumulate_plain(g, w, cell32, perm[0], n_cells_pad))
    assert float(got.abs().max()) > 0


def _jax_pad_adds_np(gq, shape):
    """numpy transcription of `_trilinear_oct_bwd`'s loop: grad = grad +
    pad(slice) for each corner in (dx, dy, dz) order, from f32 zeros."""
    r0, r1, r2, f = shape
    gq4 = gq.reshape(r0 - 1, r1 - 1, r2 - 1, 8 * f)
    grad = np.zeros((r0, r1, r2, f), np.float32)
    c = 0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                sl = gq4[..., c * f : (c + 1) * f]
                grad = grad + np.pad(sl, [(dx, 1 - dx), (dy, 1 - dy), (dz, 1 - dz), (0, 0)])
                c += 1
    return grad


def _jax_pad_adds_jnp(gq, shape):
    r0, r1, r2, f = shape
    gq4 = jnp.asarray(gq).reshape(r0 - 1, r1 - 1, r2 - 1, 8 * f)
    grad = jnp.zeros((r0, r1, r2, f), jnp.float32)
    for c, (dx, dy, dz) in enumerate(octbuild.CORNERS_3D):
        grad = grad + jnp.pad(gq4[..., c * f : (c + 1) * f], [(dx, 1 - dx), (dy, 1 - dy), (dz, 1 - dz), (0, 0)])
    return np.asarray(grad)


# the Cobafa field's widths at a small size, grids that are not cubic, r = 2
FOLD_SHAPES = [(9, 9, 9, 8), (12, 12, 12, 4), (8, 8, 8, 6), (5, 7, 6, 3), (2, 4, 3, 8), (6, 2, 9, 1)]


@pytest.mark.parametrize("jax_form", ["numpy", "jnp"])
@pytest.mark.parametrize("shape", FOLD_SHAPES)
def test_oct_fold_plain_bit_equal_to_jax_pad_adds(shape, jax_form):
    """Values of every magnitude, exact zeros and -0.0 among them: the
    JAX loop adds the pads' +0 where the port leaves a term out, which
    changes no bit of a sum that starts at +0."""
    rng = np.random.default_rng(sum(shape))
    r0, r1, r2, f = shape
    gq = (rng.normal(size=((r0 - 1) * (r1 - 1) * (r2 - 1), 8 * f)) * 10.0 ** rng.integers(-20, 20, size=1)
          ).astype(np.float32)
    gq[rng.random(gq.shape) < 0.2] = 0.0
    gq[rng.random(gq.shape) < 0.2] = -0.0
    ref = (_jax_pad_adds_np if jax_form == "numpy" else _jax_pad_adds_jnp)(gq, shape)
    got = octbuild.oct_fold(T(gq), shape)
    assert got.shape == shape and got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("shape", [(12, 12, 12, 8), (20, 17, 19, 4), (16, 16, 16, 6)])
def test_trilinear_oct_backward_bit_equal_to_payload_route(shape):
    """The table gradient through autograd: the window sort, the
    accumulation through the permutation and the fold, bit-equal to the
    payload route and the eight shifted adds."""
    n = 4000
    rng = np.random.default_rng(5)
    table = T(rng.normal(size=shape).astype(np.float32)).requires_grad_()
    x = T(_points(n, 6))
    cot = T(rng.normal(size=(n, shape[-1])).astype(np.float32))
    interp.trilinear_lookup_oct(table, x, torch.float32).backward(cot)
    cell, w = interp._cell_3d(x, *shape[:3])
    n_cells = int(np.prod([r - 1 for r in shape[:3]]))
    n_cells_pad = -(-n_cells // 256) * 256
    gq = _payload_route(cot, w, cell, n_cells_pad, 256)[:n_cells]
    assert torch.equal(table.grad, octbuild.oct_fold_plain(gq, shape))


def test_oct_window_and_sort_rule_at_full_width():
    """Windows of OCT_WINDOW cells on both devices; at the training cap
    (819,200 samples) the packed keys fit for five of the Cobafa field's
    seven grids, and the two largest (107^3 and 127^3 cells: 13 window
    bits over 20 index bits) take the key-value sort."""
    field = make_model("cobafa", device="meta")[0]
    n = 819_200
    pairs = []
    for p in (field.coef, *field.basis):
        r0, r1, r2, f = p.shape
        n_cells = (r0 - 1) * (r1 - 1) * (r2 - 1)
        for dev in ("cpu", "cuda"):
            assert table_grad.default_window(torch.device(dev), 8 * f, oct_rows=True) == 256
        if not table_grad.window_keys_fit(-(-n_cells // 256) * 256, 256, n):
            pairs.append(r0)
    assert sorted(pairs) == [108, 128]
    # K-Planes' rule is the one it had: windows of 64 cells on the card
    assert table_grad.default_window(torch.device("cuda"), 4 * 96) == 64


def test_oct_wrappers_take_cpu_or_cuda_tensors_only():
    m = torch.empty(8, 4, device="meta")
    mi = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        table_grad.oct_accumulate(m, torch.empty(8, 8, device="meta"), mi, mi, mi[:2], 256, 256)
    with pytest.raises(ValueError):
        octbuild.oct_fold(torch.empty(1, 32, device="meta"), (2, 2, 2, 4))
    with pytest.raises(ValueError):  # CPU and another device mixed
        table_grad.oct_accumulate(torch.zeros(8, 4), torch.zeros(8, 8), mi, mi, mi[:2], 256, 256)


# ---- the oct kernel's chunk placement and split windows, as numpy models


def _match_any(vals):
    """__match_any_sync: per lane, the mask of lanes holding its value."""
    vals = np.asarray(vals)
    return [int(sum(1 << k for k in np.nonzero(vals == v)[0])) for v in vals]


def place_chunk(listed, w_window):
    """Warp 0 of `oct_accumulate_kernel`: the counts' exclusive scan, then
    the listed rows (a window-local cell, or -1 for a zero cotangent)
    placed 32 at a time.  Returns (order, ends): cell c's rows are
    order[ends[c - 1] : ends[c]] (from 0 for c = 0)."""
    count = len(listed)
    counts = np.bincount([c for c in listed if c >= 0], minlength=w_window)
    ends = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)  # each cell's first row
    order = np.full(int(counts.sum()), -1, np.int64)
    for base in range(0, count, 32):
        lanes = [listed[j] if j < count else -1 for j in range(base, base + 32)]
        if all(c < 0 for c in lanes):
            continue
        peers = _match_any(lanes)
        at = [ends[c] + bin(peers[k] & ((1 << k) - 1)).count("1") if c >= 0 else 0 for k, c in enumerate(lanes)]
        for k, c in enumerate(lanes):
            if c < 0:
                continue
            order[at[k]] = base + k
            if k == peers[k].bit_length() - 1:  # the highest peer moves the cell's next place
                ends[c] += bin(peers[k]).count("1")
    return order, ends


@pytest.mark.parametrize("count,w_window,zero_share", [(1024, 256, 0.0), (1024, 256, 0.6), (25, 256, 0.2),
                                                        (1000, 4, 0.1), (700, 1, 0.5), (0, 256, 0.0),
                                                        (1024, 256, 1.0)])
def test_chunk_placement_keeps_each_cells_rows_in_order(count, w_window, zero_share):
    rng = np.random.default_rng(count + w_window)
    listed = rng.integers(0, w_window, count)
    listed[: count // 3] = rng.integers(0, min(3, w_window), count // 3)  # hot cells
    listed[rng.random(count) < zero_share] = -1
    order, ends = place_chunk(list(listed), w_window)
    assert sorted(order.tolist()) == [j for j in range(count) if listed[j] >= 0]
    for c in range(w_window):
        rows = order[(ends[c - 1] if c else 0) : ends[c]]
        assert rows.tolist() == [j for j in range(count) if listed[j] == c]


def _model_oct_accumulate(g, w, cell, perm, offsets, w_window, chunk, finish_order):
    """The oct kernel and the combine, f32, in numpy: items of at most
    `chunk` samples of one window run in `finish_order`; each places its
    rows (`place_chunk`) and sums each cell's in order; a later item of a
    split window stores into its slot with one flag (any row not all zero),
    then each split window adds its flagged slots in item order."""
    f = g.shape[1]
    nw = offsets.size - 1
    items, chunk_start = _work_list(offsets[None], chunk)
    max_slots = perm.size // chunk
    out = np.full((nw, w_window, 8 * f), np.nan, np.float32)
    partials = np.full((max(1, max_slots), w_window, 8 * f), np.nan, np.float32)
    flags = np.full(max(1, max_slots), -1)
    for u in finish_order:
        pw, start, count, tag = items[u]
        idx = perm[start : start + count]
        listed = [int(cell[i]) % w_window if np.any(g[i] != 0) else -1 for i in idx]
        order, ends = place_chunk(listed, w_window)
        acc = np.zeros((w_window, 8 * f), np.float32)
        for c in range(w_window):
            for j in order[(ends[c - 1] if c else 0) : ends[c]]:
                i = idx[j]
                acc[c] += (w[i][:, None] * g[i][None, :]).reshape(-1)
        if tag < 2:
            out[pw] = acc
            continue
        slot = u - pw - 1
        flags[slot] = int(any(c >= 0 for c in listed))
        if flags[slot]:
            partials[slot] = acc
    for pw in range(nw):
        for k in range(1, chunk_start[pw + 1] - chunk_start[pw]):
            slot = chunk_start[pw] + k - pw - 1
            if flags[slot]:
                out[pw] += partials[slot]
    return out.reshape(nw * w_window, 8 * f), flags, items


def test_oct_split_windows_model_matches_plain_in_any_finish_order():
    """Training-shaped cells at a small chunk: a hot window of many items,
    a pad tail of zero cotangents in one cell whose later items flag
    nothing; within 1e-5 of the plain version, bit-equal whatever order the
    items finish in."""
    rng = np.random.default_rng(23)
    n, f, w_window, chunk, n_cells = 3000, 4, 16, 128, 20 * 16
    cell = rng.integers(0, n_cells, n)
    cell[:600] = 5 * w_window + rng.integers(0, w_window, 600)
    cell[-900:] = 13 * w_window + 2
    g = rng.normal(size=(n, f)).astype(np.float32)
    g[-900:] = 0.0
    w = rng.uniform(size=(n, 8)).astype(np.float32)
    perm, offsets = table_grad.sort_windows(T(cell.astype(np.int32))[None], n_cells, w_window)
    perm, offsets = perm[0].numpy(), offsets[0].numpy()
    plain = table_grad.oct_accumulate_plain(T(g), T(w), T(cell.astype(np.int32)), T(perm), n_cells).numpy()
    n_items = len(_work_list(offsets[None], chunk)[0])
    out, flags, items = _model_oct_accumulate(g, w, cell, perm, offsets, w_window, chunk, range(n_items))
    np.testing.assert_allclose(out, plain, rtol=0, atol=1e-5 * np.abs(plain).max())
    pad_items = [u for u, (pw, start, count, tag) in enumerate(items)
                 if tag >= 2 and not np.any(g[perm[start : start + count]] != 0)]
    live_items = [u for u, it in enumerate(items) if it[3] >= 2 and u not in pad_items]
    assert pad_items and live_items
    assert all(flags[u - items[u][0] - 1] == 0 for u in pad_items)
    assert all(flags[u - items[u][0] - 1] == 1 for u in live_items)
    shuffled = _model_oct_accumulate(g, w, cell, perm, offsets, w_window, chunk, rng.permutation(n_items))[0]
    assert np.array_equal(out, shuffled)
