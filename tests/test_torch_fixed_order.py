"""The sums that make a training step and a served view repeat themselves
bit for bit on the card, in their plain forms, against the JAX package:

  * the renderer's per-ray sum (`ops/segscan.py: segment_sum`, the JAX
    package's `jax.ops.segment_sum`), its gradient, and the rule its kernel
    follows (a run's segment-local inclusive cumsum at its last sample);
  * Cobafa's oct table gradient through the window sort (by packed keys, or
    by key and value where the windows and the samples pass 32 bits) and
    the windowed accumulation (`ops/interp.py: oct_table_grad`), against
    JAX's `_trilinear_oct_bwd` at the basis grids' widths (8 and 4) and the
    coefficient grid's (6);
  * the work list of the accumulation kernel (`csrc/table_grad.cu`) as a
    numpy model: windows split into chunks of ACCUM_CHUNK samples, each
    later chunk's partial sums in a slot of its own with a flag per owner
    warp, added to the first chunk's sums in item order, whatever order the
    chunks finish in.

Tolerances: the per-ray sums 1e-6 (f32 sums of the same terms, in sample
order on both sides); their gradient equal (a gather); the oct gradient
1e-5 of its largest magnitude (f32 sums in another order); the model's
sums 1e-5 of the largest (the plain version's order is the samples', the
model's a chunk's then the chunks'), and bit-equal between two completion
orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.ops import interp as jinterp
from tinynerf_tpu_torch.ops import bitonic, interp, segscan, table_grad

torch.set_num_threads(2)

T = torch.from_numpy


def _packed_rows(seed, n_rays=300, max_count=120, pad=500, c=4):
    """Ray-major rows [n, c] of n_rays rays (some empty), then a pad tail of id n_rays."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, max_count + 1, n_rays) * (rng.random(n_rays) > 0.2)
    seg = np.concatenate([np.repeat(np.arange(n_rays), counts), np.full(pad, n_rays)]).astype(np.int32)
    x = rng.uniform(0.0, 1.0, (seg.size, c)).astype(np.float32)
    return x, seg, n_rays


@pytest.mark.parametrize("c", [4, 3, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_segment_sum_plain_matches_jax_segment_sum(seed, c):
    """The renderer's reduction: ids outside [0, n_rays) dropped (JAX sums
    them into segment n_rays and slices it away), empty rays 0."""
    x, seg, n_rays = _packed_rows(seed, c=c)
    got = segscan.segment_sum(T(x), T(seg), n_rays)
    ref = jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(seg), num_segments=n_rays + 1)[:n_rays]
    assert got.shape == (n_rays, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    empty = np.bincount(seg[seg < n_rays], minlength=n_rays) == 0
    assert empty.any() and not got.numpy()[empty].any()


def test_segment_sum_gradient_matches_jax():
    x, seg, n_rays = _packed_rows(2)
    cot = np.random.default_rng(3).normal(size=(n_rays, 4)).astype(np.float32)
    xt = T(x).requires_grad_()
    (segscan.segment_sum(xt, T(seg), n_rays) * T(cot)).sum().backward()
    _, vjp = jax.vjp(lambda a: jax.ops.segment_sum(a, jnp.asarray(seg), num_segments=n_rays + 1)[:n_rays],
                     jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(cot))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref))
    assert float(xt.grad[seg == n_rays].abs().max()) == 0.0  # the pad tail gets none


def test_segment_sum_kernel_rule_matches_jax():
    """What csrc/segscan.cu's segment_sum_kernel writes: at the last sample
    of each run, the run's segment-local inclusive cumsum, to the run's id
    (ids outside the range not written, every other row 0)."""
    x, seg, n_rays = _packed_rows(4, n_rays=200, max_count=400)
    out = np.zeros((n_rays, 4), np.float32)
    cums = np.stack([segscan.segmented_cumsum_plain(T(x[:, ch]).contiguous(), T(seg)).numpy()
                     for ch in range(4)], axis=1)
    last = np.append(seg[1:] != seg[:-1], True)
    keep = last & (seg < n_rays)
    out[seg[keep]] = cums[keep]
    ref = jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(seg), num_segments=n_rays + 1)[:n_rays]
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("n,n_windows", [(5000, 300), (70_000, 1 << 15), (5000, 1 << 20)])
def test_sort_by_window_pairs_matches_packed_and_argsort(n, n_windows):
    """The key-value sort's partition: the packed keys' where those fit
    (perm and offsets equal), numpy's stable argsort everywhere, keys of 17
    index bits over 20 window bits included."""
    rng = np.random.default_rng(7)
    window = rng.integers(0, n_windows, (2, n)).astype(np.int32)
    window[0, :2] = [n_windows - 1, 0]
    cell = T(window * 4 + 3)
    perm, offsets = table_grad.sort_by_window_pairs(cell, n_windows * 4, 4)
    for p in range(2):
        np.testing.assert_array_equal(perm[p].numpy(), np.argsort(window[p], kind="stable"))
        np.testing.assert_array_equal(offsets[p].numpy(),
                                      np.searchsorted(np.sort(window[p]), np.arange(n_windows + 1)))
    if table_grad.window_keys_fit(n_windows * 4, 4, n):
        perm2, offsets2 = table_grad.sort_by_window(cell, n_windows * 4, 4)
        assert torch.equal(perm, perm2) and torch.equal(offsets, offsets2)
    else:
        with pytest.raises(ValueError, match="32 key bits"):
            table_grad.sort_by_window(cell, n_windows * 4, 4)


def test_sort_pairs_plain_is_stable():
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 50, (3, 999)).astype(np.int32)
    vals = rng.integers(-1000, 1000, (3, 999)).astype(np.int32)
    k, v = bitonic.sort_pairs_i32(T(keys), T(vals), 0, 6)
    order = np.argsort(keys, axis=-1, kind="stable")
    np.testing.assert_array_equal(k.numpy(), np.take_along_axis(keys, order, -1))
    np.testing.assert_array_equal(v.numpy(), np.take_along_axis(vals, order, -1))


def _points(n, seed):
    x = np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(np.float32)
    x[:3] = [[-1, -1, -1], [1, 1, 1], [0, 0, 0]]
    return x


# (grid shape, points, cells per window or None for default_window): the
# basis grids' widths 8 and 4 and the coefficient grid's 6; then windows of
# one cell over 63^3 cells (18 window bits) and 16,385 samples (15 index
# bits): keys of 33 bits, sorted by key and value
OCT_CASES = {"basis_f8": ((12, 12, 12, 8), 3000, None), "basis_f4": ((20, 17, 19, 4), 3000, None),
             "coef_l6": ((16, 16, 16, 6), 3000, None), "coef_l6_33_key_bits": ((64, 64, 64, 6), 16_385, 1)}


@pytest.mark.parametrize("case", sorted(OCT_CASES))
def test_oct_table_grad_plain_matches_jax_oct_bwd(case, monkeypatch):
    """The table gradient of `trilinear_lookup_oct` (f32 gather) for a
    random cotangent, through the window sort and the windowed accumulation,
    against `jax.vjp` of JAX's lookup (its `_trilinear_oct_bwd`)."""
    shape, n, w_window = OCT_CASES[case]
    rng = np.random.default_rng(11)
    table = rng.normal(size=shape).astype(np.float32)
    x = _points(n, 12)
    cot = rng.normal(size=(n, shape[-1])).astype(np.float32)
    calls = {"pairs": 0}
    pairs = table_grad.sort_by_window_pairs

    def counted_pairs(*a):
        calls["pairs"] += 1
        return pairs(*a)

    monkeypatch.setattr(table_grad, "sort_by_window_pairs", counted_pairs)
    if w_window is not None:
        monkeypatch.setattr(interp, "default_window", lambda *a, **k: w_window)
    t = T(table).requires_grad_()
    interp.trilinear_lookup_oct(t, T(x), torch.float32).backward(T(cot))
    _, vjp = jax.vjp(lambda tt: jinterp.trilinear_lookup_oct(tt, jnp.asarray(x), jnp.float32), jnp.asarray(table))
    (ref,) = vjp(jnp.asarray(cot))
    ref = np.asarray(ref)
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    n_cells = int(np.prod([r - 1 for r in shape[:3]]))
    window = w_window or table_grad.default_window(torch.device("cpu"), n_cells, n, 8 * shape[-1], False)
    fits = table_grad.window_keys_fit(-(-n_cells // window) * window, window, n)
    assert calls["pairs"] == (0 if fits else 1)
    assert fits == (case != "coef_l6_33_key_bits")


# ---- the accumulation kernel's work list and ordered combine, as a model


def _work_list(offsets: np.ndarray, chunk: int):
    """csrc/table_grad.cu's items: (pw, first row, rows, tag) per chunk,
    tag 0 for a window's only chunk, else its index + 1, in the order of
    windowed_chunk_scan_kernel's exclusive scan."""
    p, nw1 = offsets.shape
    items, chunk_start = [], [0]
    for pw in range(p * (nw1 - 1)):
        begin, end = offsets[pw // (nw1 - 1), pw % (nw1 - 1)], offsets[pw // (nw1 - 1), pw % (nw1 - 1) + 1]
        n_chunks = max(1, -(-(end - begin) // chunk))
        for c in range(n_chunks):
            start = begin + c * chunk
            items.append((pw, start, min(end, start + chunk) - start, c + 1 if n_chunks > 1 else 0))
        chunk_start.append(chunk_start[-1] + n_chunks)
    return items, chunk_start


def _model_accumulate(rows, offsets, f, nc, w_window, chunk, order):
    """The register kernel and the combine on decoded f32 payload rows [P,
    M, fp]: items run in `order` (as blocks finish), each summing its rows
    per cell in row order; a later chunk's sums go to slot u - pw - 1 with a
    flag per owner warp (cells w and w + 32), then each split window adds
    its flagged slots in item order."""
    p, m, _ = rows.shape
    nw = offsets.shape[1] - 1
    items, chunk_start = _work_list(offsets, chunk)
    max_slots = p * (m // chunk)
    out = np.full((p * nw, w_window, nc * f), np.nan, np.float32)
    partials = np.full((max(1, max_slots), w_window, nc * f), np.nan, np.float32)
    flags = np.full((max(1, max_slots), 32), -1, np.int64)
    slots = []
    for u in order:
        pw, start, count, tag = items[u]
        acc = np.zeros((w_window, nc * f), np.float32)
        for r in rows[pw // nw, start : start + count]:
            if not np.any(r[:f] != 0):
                continue  # a zero cotangent adds nothing
            cell = int(r[f + nc]) % w_window
            acc[cell] += (r[f : f + nc, None] * r[None, :f]).reshape(-1)
        if tag < 2:
            out[pw] = acc
            continue
        slot = u - pw - 1
        slots.append(slot)
        for warp in range(32):
            flags[slot, warp] = int(np.any(acc[warp::32] != 0))
        partials[slot] = acc
    for pw in range(p * nw):
        for c in range(1, chunk_start[pw + 1] - chunk_start[pw]):
            slot = chunk_start[pw] + c - pw - 1
            for cell in range(w_window):
                if flags[slot, cell % 32]:
                    out[pw, cell] += partials[slot, cell]
    return out.reshape(p, nw * w_window, nc * f), slots, flags, max_slots, items


def test_split_window_combine_model():
    """Training-shaped cells at a small chunk (a hot window of many chunks,
    the pad tail's zero cotangents in one cell): every slot used once and
    below the wrapper's bound p * (m // chunk); the pad tail's later chunks
    flag nothing; the output equals the plain version within 1e-5 of its
    largest value, and bit for bit whatever order the chunks finish in."""
    rng = np.random.default_rng(21)
    p, n, f, nc, w_window, chunk = 2, 3000, 8, 4, 64, 128
    n_cells = 16 * w_window
    cell = rng.integers(0, n_cells, (p, n))
    cell[:, :700] = 3 * w_window + rng.integers(0, w_window, 700)
    cell[:, -900:] = 9 * w_window + 5
    g = rng.normal(size=(p, n, f)).astype(np.float32)
    g[:, -900:] = 0.0
    w4 = rng.uniform(size=(p, n, nc)).astype(np.float32)
    perm, offsets = table_grad.sort_by_window(T(cell.astype(np.int32)), n_cells, w_window)
    packed = table_grad.pack_payload(T(g), T(w4), T(cell.astype(np.int32)), w_window, torch.float32)
    rows = torch.stack([packed[q, perm[q].long()] for q in range(p)]).numpy()
    plain = table_grad.windowed_accumulate_plain(T(rows), offsets, f, nc, n_cells, w_window).numpy()

    n_items = len(_work_list(offsets.numpy(), chunk)[0])
    first = _model_accumulate(rows, offsets.numpy(), f, nc, w_window, chunk, range(n_items))
    out, slots, flags, max_slots, items = first
    assert len(slots) == len(set(slots)) > 10 and max(slots) < max_slots
    np.testing.assert_allclose(out, plain, rtol=0, atol=1e-5 * np.abs(plain).max())
    pad_items = [u for u, (pw, start, count, tag) in enumerate(items)
                 if tag >= 2 and not np.any(rows[pw // 16, start : start + count, :f] != 0)]
    assert pad_items and all(not flags[u - items[u][0] - 1].any() for u in pad_items)
    shuffled = _model_accumulate(rows, offsets.numpy(), f, nc, w_window, chunk, rng.permutation(n_items))[0]
    assert np.array_equal(out, shuffled)
