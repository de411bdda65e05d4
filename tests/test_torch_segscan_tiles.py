"""The index arithmetic of the tiled segmented scan (csrc/segscan.cu), as a
numpy model kept here, against the JAX package's segmented_cumsum,
compute_weights_packed and its vjp.

The CUDA kernel cannot run without a card, so this file repeats its
structure step by step at small tile sizes: a block per tile of `threads x
items` samples; segment starts from seg[i] != seg[i-1] (from the right:
seg[i] != seg[i+1]); a segmented scan of (sum, start seen) pairs, serial
over a thread's items, Kogge-Stone over a warp's thread totals, then over
the warps' totals; the carry of the segment that began before the tile by a
walk back from the tile's first sample, `threads` samples per round, each
warp reporting its partial sum and the first lane off the run; the suffix
sums of the backward by the same scan from the right with a walk forward;
an explicit 0 for ids outside [0, n_segments).  The JAX ops run their
Pallas kernel in interpret mode, as tests/test_segscan.py runs it.

Tolerances: forward 1e-6 (f32 sums of the same few terms in another order),
backward 1e-5 of the gradient's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.ops import segscan as jsegscan
from tinynerf_tpu_torch.ops import segscan

torch.set_num_threads(2)

F32 = np.float32
# (items per thread, lanes per warp, threads per block): tiles of 8 .. 64
TILES = [(2, 2, 4), (4, 2, 4), (4, 4, 8), (4, 4, 16)]
TILE_IDS = [f"tile{i * t}" for i, _, t in TILES]


class Tiled:
    """One launch of the kernel's grid over n samples."""

    def __init__(self, items, lanes, threads, seg, n_segments):
        self.items, self.lanes, self.threads = items, lanes, threads
        self.tile = items * threads
        self.seg, self.n, self.n_segments = seg, seg.size, n_segments

    def in_range(self, i):
        return self.n_segments < 0 or 0 <= i < self.n_segments

    def starts(self, i0, rev):
        """segment_starts: per item of the thread at i0."""
        nb = i0 + self.items if rev else i0 - 1
        has_nb = nb < self.n if rev else 0 <= nb < self.n
        out = []
        for u in range(self.items):
            edge = u == self.items - 1 if rev else u == 0
            i = i0 + u
            if i >= self.n:
                out.append(True)
                continue
            if edge:
                has, other = has_nb, self.seg[nb] if has_nb else 0
            else:
                o = i + 1 if rev else i - 1
                has = o < self.n
                other = self.seg[o] if has else 0
            out.append(not has or self.seg[i] != other)
        return out

    def tile_scan(self, v, start, carry, rev):
        """tile_scan: v, start are [threads][items]; returns the scanned v."""
        t_n, w_n = self.threads, self.threads // self.lanes
        order = range(self.items - 1, -1, -1) if rev else range(self.items)
        v = [list(row) for row in v]
        tv, tf = [F32(0)] * t_n, [False] * t_n
        for t in range(t_n):
            run, seen = F32(0), False
            for j in order:
                run = v[t][j] if start[t][j] else F32(run + v[t][j])
                seen |= start[t][j]
                v[t][j] = run
            tv[t], tf[t] = run, seen
        d = 1
        while d < self.lanes:  # Kogge-Stone over each warp's lanes
            ov, of = list(tv), list(tf)
            for t in range(t_n):
                lane = t % self.lanes
                if (lane + d < self.lanes) if rev else (lane >= d):
                    src = t + d if rev else t - d
                    if not tf[t]:
                        tv[t] = F32(tv[t] + ov[src])
                    tf[t] = tf[t] or of[src]
            d *= 2
        total_lane = 0 if rev else self.lanes - 1
        sh_v = [tv[w * self.lanes + total_lane] for w in range(w_n)]
        sh_f = [tf[w * self.lanes + total_lane] for w in range(w_n)]
        for t in range(t_n):
            lane, warp = t % self.lanes, t // self.lanes
            first = lane == (self.lanes - 1 if rev else 0)
            ev, ef = (F32(0), False) if first else (tv[t + 1 if rev else t - 1], tf[t + 1 if rev else t - 1])
            pv = F32(carry)
            for o in (range(w_n - 1, warp, -1) if rev else range(warp)):
                pv = sh_v[o] if sh_f[o] else F32(pv + sh_v[o])
            before = ev if ef else F32(pv + ev)
            is_open = True
            for j in order:
                is_open = is_open and not start[t][j]
                if is_open:
                    v[t][j] = F32(v[t][j] + before)
        return v

    def walk(self, ident, start_at, value, fwd):
        """walk: the sum of value(j) over the run of id `ident` next to
        `start_at`, `threads` samples per round, nearest first."""
        room = self.n - start_at if fwd else start_at
        w_n = self.threads // self.lanes
        acc, r = F32(0), 0
        while True:
            parts, stops = [], []
            for w in range(w_n):
                ok = []
                for lane in range(self.lanes):
                    d = r * self.threads + w * self.lanes + lane
                    j = start_at + d if fwd else start_at - 1 - d
                    ok.append(d < room and self.seg[j] == ident)
                stop = ok.index(False) if False in ok else -1
                part = F32(0)
                for lane in range(self.lanes):
                    if ok[lane] and (stop < 0 or lane < stop):
                        d = r * self.threads + w * self.lanes + lane
                        part = F32(part + value(start_at + d if fwd else start_at - 1 - d))
                parts.append(part)
                stops.append(stop)
            for part, stop in zip(parts, stops):
                acc = F32(acc + part)
                if stop >= 0:
                    return acc
            r += 1

    def scan(self, x, rev=False):
        """The segmented inclusive scan of x over every tile, forward with
        the walk back, or from the right with the walk forward."""
        out = np.zeros(self.n, F32)
        for base in range(0, self.n, self.tile):
            i0s = [base + t * self.items for t in range(self.threads)]
            v = [[x[i] if i < self.n else F32(0) for i in range(i0, i0 + self.items)] for i0 in i0s]
            start = [self.starts(i0, rev) for i0 in i0s]
            carry = F32(0)
            if rev:
                end = min(base + self.tile, self.n)
                if end < self.n and self.in_range(self.seg[end - 1]):
                    carry = self.walk(self.seg[end - 1], end, lambda j: x[j], True)
            elif base > 0 and self.in_range(self.seg[base]):
                carry = self.walk(self.seg[base], base, lambda j: x[j], False)
            v = self.tile_scan(v, start, carry, rev)
            for t, i0 in enumerate(i0s):
                for u in range(self.items):
                    if i0 + u < self.n:
                        out[i0 + u] = v[t][u]
        return out

    def keep(self):
        return np.array([self.in_range(i) for i in self.seg])

    def cumsum(self, x):
        return np.where(self.keep(), self.scan(x), F32(0))

    def weights(self, sig, dlt, valid, thr):
        s = sig * dlt * valid
        c = self.scan(s)
        t_before = np.exp(-(c - s), dtype=F32)
        w = t_before * (F32(1) - np.exp(-s, dtype=F32))
        return np.where(self.keep() & (valid > 0) & (t_before > thr), w, F32(0))

    def weights_bwd(self, sig, dlt, valid, w, g):
        c = self.scan(sig * dlt * valid)
        wg = w * g
        suffix = self.scan(wg, rev=True)
        grad = dlt * (np.exp(-c, dtype=F32) * g - (suffix - wg)) * valid
        return np.where(self.keep(), grad, F32(0))


def _problem(tile, seed, lead_out_of_range=False):
    """A ray that ends exactly on a tile edge (so the next one starts on
    it), empty rays, a ray over three tiles, short rays, and a pad tail of
    id n_rays whose length is no multiple of the tile or of a thread's
    items; optionally a leading run of id -1."""
    rng = np.random.default_rng(seed)
    counts = [tile, 0, 3 * tile + 5, 1, 0, 0, tile // 2, 2 * tile - 6, 1, tile, tile, 3, 0, 7]
    n_rays = len(counts)
    lead = 5 if lead_out_of_range else 0
    if lead:
        counts[0] -= lead  # the first ray still ends on the tile edge
    n_valid = sum(counts)
    pad = tile + 3
    seg = np.concatenate([np.full(lead, -1), np.repeat(np.arange(n_rays), counts), np.full(pad, n_rays)]).astype(np.int32)
    n = seg.size
    assert n % 4 != 0  # the last thread loads its items one by one
    valid = ((seg >= 0) & (seg < n_rays)).astype(F32)
    valid[lead + 2] = 0.0  # a masked sample inside a ray
    sig = rng.uniform(0.0, 8.0, n).astype(F32)
    dlt = rng.uniform(0.01, 0.1, n).astype(F32)
    g = rng.normal(size=n).astype(F32)
    assert n_valid + lead + pad == n
    return sig, dlt, valid, seg, g, n_rays


@pytest.mark.parametrize("tile", TILES, ids=TILE_IDS)
@pytest.mark.parametrize("lead", [False, True], ids=["pad_tail", "ids_below_and_above"])
def test_tiled_cumsum_matches_jax(tile, lead):
    sig, _, _, seg, _, n_rays = _problem(tile[0] * tile[2], 0, lead)
    ref = np.asarray(jsegscan.segmented_cumsum(jnp.asarray(sig), jnp.asarray(seg), interpret=True))
    # every id counts
    out = Tiled(*tile, seg, -1).cumsum(sig)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    # ids outside [0, n_rays) come out exactly 0
    out = Tiled(*tile, seg, n_rays).cumsum(sig)
    inside = (seg >= 0) & (seg < n_rays)
    np.testing.assert_allclose(out[inside], ref[inside], rtol=1e-6, atol=1e-6)
    assert np.all(out[~inside] == 0.0)
    # and the port's plain version says the same
    plain = segscan.segmented_cumsum(torch.from_numpy(sig), torch.from_numpy(seg), n_segments=n_rays).numpy()
    np.testing.assert_allclose(out, plain, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tile", TILES, ids=TILE_IDS)
def test_tiled_reverse_scan_matches_jax(tile):
    sig, _, _, seg, _, _ = _problem(tile[0] * tile[2], 1)
    ref = np.asarray(jsegscan.segmented_cumsum(jnp.asarray(sig), jnp.asarray(seg), reverse=True, interpret=True))
    out = Tiled(*tile, seg, -1).scan(sig, rev=True)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tile", TILES, ids=TILE_IDS)
@pytest.mark.parametrize("thr", [0.0, 1e-4])
def test_tiled_weights_match_jax(tile, thr):
    sig, dlt, valid, seg, _, n_rays = _problem(tile[0] * tile[2], 2)
    ref = np.asarray(jsegscan.compute_weights_packed(
        jnp.asarray(sig), jnp.asarray(dlt), jnp.asarray(valid), jnp.asarray(seg), thr, True))
    out = Tiled(*tile, seg, n_rays).weights(sig, dlt, valid, F32(thr))
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert np.all(out[seg == n_rays] == 0.0)
    plain = segscan.compute_weights_packed(*(torch.from_numpy(a) for a in (sig, dlt, valid, seg)), thr, n_rays)
    np.testing.assert_allclose(out, plain.numpy(), atol=1e-6)


@pytest.mark.parametrize("tile", TILES, ids=TILE_IDS)
@pytest.mark.parametrize("lead", [False, True], ids=["pad_tail", "ids_below_and_above"])
def test_tiled_weights_backward_matches_jax_vjp(tile, lead):
    sig, dlt, valid, seg, g, n_rays = _problem(tile[0] * tile[2], 3, lead)
    jargs = [jnp.asarray(a) for a in (dlt, valid, seg)]
    w, vjp = jax.vjp(lambda s: jsegscan.compute_weights_packed(s, *jargs, 1e-4, True), jnp.asarray(sig))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    w = np.array(w)
    out = Tiled(*tile, seg, n_rays).weights_bwd(sig, dlt, valid, w, g)
    tol = 1e-5 * np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=tol, rtol=0)
    assert np.all(out[(seg < 0) | (seg >= n_rays)] == 0.0)
    t = torch.from_numpy
    plain = segscan.weights_packed_bwd(t(sig), t(dlt), t(valid), t(seg), t(w), t(g), n_rays)
    np.testing.assert_allclose(out, plain.numpy(), atol=tol, rtol=0)


def test_tiled_scan_one_ray_filling_the_buffer_and_all_empty():
    """One segment over every tile (each tile walks back to the head), and
    a buffer of pads only (no tile walks anywhere)."""
    rng = np.random.default_rng(4)
    n = 5 * 32 + 7
    x = rng.uniform(0, 1, n).astype(F32)
    seg = np.zeros(n, np.int32)
    out = Tiled(4, 4, 8, seg, 1).cumsum(x)
    np.testing.assert_allclose(out, np.cumsum(x.astype(np.float64)), rtol=1e-6)
    rev = Tiled(4, 4, 8, seg, 1).scan(x, rev=True)
    np.testing.assert_allclose(rev, np.cumsum(x[::-1].astype(np.float64))[::-1], rtol=1e-6)
    pads = Tiled(4, 4, 8, np.full(n, 9, np.int32), 9)
    pads.walk = None  # a walk would raise
    assert np.all(pads.cumsum(x) == 0.0)


def test_cuda_path_drops_the_boundary_search():
    """The wrappers hand the ids to the kernel: no segment starts are
    computed, and the autograd function saves none."""
    assert not hasattr(segscan, "segment_starts")
    sig, dlt, valid, seg, g, n_rays = _problem(16, 5)
    s = torch.from_numpy(sig).requires_grad_()
    w = segscan.compute_weights_packed(s, *(torch.from_numpy(a) for a in (dlt, valid, seg)), 1e-4, n_rays)
    assert len(w.grad_fn.saved_tensors) == 5
    w.backward(torch.from_numpy(g))
    assert np.all(s.grad.numpy()[seg == n_rays] == 0.0)
