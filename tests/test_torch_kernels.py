"""The hand-written CUDA kernels against their plain PyTorch versions, and
the wrappers' device dispatch: the packed and dense weights and their
backwards, the per-ray segment sum, the radix sort (keys, and key-value
pairs), the windowed table-gradient accumulation and Cobafa's oct
gradient through it, the oct and quad cell-pack builds and both skip
marches (AABB and unbounded); and that a training step and a served chunk
repeat themselves bit for bit.

The kernel tests are marked `cuda`: they need a card and skip without one
(a CUDA kernel has no CPU mode).  This file imports neither jax nor the JAX package, so it runs on
a machine with a GPU and no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

(`--noconftest`: tests/conftest.py sets up jax for the JAX suite).  The
plain versions are themselves held against the JAX package in
test_torch_ops.py and test_torch_train_ops.py.  Tolerances: weights atol
1e-5, cumsums rtol 1e-5 / atol 1e-4 (f32 scans in another summation
order); weight gradients 1e-5 of their largest magnitude (f32 sums of up
to 400 terms in another order); sorts bit-equal (the keys are the same
multiset); accumulated table gradients and per-ray sums 1e-5 of their
largest magnitude (f32 sums in another order); the
oct and quad builds bit-equal (a relayout that rounds each value once, to
nearest even in both); the skip marches' k_idx and complete equal (each
kernel repeats its plain version's f32 operations, each rounded once).
"""

import numpy as np
import pytest
import torch

from tinynerf_tpu_torch.core import ContractionMip360, RayMarcherAABB, RayMarcherUnbounded, skipmarch
from tinynerf_tpu_torch.ops import bitonic, cuda_lib, interp, octbuild, segscan, table_grad, weights, weights_dense

torch.set_num_threads(2)

T = torch.from_numpy


def _packed(seed, n_rays=300, max_count=100, pad=700, p_empty=0.2):
    """Ray-major packed buffer (< 30k samples): irregular counts, empty
    rays, segments longer than a 128-lane row, and a pad tail of id n_rays."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, max_count + 1, n_rays) * (rng.random(n_rays) > p_empty)
    n_valid = int(counts.sum())
    cap = n_valid + pad
    seg = np.full(cap, n_rays, np.int32)
    seg[:n_valid] = np.repeat(np.arange(n_rays), counts)
    valid = np.zeros(cap, np.float32)
    valid[:n_valid] = 1.0
    sig = rng.uniform(0.0, 8.0, cap).astype(np.float32) * valid
    dlt = rng.uniform(0.01, 0.1, cap).astype(np.float32)
    return sig, dlt, valid, seg, n_rays


def test_kernel_wrappers_raise_off_cpu_and_cuda():
    """A tensor on another device is refused; nothing falls back."""
    m = torch.empty(8, device="meta")
    mi = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        segscan.compute_weights_packed(m, m, m, mi)
    with pytest.raises(ValueError):
        segscan.weights_packed_bwd(m, m, m, mi, m, m)
    with pytest.raises(ValueError):
        weights_dense.compute_weights_dense(m[None], m[None], m[None])
    with pytest.raises(ValueError):
        weights_dense.weights_dense_bwd(m[None], m[None], m[None], m[None], m[None])
    with pytest.raises(ValueError):
        bitonic.sort_i32(mi)
    with pytest.raises(ValueError):
        table_grad.windowed_accumulate(
            torch.empty(1, 8, 128, device="meta"), torch.empty(1, 2, dtype=torch.int32), 4, 4, 256, 256)
    with pytest.raises(ValueError):
        octbuild.build_oct(torch.empty(4, 4, 4, 2, device="meta"))
    with pytest.raises(ValueError):
        octbuild.build_quad(torch.empty(4, 4, 2, device="meta"))
    with pytest.raises(ValueError):
        skipmarch.skip_march_unbounded(m.reshape(-1)[:6].reshape(2, 3), m.reshape(-1)[:6].reshape(2, 3),
                                       RayMarcherUnbounded(), ContractionMip360(),
                                       torch.empty(4, 4, 4, dtype=torch.int32, device="meta"), None, 8)
    with pytest.raises(ValueError):
        cuda_lib.check_cuda_inputs("x", torch.float32, (4,), torch.zeros(4))


def test_packed_plain_matches_dense_plain():
    """The two plain versions agree: packed weights of a ray-major buffer
    are the dense weights of the same samples (what the renderer relies on
    when its fallback mixes the two paths)."""
    rng = np.random.default_rng(8)
    r, s = 24, 50
    sig = rng.uniform(0, 8, (r, s)).astype(np.float32)
    dlt = rng.uniform(0.01, 0.1, (r, s)).astype(np.float32)
    msk = rng.random((r, s)) > 0.35
    msk[3] = False
    idx = np.nonzero(msk.reshape(-1))[0]
    cap = idx.size + 13
    sig_c, dlt_c = np.zeros(cap, np.float32), np.ones(cap, np.float32)
    val_c, seg_c = np.zeros(cap, np.float32), np.full(cap, r, np.int32)
    sig_c[: idx.size], dlt_c[: idx.size] = sig.reshape(-1)[idx], dlt.reshape(-1)[idx]
    val_c[: idx.size], seg_c[: idx.size] = 1.0, idx // s
    for thr in (0.0, 1e-4, 1e-2):
        dense = weights_dense.compute_weights_dense(T(sig), T(dlt), T(msk.astype(np.float32)), thr)
        packed = segscan.compute_weights_packed(T(sig_c), T(dlt_c), T(val_c), T(seg_c), thr, n_segments=r)
        np.testing.assert_allclose(packed.numpy()[: idx.size], dense.numpy().reshape(-1)[idx], atol=1e-6)
        assert np.all(packed.numpy()[idx.size:] == 0.0)


@pytest.mark.parametrize("thr", [0.0, 1e-4])
def test_packed_backward_plain_matches_dense_backward_plain(thr):
    """The packed gradient of a ray-major buffer is the dense gradient of the
    same samples; the pad tail gets 0 (plain versions, CPU)."""
    rng = np.random.default_rng(9)
    r, s = 24, 50
    sig = rng.uniform(0, 8, (r, s)).astype(np.float32)
    dlt = rng.uniform(0.01, 0.1, (r, s)).astype(np.float32)
    msk = rng.random((r, s)) > 0.35
    g = rng.normal(size=(r, s)).astype(np.float32)
    idx = np.nonzero(msk.reshape(-1))[0]
    cap = idx.size + 13
    sig_c, dlt_c = np.zeros(cap, np.float32), np.ones(cap, np.float32)
    val_c, seg_c = np.zeros(cap, np.float32), np.full(cap, r, np.int32)
    g_c = rng.normal(size=cap).astype(np.float32)
    sig_c[: idx.size], dlt_c[: idx.size] = sig.reshape(-1)[idx], dlt.reshape(-1)[idx]
    val_c[: idx.size], seg_c[: idx.size] = 1.0, idx // s
    g_c[: idx.size] = g.reshape(-1)[idx]
    sd = T(sig).requires_grad_()
    weights_dense.compute_weights_dense(sd, T(dlt), T(msk.astype(np.float32)), thr).backward(T(g))
    sp = T(sig_c).requires_grad_()
    segscan.compute_weights_packed(sp, T(dlt_c), T(val_c), T(seg_c), thr, n_segments=r).backward(T(g_c))
    np.testing.assert_allclose(sp.grad.numpy()[: idx.size], sd.grad.numpy().reshape(-1)[idx], atol=1e-6)
    assert np.all(sp.grad.numpy()[idx.size:] == 0.0)


def test_dense_backward_plain_matches_autograd():
    """The closed form is the derivative: at threshold 0 (no early
    termination) it equals autograd through the forward's value."""
    rng = np.random.default_rng(10)
    sig = T(rng.uniform(0, 8, (16, 40)).astype(np.float32))
    dlt = T(rng.uniform(0.01, 0.1, (16, 40)).astype(np.float32))
    msk = T((rng.random((16, 40)) > 0.3).astype(np.float32))
    g = T(rng.normal(size=(16, 40)).astype(np.float32))
    a = sig.clone().requires_grad_()
    weights.compute_weights_value(a, dlt, msk, 0.0).backward(g)
    b = sig.clone().requires_grad_()
    weights.compute_weights(b, dlt, msk, 0.0).backward(g)
    np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), atol=1e-5)


def test_c_entry_points_declared_in_sources():
    """Every C entry point the ctypes binding declares is defined in csrc/,
    and the build targets sm_90a (checked without a toolkit)."""
    src = "".join(p.read_text() for p in cuda_lib.CSRC.glob("*.cu"))
    for name in list(cuda_lib._SIGNATURES) + ["tn_error_string"]:
        assert f" {name}(" in src, name
    assert "arch=compute_90a,code=sm_90a" in cuda_lib.NVCC_FLAGS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.0, 1e-4])
def test_packed_weights_kernel_matches_plain(cuda_device, thr):
    sig, dlt, valid, seg, n_rays = _packed(6)
    args = [T(a).to(cuda_device) for a in (sig, dlt, valid, seg)]
    for n_seg in (None, n_rays):
        before = segscan.compute_weights_packed.launches
        out = segscan.compute_weights_packed(*args, thr, n_segments=n_seg)
        assert segscan.compute_weights_packed.launches == before + 1
        ref = segscan.compute_weights_packed_plain(*args, thr, n_segments=n_seg)
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5)
    x = args[0].clone()
    np.testing.assert_allclose(
        segscan.segmented_cumsum(x, args[3]).cpu().numpy(),
        segscan.segmented_cumsum_plain(x, args[3]).cpu().numpy(), rtol=1e-5, atol=1e-4,
    )


SCAN_TILE = 1024  # csrc/segscan.cu: kThreads x kItems samples per block


def _ragged(seed, counts, pad, n_rays_extra=0):
    """A packed buffer of rays of the given lengths, then `pad` samples of
    id n_rays; every array and a cotangent."""
    rng = np.random.default_rng(seed)
    n_rays = len(counts) + n_rays_extra
    n_valid = int(np.sum(counts))
    seg = np.concatenate([np.repeat(np.arange(len(counts)), counts), np.full(pad, n_rays)]).astype(np.int32)
    valid = (seg < n_rays).astype(np.float32)
    sig = rng.uniform(0.0, 8.0, n_valid + pad).astype(np.float32)
    dlt = rng.uniform(0.01, 0.1, n_valid + pad).astype(np.float32)
    g = rng.normal(size=n_valid + pad).astype(np.float32)
    return sig, dlt, valid, seg, g, n_rays


def _scan_cases():
    t = SCAN_TILE
    rng = np.random.default_rng(26)
    return {
        # rays that end one short of, on and one past a tile edge, a ray over
        # three tiles, empty rays in between, a pad tail of ragged length
        "around_tile_edges": _ragged(27, [t - 1, 1, 0, t, 0, 0, t + 1, 3 * t + 5, 2, t - 3, 1], t + 3),
        # n no multiple of 4: the last thread loads and stores one by one
        "ragged_tail": _ragged(28, [5, 0, 300, 2 * t + 1], 2),
        "one_ray_fills_the_buffer": _ragged(29, [5 * t + 7], 0),
        "all_rays_empty": _ragged(30, [0] * 50, 3 * t + 1),
        "no_pad": _ragged(31, list(rng.integers(0, 9, 3000)), 0),
        "n_is_zero": _ragged(32, [], 0, n_rays_extra=4),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.0, 1e-4])
@pytest.mark.parametrize("case", ["around_tile_edges", "ragged_tail", "one_ray_fills_the_buffer", "all_rays_empty",
                                  "no_pad", "n_is_zero"])
def test_packed_weights_kernels_on_ragged_buffers(cuda_device, thr, case):
    """Forward, backward and the plain cumsum of the tiled kernels against
    their plain versions; the pad tail exactly 0; one launch per call, none
    for an empty buffer; a buffer that starts off a 16-byte boundary."""
    sig, dlt, valid, seg, g, n_rays = _scan_cases()[case]
    a = [T(x).to(cuda_device) for x in (sig, dlt, valid, seg)]
    g = T(g).to(cuda_device)
    n = sig.size
    counts = [f.launches for f in (segscan.compute_weights_packed, segscan.weights_packed_bwd, segscan.segmented_cumsum)]
    _poison_next_empty(a[0])
    w = segscan.compute_weights_packed(*a, thr, n_segments=n_rays)
    w_ref = segscan.compute_weights_packed_plain(*a, thr, n_segments=n_rays)
    np.testing.assert_allclose(w.cpu().numpy(), w_ref.cpu().numpy(), atol=1e-5)
    _poison_next_empty(a[0])
    grad = segscan.weights_packed_bwd(*a, w, g, n_rays)
    ref = segscan.weights_packed_bwd_plain(*a, w, g, n_rays)
    torch.testing.assert_close(grad, ref, atol=_grad_tol(ref) if n else 0.0, rtol=0)
    pad = a[3] >= n_rays
    assert bool((w[pad] == 0).all()) and bool((grad[pad] == 0).all())
    for n_seg in (None, n_rays):
        _poison_next_empty(a[0])
        c = segscan.segmented_cumsum(a[0], a[3], n_seg)
        c_ref = segscan.segmented_cumsum_plain(a[0], a[3], n_seg)
        np.testing.assert_allclose(c.cpu().numpy(), c_ref.cpu().numpy(), rtol=1e-5, atol=1e-4)
    after = [f.launches for f in (segscan.compute_weights_packed, segscan.weights_packed_bwd, segscan.segmented_cumsum)]
    assert [x - y for x, y in zip(after, counts)] == ([1, 1, 2] if n else [0, 0, 0])
    if n > 8:  # views one sample in: contiguous, but 4 bytes off the 16-byte boundary
        b = [x[1:] for x in a]
        w1 = segscan.compute_weights_packed(*b, thr, n_segments=n_rays)
        np.testing.assert_allclose(
            w1.cpu().numpy(), segscan.compute_weights_packed_plain(*b, thr, n_segments=n_rays).cpu().numpy(), atol=1e-5)
        g1 = segscan.weights_packed_bwd(*b, w1, g[1:], n_rays)
        ref1 = segscan.weights_packed_bwd_plain(*b, w1, g[1:], n_rays)
        torch.testing.assert_close(g1, ref1, atol=_grad_tol(ref1), rtol=0)


@pytest.mark.cuda
def test_segmented_cumsum_kernel_any_contiguous_ids(cuda_device):
    """Ids that do not ascend, negative ids, an id that comes back in a
    later run, and a run longer than several tiles: sums stay inside each
    run, also beside a run of large values."""
    rng = np.random.default_rng(33)
    lengths = [1, 7, 3 * SCAN_TILE + 130, 5, 300, 2, SCAN_TILE, 9]
    ids = [5, -1, 9, 0, 3, 7, 5, 9]
    seg = np.concatenate([np.full(n, i) for i, n in zip(ids, lengths)]).astype(np.int32)
    x = rng.uniform(0, 1, seg.size).astype(np.float32)
    x[8 : 8 + lengths[2]] += 1e4
    out = segscan.segmented_cumsum(T(x).to(cuda_device), T(seg).to(cuda_device)).cpu().numpy()
    start = 0
    for n in lengths:
        sl = slice(start, start + n)
        np.testing.assert_allclose(out[sl], np.cumsum(x[sl].astype(np.float64)), rtol=1e-5)
        start += n


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.0, 1e-4])
def test_dense_weights_kernel_matches_plain(cuda_device, thr):
    rng = np.random.default_rng(7)
    for r, s in ((3, 1), (37, 33), (2048, 400)):  # ragged chunk tails, one sample
        a = [T(x).to(cuda_device) for x in (
            rng.uniform(0, 8, (r, s)).astype(np.float32),
            rng.uniform(0.01, 0.1, (r, s)).astype(np.float32),
            (rng.random((r, s)) > 0.3).astype(np.float32),
        )]
        out = weights_dense.compute_weights_dense(*a, thr)
        ref = weights_dense.compute_weights_dense_plain(*a, thr)
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5)


def _grad_tol(ref: torch.Tensor) -> float:
    return 1e-5 * max(float(ref.abs().max()), 1e-30)


@pytest.mark.cuda
def test_packed_weights_backward_kernel_matches_plain(cuda_device):
    """Ragged rays (longer than a warp, empty, a pad tail) and the training
    shape: 2048 rays, cap 819,200."""
    cases = [_packed(11)]
    rng = np.random.default_rng(12)
    counts = rng.integers(0, 401, 2048)
    counts = (counts * (819_200 / counts.sum() * 0.95)).astype(np.int64)
    n_valid = int(counts.sum())
    seg = np.full(819_200, 2048, np.int32)
    seg[:n_valid] = np.repeat(np.arange(2048), counts)
    valid = (seg < 2048).astype(np.float32)
    cases.append((rng.uniform(0, 50, 819_200).astype(np.float32) * valid,
                  np.full(819_200, np.float32(5.196152 / 400)), valid, seg, 2048))
    for sig, dlt, valid, seg, n_rays in cases:
        a = [T(x).to(cuda_device) for x in (sig, dlt, valid, seg)]
        w = segscan.compute_weights_packed(*a, 1e-4, n_segments=n_rays)
        g = torch.randn(sig.size, device=cuda_device)
        before = segscan.weights_packed_bwd.launches
        out = segscan.weights_packed_bwd(*a, w, g, n_rays)
        assert segscan.weights_packed_bwd.launches == before + 1
        ref = segscan.weights_packed_bwd_plain(*a, w, g, n_rays)
        torch.testing.assert_close(out, ref, atol=_grad_tol(ref), rtol=0)
        # through autograd, the kernel runs as the gradient
        s = a[0].clone().requires_grad_()
        segscan.compute_weights_packed(s, *a[1:], 1e-4, n_segments=n_rays).backward(g)
        torch.testing.assert_close(s.grad, ref, atol=_grad_tol(ref), rtol=0)


@pytest.mark.cuda
def test_dense_weights_backward_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(13)
    for r, s in ((3, 1), (37, 33), (2048, 400)):
        a = [T(x).to(cuda_device) for x in (
            rng.uniform(0, 8, (r, s)).astype(np.float32),
            rng.uniform(0.01, 0.1, (r, s)).astype(np.float32),
            (rng.random((r, s)) > 0.3).astype(np.float32),
        )]
        g = torch.randn(r, s, device=cuda_device)
        w = weights_dense.compute_weights_dense(*a, 1e-4)
        before = weights_dense.weights_dense_bwd.launches
        out = weights_dense.weights_dense_bwd(*a, w, g)
        assert weights_dense.weights_dense_bwd.launches == before + 1
        ref = weights.compute_weights_bwd(*a, w, g)
        torch.testing.assert_close(out, ref, atol=_grad_tol(ref), rtol=0)


@pytest.mark.cuda
def test_dense_weights_backward_kernel_unbounded_deltas(cuda_device):
    """The unbounded marcher's steps (from ~0.01 near the camera to
    hundreds of units in the disparity tail) and densities that end most
    rays early: past a ray's last weighted sample incl(w g) - total(w g)
    must be exactly 0 (the total taken from the same scan, as the TPU
    kernel takes it), or the tail's deltas multiply a rounding residue far
    past 1e-5 of the largest gradient."""
    rng = np.random.default_rng(29)
    r, s = 2048, 400
    t, deltas = RayMarcherUnbounded(n_samples=s, near=0.1, uniform_range=13.6)._grid()
    a = [T(x).to(cuda_device) for x in (
        rng.uniform(0, 30, (r, s)).astype(np.float32),
        np.broadcast_to(deltas, (r, s)).copy(),
        (rng.random((r, s)) > 0.1).astype(np.float32),
    )]
    g = torch.randn(r, s, device=cuda_device)
    w = weights_dense.compute_weights_dense(*a, 1e-4)
    out = weights_dense.weights_dense_bwd(*a, w, g)
    ref = weights.compute_weights_bwd(*a, w, g)
    assert bool((w[:, -1] == 0).all())  # every ray ends early
    torch.testing.assert_close(out, ref, atol=_grad_tol(ref), rtol=0)


# lengths around the sort kernel's 4096-key tile and 32-key warp rounds
SORT_SHAPES = ((1,), (255,), (257,), (5000,), (4095,), (4096,), (4097,), (3, 1000), (2, 2049), (4, 4096),
               (3, 819_200))


@pytest.mark.cuda
def test_sort_kernel_bit_equal_to_torch_sort(cuda_device):
    """Any length (ragged last tiles), batched rows, negative and repeated
    keys, and the training shape [3, 819,200], over all 32 bits."""
    rng = np.random.default_rng(14)
    for shape in SORT_SHAPES:
        keys = rng.integers(-(2**31), 2**31 - 1, shape, dtype=np.int64).astype(np.int32)
        keys.reshape(-1)[::7] = 3
        k = T(keys).to(cuda_device)
        before = bitonic.sort_i32.launches
        out = bitonic.sort_i32(k)
        torch.cuda.synchronize()
        assert bitonic.sort_i32.launches == before + 1
        assert torch.equal(out, torch.sort(k, dim=-1).values), shape
        assert torch.equal(k.cpu(), T(keys)), shape  # the input is only read


@pytest.mark.cuda
def test_sort_kernel_bit_range(cuda_device):
    """The call the training path makes: packed keys (window << idx_bits) |
    iota sorted by the window bits alone equal torch.sort's; and over random
    keys the bit-range sort is stable (equal to the plain version), with one
    pass, several, a ragged last digit, and the sign bit."""
    rng = np.random.default_rng(24)
    for shape in SORT_SHAPES:
        idx_bits = bitonic._bits(shape[-1])
        for n_buckets in (1024, 3):
            bucket = T(rng.integers(0, n_buckets, shape).astype(np.int32)).to(cuda_device)
            keys = bitonic.pack_keys(bucket, idx_bits)
            out = bitonic.sort_i32(keys, begin_bit=idx_bits, end_bit=idx_bits + bitonic._bits(n_buckets))
            torch.cuda.synchronize()
            assert torch.equal(out, torch.sort(keys, dim=-1).values), (shape, n_buckets)
        keys = T(rng.integers(-(2**31), 2**31 - 1, shape, dtype=np.int64).astype(np.int32)).to(cuda_device)
        for begin_bit, end_bit in ((0, 3), (4, 12), (7, 20), (20, 32), (31, 32), (9, 9)):
            out = bitonic.sort_i32(keys, begin_bit=begin_bit, end_bit=end_bit)
            torch.cuda.synchronize()
            assert torch.equal(out, bitonic.sort_i32_plain(keys, begin_bit, end_bit)), (shape, begin_bit, end_bit)


def _accum_case(rng, p, n, f, n_cells, skew=False, nc=4):
    g = rng.normal(size=(p, n, f)).astype(np.float32)
    w4 = torch.from_numpy(rng.uniform(size=(p, n, nc)).astype(np.float32))
    cell = rng.integers(0, n_cells, size=(p, n)).astype(np.int32)
    if skew:
        # every sample in one cell of window 2 (the other windows empty), a
        # window long enough to be split over several blocks, and half the
        # samples with a zero cotangent (the renderer's pad tail)
        cell[:] = 2 * 256 + 5
        g[:, ::2] = 0.0
    return torch.from_numpy(g), w4, torch.from_numpy(cell)


def _poison_next_empty(like: torch.Tensor) -> None:
    """The kernel's output is `torch.empty`: fill the block the allocator
    hands out next for this size with NaN, so an element the kernel does not
    write cannot pass for a sum left there by an earlier call."""
    torch.full_like(like, float("nan"))


@pytest.mark.cuda
@pytest.mark.parametrize("payload", [torch.float32, torch.bfloat16])
def test_windowed_accumulate_kernel_matches_plain(cuda_device, payload):
    """Kernel vs plain decode + index_add_ on the same sorted payload, and the
    whole sorted pipeline vs the scatter reference; ragged sizes, empty and
    skewed windows, row widths that are no multiple of 4 or 8 values (a g of
    12 or 20 bytes in bf16, the scalar store path), one projection, a table of
    one window (whose samples span many staging stages and several chunks),
    windows of exactly one chunk and one sample more, and the training shape
    (3 x 819,200 samples into 262,144 cells x 384), by windows of 256 cells
    (a tile split over blocks) and of 64."""
    rng = np.random.default_rng(15)
    chunk = table_grad.ACCUM_CHUNK
    cases = [(2, 1500, 8, 600, False), (1, 5000, 4, 1000, True), (1, 3000, 6, 256, False),
             (1, 40, 10, 200, False), (2, chunk, 12, 256, False), (1, chunk + 1, 5, 256, False),
             (1, 17, 96, 256, False), (3, 819_200, 96, 262_144, False)]
    for p, n, f, n_cells, skew in cases:
        g, w4, cell = (x.to(cuda_device) for x in _accum_case(rng, p, n, f, n_cells, skew))
        # the JAX package's window, and the one the trainer picks on the card
        # (64 cells at 96 features: the tile fits one block, keys of 32 bits)
        for w_window in sorted({256, table_grad.default_window(cuda_device, n_cells, n, 4 * f)}):
            n_cells_pad = -(-n_cells // w_window) * w_window
            perm, offsets = table_grad.sort_by_window(cell, n_cells_pad, w_window)
            for pi in range(p):  # the partition groups every window's samples
                c = cell[pi][perm[pi].long()] // w_window
                assert bool((c[1:] >= c[:-1]).all())
            out = table_grad.table_grad_sorted(g, w4, cell, n_cells, w_window, payload)
            g_ref = g.to(payload).float()  # the bf16 payload rounds g only
            ref = table_grad.windowed_accumulate_ref(g_ref, w4, cell, n_cells)
            # the bf16 payload's weights are a (hi, lo) pair, ~2^-16 relative
            tol = _grad_tol(ref) if payload == torch.float32 else 3e-5 * float(ref.abs().max())
            torch.testing.assert_close(out, ref, atol=tol, rtol=0)
            if skew:
                assert float(out[:, : 2 * 256].abs().max()) == 0.0  # cells with no samples are 0
            # kernel vs plain on one payload
            gidx = perm.long() + (torch.arange(p, device=cuda_device) * n)[:, None]
            rows = table_grad.pack_payload(g, w4, cell, w_window, payload)
            sorted_rows = rows.reshape(p * n, -1)[gidx.reshape(-1)].reshape(p, n, -1)
            plain = table_grad.windowed_accumulate_plain(sorted_rows, offsets, f, 4, n_cells_pad, w_window)
            empty = torch.stack([torch.bincount(c, minlength=n_cells_pad) == 0 for c in cell])
            _poison_next_empty(plain)
            before = table_grad.windowed_accumulate.launches
            k = table_grad.windowed_accumulate(sorted_rows, offsets, f, 4, n_cells_pad, w_window)
            torch.cuda.synchronize()
            assert table_grad.windowed_accumulate.launches == before + 1
            torch.testing.assert_close(k, plain, atol=_grad_tol(plain), rtol=0)
            assert bool((k[empty] == 0).all())  # cells without samples are exactly 0


@pytest.mark.cuda
@pytest.mark.parametrize("payload", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nc,f,w_window", [(1, 16, 256), (8, 8, 64), (3, 7, 128), (4, 200, 256), (3, 150, 256), (8, 40, 1),
                                          (4, 96, 64), (3, 7, 64), (1, 16, 32), (2, 50, 16), (4, 97, 64), (4, 96, 8)])
def test_windowed_accumulate_kernel_layouts(cuda_device, payload, nc, f, w_window):
    """Other corner counts, windows and widths than training's: one corner,
    eight, three, a row too wide for one block's shared memory (the window
    then splits into corners and bands of cells: 16 blocks per chunk),
    windows of one cell; and windows of up to 64 cells x up to 4 corners x up
    to 96 values, which the kernel that sums in registers takes (97 values:
    the tile kernel again)."""
    rng = np.random.default_rng(25)
    p, n, n_cells = 2, 3000, 4 * max(w_window, 8)
    g, w, cell = (x.to(cuda_device) for x in _accum_case(rng, p, n, f, n_cells, nc=nc))
    g[:, ::5] = 0.0
    perm, offsets = table_grad.sort_by_window(cell, n_cells, w_window)
    gidx = perm.long() + (torch.arange(p, device=cuda_device) * n)[:, None]
    rows = table_grad.pack_payload(g, w, cell, w_window, payload)
    sorted_rows = rows.reshape(p * n, -1)[gidx.reshape(-1)].reshape(p, n, -1)
    plain = table_grad.windowed_accumulate_plain(sorted_rows, offsets, f, nc, n_cells, w_window)
    _poison_next_empty(plain)
    k = table_grad.windowed_accumulate(sorted_rows, offsets, f, nc, n_cells, w_window)
    torch.cuda.synchronize()
    torch.testing.assert_close(k, plain, atol=_grad_tol(plain), rtol=0)



@pytest.mark.cuda
@pytest.mark.parametrize("payload", [torch.float32, torch.bfloat16])
def test_windowed_accumulate_split_windows_repeat_bit_for_bit(cuda_device, payload):
    """Training-shaped cells (a hot window of many chunks, a pad tail of
    zero cotangents in one cell, whose chunks flag nothing): the register
    kernel's output, with its split windows' later chunks added in item
    order, bit-equal over DET_RUNS calls, and within the kernel's tolerance
    of its plain version."""
    rng = np.random.default_rng(31)
    p, n, f, nc, n_cells, w_window = 2, 200_000, 96, 4, 64 * 1024, 64
    cell = rng.integers(0, n_cells, (p, n))
    cell[:, : 30_000] = 7 * w_window + rng.integers(0, w_window, 30_000)  # a hot window
    cell[:, -60_000:] = 11 * w_window + 3  # the pad tail: one cell
    g = rng.normal(size=(p, n, f)).astype(np.float32)
    g[:, -60_000:] = 0.0
    cell, g = T(cell.astype(np.int32)).to(cuda_device), T(g).to(cuda_device)
    w4 = torch.rand(p, n, nc, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(3))
    perm, offsets = table_grad.sort_by_window(cell, n_cells, w_window)
    gidx = (perm.long() + (torch.arange(p, device=cuda_device) * n)[:, None]).reshape(-1)
    rows = table_grad.pack_payload(g, w4, cell, w_window, payload).reshape(p * n, -1)[gidx].reshape(p, n, -1)
    counts = offsets[:, 1:] - offsets[:, :-1]
    assert int((counts > table_grad.ACCUM_CHUNK).sum()) >= 2 * p
    outs = [table_grad.windowed_accumulate(rows, offsets, f, nc, n_cells, w_window) for _ in range(DET_RUNS)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    plain = table_grad.windowed_accumulate_plain(rows, offsets, f, nc, n_cells, w_window)
    torch.testing.assert_close(outs[0], plain, atol=_grad_tol(plain), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["small", "tile_edges", "one_ray_fills_the_buffer", "training", "three_columns"])
def test_segment_sum_kernel_matches_plain(cuda_device, case):
    """The per-ray sum: kernel vs plain `index_add` on packed buffers (runs
    around tile edges, a run longer than many tiles, the pad tail's id
    dropped, empty rays 0), 1e-5 of the largest sum (f32 sums in another
    order); DET_RUNS calls bit-equal; its gradient (a gather) equal."""
    rng = np.random.default_rng(37)
    if case == "small":
        _, _, _, seg, n_rays = _packed(1)
    elif case == "tile_edges":
        _, _, _, seg, _, n_rays = _ragged(2, [SCAN_TILE - 1, 2, SCAN_TILE, 1, 0, 3 * SCAN_TILE + 5, 7], 900)
    elif case == "one_ray_fills_the_buffer":
        seg, n_rays = np.zeros(50_000, np.int32), 1
    else:
        counts = rng.integers(0, 401, 4096)
        counts = (counts * (0.937 * 819_200 / counts.sum())).astype(np.int64)
        seg = np.full(819_200, 4096, np.int32)
        seg[: counts.sum()] = np.repeat(np.arange(4096), counts)
        n_rays = 4096
    c = 3 if case == "three_columns" else 4
    if case == "three_columns":
        _, _, _, seg, n_rays = _packed(5)
    x = T(rng.uniform(0.0, 1.0, (seg.size, c)).astype(np.float32)).to(cuda_device)
    seg_t = T(seg).to(cuda_device)
    before = segscan.segment_sum.launches
    outs = [segscan.segment_sum(x, seg_t, n_rays) for _ in range(DET_RUNS)]
    torch.cuda.synchronize()
    assert segscan.segment_sum.launches == before + DET_RUNS
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    plain = segscan.segment_sum_plain(x, seg_t, n_rays)
    assert outs[0].shape == (n_rays, c)
    torch.testing.assert_close(outs[0], plain, atol=_grad_tol(plain), rtol=0)
    empty = torch.bincount(seg_t[seg_t < n_rays].long(), minlength=n_rays) == 0
    assert bool((outs[0][empty] == 0).all())
    xg = x.clone().requires_grad_()
    cot = torch.randn(n_rays, c, device=cuda_device)
    (segscan.segment_sum(xg, seg_t, n_rays) * cot).sum().backward()
    xp = x.clone().requires_grad_()
    (segscan.segment_sum_plain(xp, seg_t, n_rays) * cot).sum().backward()
    assert torch.equal(xg.grad, xp.grad)


@pytest.mark.cuda
def test_sort_pairs_kernel_bit_equal_to_plain(cuda_device):
    """The key-value sort against its plain version (a stable sort of the
    digit): keys and the values that moved with them equal, for bit ranges
    of one pass and of several, rows of every tile remainder."""
    rng = np.random.default_rng(41)
    for shape in ((5000,), (3, 4097), (2, 70_000), (1, 819_200)):
        keys = T(rng.integers(0, 1 << 15, shape).astype(np.int32)).to(cuda_device)
        vals = T(rng.integers(-(2**31), 2**31 - 1, shape, dtype=np.int64).astype(np.int32)).to(cuda_device)
        for begin_bit, end_bit in ((0, 15), (0, 8), (3, 12), (0, 32)):
            before = bitonic.sort_pairs_i32.launches
            k, v = bitonic.sort_pairs_i32(keys, vals, begin_bit, end_bit)
            torch.cuda.synchronize()
            assert bitonic.sort_pairs_i32.launches == before + 1
            k_ref, v_ref = bitonic.sort_pairs_i32_plain(keys, vals, begin_bit, end_bit)
            assert torch.equal(k, k_ref) and torch.equal(v, v_ref), (shape, begin_bit, end_bit)


@pytest.mark.cuda
@pytest.mark.parametrize("res,f", [(128, 4), (64, 6), (32, 8), (9, 3)])
def test_oct_table_grad_kernels_match_scatter_and_repeat(cuda_device, res, f):
    """Cobafa's oct gradient on the card (the window sort, by key and value
    where the windows and samples pass 32 bits, then the register kernel's
    flat layout): against one `index_add_` of the [n, 8F] rows, 1e-5 of the
    largest sum; a pad tail of zero cotangents in one cell; DET_RUNS calls
    bit-equal."""
    rng = np.random.default_rng(43)
    n = 300_000
    n_cells = (res - 1) ** 3
    cell = rng.integers(0, n_cells, n)
    cell[-100_000:] = n_cells // 3
    g = rng.normal(size=(n, f)).astype(np.float32)
    g[-100_000:] = 0.0
    w = rng.uniform(size=(n, 8)).astype(np.float32)
    cell_t, g_t, w_t = (T(a).to(cuda_device) for a in (cell, g, w))
    before = {k: getattr(fn, a) for k, (fn, a) in cuda_lib.launch_counters().items()}
    outs = [interp.oct_table_grad(g_t, w_t, cell_t, n_cells) for _ in range(DET_RUNS)]
    torch.cuda.synchronize()
    launched = {k: getattr(fn, a) - before[k] for k, (fn, a) in cuda_lib.launch_counters().items()}
    pairs = not table_grad.window_keys_fit(-(-n_cells // 64) * 64, 64, n)
    assert launched["accumulate"] == DET_RUNS and launched["sort_pairs" if pairs else "sort"] == DET_RUNS
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    contrib = (g_t[:, None, :] * w_t[:, :, None]).reshape(n, 8 * f)
    ref = torch.zeros(n_cells, 8 * f, device=cuda_device).index_add_(0, cell_t.long(), contrib)
    assert outs[0].shape == ref.shape
    torch.testing.assert_close(outs[0], ref, atol=_grad_tol(ref), rtol=0)

# the Cobafa field's seven grids at full width (make_model("cobafa")), then
# ragged shapes: odd channel counts (12- and 24-byte corners), r = 2
OCT_SHAPES = [(32, 32, 32, 8), (51, 51, 51, 8), (70, 70, 70, 8), (89, 89, 89, 4), (108, 108, 108, 4),
              (128, 128, 128, 4), (64, 64, 64, 6), (5, 6, 7, 3), (7, 5, 6, 6), (2, 2, 2, 1), (9, 17, 9, 4),
              (2, 40, 33, 4), (40, 2, 33, 8), (33, 40, 2, 6), (3, 300, 5, 2), (20, 21, 22, 5), (6, 7, 900, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_oct_build_kernel_bit_equal_to_plain(cuda_device, out_dtype):
    rng = np.random.default_rng(16)
    for shape in OCT_SHAPES:
        table = T(rng.normal(size=shape).astype(np.float32)).to(cuda_device)
        before = octbuild.build_oct.launches
        _poison_next_empty(octbuild.build_oct_plain(table, out_dtype))
        out = octbuild.build_oct(table, out_dtype)
        assert octbuild.build_oct.launches == before + 1
        assert torch.equal(out, octbuild.build_oct_plain(table, out_dtype)), shape
    # a table that starts off a 16-byte boundary (a view one value in)
    flat = T(rng.normal(size=6 * 7 * 8 * 4 + 1).astype(np.float32)).to(cuda_device)
    table = flat[1:].view(6, 7, 8, 4)
    assert torch.equal(octbuild.build_oct(table, out_dtype), octbuild.build_oct_plain(table, out_dtype))
    with pytest.raises(RuntimeError, match="tn_build_oct"):  # two slabs of two such lines exceed shared memory
        octbuild.build_oct(torch.zeros(2, 2, 20_000, 4, device=cuda_device), out_dtype)


@pytest.mark.cuda
def test_trilinear_lookup_oct_on_card_matches_cpu(cuda_device):
    """The lookup through the kernel's table on the card against the plain
    build on the CPU: values 1e-6 (the lerp's f32 sum), table gradients 1e-5
    of their largest magnitude (index_add_'s atomic order)."""
    rng = np.random.default_rng(17)
    table = rng.normal(size=(12, 10, 9, 6)).astype(np.float32)
    x = rng.uniform(-1, 1, (4000, 3)).astype(np.float32)
    x[:2] = [[-1, -1, -1], [1, 1, 1]]
    cot = rng.normal(size=(4000, 6)).astype(np.float32)
    res = {}
    for dev in ("cpu", cuda_device):
        t = T(table).to(dev).requires_grad_()
        out = interp.trilinear_lookup_oct(t, T(x).to(dev))
        out.backward(T(cot).to(dev))
        res[str(dev)] = (out.detach().cpu(), t.grad.cpu())
    (v_cpu, g_cpu), (v_card, g_card) = res["cpu"], res[str(cuda_device)]
    torch.testing.assert_close(v_card, v_cpu, atol=1e-6, rtol=0)
    torch.testing.assert_close(g_card, g_cpu, atol=_grad_tol(g_cpu), rtol=0)


# the K-Planes planes at full width (make_model("kplanes")), then odd and
# small channel counts (a bf16 row of 4F values is 8F bytes; any F but 32
# takes the generic path), r = 2, and F = 32 (the vector path's width) on
# planes that are not square and whose cells are no multiple of the block's
QUAD_SHAPES = [(129, 129, 32), (257, 257, 32), (513, 513, 32), (9, 17, 3), (17, 9, 6), (5, 6, 1), (2, 2, 2),
               (9, 9, 4), (6, 7, 12), (33, 70, 32), (70, 9, 32), (2, 300, 32)]
QUAD_OUT = [torch.bfloat16, torch.float32, torch.float8_e4m3fn]


def _bytes_equal(out: torch.Tensor, ref: torch.Tensor) -> bool:
    return torch.equal(out.view(torch.uint8), ref.view(torch.uint8))


def _poison_next_quad(like: torch.Tensor) -> None:
    """`_poison_next_empty` for the quad build's output: every byte 0xFF
    (NaN in bf16, f32 and float8), so that an unwritten chunk shows."""
    torch.empty_like(like).view(torch.uint8).fill_(0xFF)


def _quad_case(table, out_dtype):
    plain = octbuild.build_quad_plain(table, out_dtype)
    _poison_next_quad(plain)
    before = octbuild.build_quad.launches
    out = octbuild.build_quad(table, out_dtype)
    torch.cuda.synchronize()
    assert octbuild.build_quad.launches == before + 1
    return out, plain


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", QUAD_OUT)
def test_quad_build_kernel_bit_equal_to_plain(cuda_device, out_dtype):
    """Bit-equal as bytes (a float8 NaN is not equal to itself), float8
    also over values beyond its range (JAX's NaN rule) and subnormals."""
    rng = np.random.default_rng(18)
    for shape in QUAD_SHAPES:
        table = rng.normal(size=shape) * 2.0 ** rng.integers(-12, 10, shape)
        table = T(table.astype(np.float32)).to(cuda_device)
        out, plain = _quad_case(table, out_dtype)
        assert _bytes_equal(out, plain), shape


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", QUAD_OUT)
def test_quad_build_kernel_tables_off_16_bytes(cuda_device, out_dtype):
    """Contiguous views with a storage offset: `t[1:]` of an odd-F table
    (r1 F = 15 values: 60 bytes in) and a flat F = 32 buffer viewed from
    its second value (4 bytes in) take the generic path, and equal the
    plain build; the entry point refuses the vector path for the latter."""
    rng = np.random.default_rng(19)
    odd = T(rng.normal(size=(8, 5, 3)).astype(np.float32)).to(cuda_device)[1:]
    flat = T(rng.normal(size=1 + 9 * 13 * 32).astype(np.float32)).to(cuda_device)
    f32 = flat[1:].view(9, 13, 32)
    for table in (odd, f32):
        assert table.data_ptr() % 16 != 0 and not octbuild.quad_vector_loads(table)
        out, plain = _quad_case(table, out_dtype)
        assert _bytes_equal(out, plain), tuple(table.shape)
    out = torch.empty(8 * 12, 128, dtype=out_dtype, device=cuda_device)
    with pytest.raises(RuntimeError, match="tn_build_quad"):
        cuda_lib.library().call("tn_build_quad", f32.data_ptr(), 9, 13, 32, out.element_size(), 1,
                                octbuild.QUAD_BAND, octbuild.QUAD_LINES, octbuild.QUAD_THREADS,
                                out.data_ptr(), cuda_lib.stream_of(f32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(17, 33, 32), (9, 9, 12), (5, 40, 3)], ids=lambda s: "x".join(map(str, s)))
def test_quad_build_kernel_float8_boundaries_at_every_chunk_position(cuda_device, shape):
    """JAX's float8 boundaries (+-448, +-464, +-464.0001, +-inf, NaN, 2^-10)
    at every position of a 16-value output chunk: table value k is boundary
    (k // 16 + k % 16) mod 13; at F = 32 (the vector path) a row's chunks
    start at multiples of 16 values of a corner pair, so position k % 16 of
    a chunk meets every value; F = 12 and 3 (the generic path) mix them
    otherwise."""
    b = np.array([448, -448, 464, -464, 464.0001, -464.0001, np.inf, -np.inf, np.nan, -np.nan,
                  2**-10, -(2**-10), 0.5], np.float32)
    k = np.arange(int(np.prod(shape)))
    table = T(b[(k // 16 + k % 16) % b.size].reshape(shape)).to(cuda_device)
    out, plain = _quad_case(table, torch.float8_e4m3fn)
    assert _bytes_equal(out, plain)
    assert int(((plain.view(torch.uint8) & 0x7F) == 0x7F).sum()) > 0  # the NaN codes are there


@pytest.mark.cuda
@pytest.mark.parametrize("aabb", [((-1.5,) * 3, (1.5,) * 3), ((-1.5, -0.6, -1.5), (1.5, 0.6, 1.5))])
def test_skip_march_kernel_equals_plain(cuda_device, aabb):
    """Random grids (cubic and not), rays from outside the box, with and
    without jitter, at a full and a starved budget: k_idx and complete
    equal, on 20,000 rays."""
    rng = np.random.default_rng(19)
    for shape, density, n_samples in (((32, 32, 32), 0.02, 200), ((16, 24, 12), 0.2, 64), ((128,) * 3, 0.005, 400)):
        occ = T(rng.random(shape) < density).to(cuda_device)
        grid = skipmarch.make_skip_grid(occ)
        n = 20_000
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = -4.0 * d + rng.normal(size=(n, 3)).astype(np.float32) * 0.5
        o, d = T(o).to(cuda_device), T(d).to(cuda_device)
        marcher = RayMarcherAABB(aabb, n_samples=n_samples, near=0.1)
        t_min, t_exit = marcher.entry_exit(o, d)
        for seed in (None, [0x12345678, 0x9ABCDEF0]):
            for n_steps in (64, 7):
                args = (o, d, t_min, t_exit, marcher.step_size, n_samples, aabb, grid, seed, n_steps)
                before = skipmarch.skip_march.launches
                k, c = skipmarch.skip_march(*args)
                assert skipmarch.skip_march.launches == before + 1
                k_ref, c_ref = skipmarch.skip_march_plain(*args)
                assert torch.equal(k, k_ref), (shape, seed, n_steps)
                assert torch.equal(c, c_ref), (shape, seed, n_steps)
                assert int((k >= 0).sum()) > 0


@pytest.mark.cuda
def test_skip_march_unbounded_kernel_equals_plain(cuda_device):
    """Random iso grids, rays from ~4 units out and from near the origin
    (the far field along the diagonals), with and without jitter, at a
    full and a starved budget: k_idx and complete equal, on 20,000 rays."""
    rng = np.random.default_rng(23)
    for res, density, n_samples, near_origin in ((32, 0.02, 200, False), (16, 0.2, 64, False),
                                                  (128, 0.005, 400, True)):
        occ = T(rng.random((res,) * 3) < density).to(cuda_device)
        grid = skipmarch.make_skip_grid_iso(occ)
        n = 20_000
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32) if near_origin else \
            -4.0 * d + rng.normal(size=(n, 3)).astype(np.float32) * 0.5
        o, d = T(o).to(cuda_device), T(d).to(cuda_device)
        marcher = RayMarcherUnbounded(n_samples=n_samples, near=0.1, uniform_range=2.5)
        for seed in (None, [0x12345678, 0x9ABCDEF0]):
            for n_steps in (96, 7):
                args = (o, d, marcher, ContractionMip360(), grid, seed, n_steps)
                before = skipmarch.skip_march_unbounded.launches
                k, c = skipmarch.skip_march_unbounded(*args)
                assert skipmarch.skip_march_unbounded.launches == before + 1
                k_ref, c_ref = skipmarch.skip_march_unbounded_plain(*args)
                assert torch.equal(k, k_ref), (res, seed, n_steps)
                assert torch.equal(c, c_ref), (res, seed, n_steps)
                assert int((k >= 0).sum()) > 0


# ---- determinism: a training step and a served chunk repeat themselves
# bit for bit on the card (no float atomics in an order that changes from
# run to run); full-width fields at the TrainConfig defaults (2048 rays x
# 400 samples, bf16 compute), K-Planes with both table-gradient payloads

DET_FIELDS = {"kplanes_bf16": ("kplanes", "auto"), "kplanes_f32": ("kplanes", "sorted"),
              "cobafa": ("cobafa", None), "vanilla": ("vanilla", None)}
DET_RUNS = 3


@pytest.fixture(scope="module")
def det_pool():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from tinynerf_tpu_torch.data import RayPool
    from tinynerf_tpu_torch.utils import make_spheres_data

    pool = RayPool(make_spheres_data(n_views=2, res=200, seed=1), device="cuda")
    order = torch.randperm(pool.n_rays, generator=torch.Generator().manual_seed(3)).to("cuda")
    return pool, tuple(a[order].contiguous() for a in pool.arrays())


def _det_world(name, pool):
    from tinynerf_tpu_torch.train import TrainConfig, build_renderer, make_optimizer

    method, bwd_impl = DET_FIELDS[name]
    cfg = TrainConfig(method=method, seed=0)
    renderer = build_renderer(cfg, pool.scene_scale, pool.bg_color, device="cuda")
    if bwd_impl is not None:
        renderer.field.bwd_impl = bwd_impl
    return cfg, renderer


def _differences(runs: list) -> list:
    """(part, max|diff| / max|first|) of every tensor that is not bit-equal
    to the first run's."""
    out = []
    for run in runs[1:]:
        for key, ref in runs[0].items():
            if not torch.equal(run[key], ref):
                diff = float((run[key].float() - ref.float()).abs().max())
                out.append((key, diff / max(float(ref.float().abs().max()), 1e-30)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("march", ["dense", "skip"])
@pytest.mark.parametrize("name", sorted(DET_FIELDS))
def test_train_step_repeats_bit_for_bit(det_pool, name, march):
    """`make_train_step(deterministic=True)` from one saved state (after a
    first step, so that Adam's moments are not zero), DET_RUNS times: the
    loss, every gradient, and every parameter and moment after the update
    bit-equal.  Dense: the all-occupied grid, 2048 rays; skip: the shell
    occupancy (cells to skip), 16 x 2048 rays."""
    from tinynerf_tpu_torch.convert import tree_leaves_with_path
    from tinynerf_tpu_torch.train import make_optimizer, make_train_step
    from tinynerf_tpu_torch.utils import make_shell_occupancy

    pool, arrays = det_pool
    cfg, renderer = _det_world(name, pool)
    opt = make_optimizer(cfg, renderer)
    if march == "skip":
        n_cand = 16 * cfg.batch_size
        occ = make_shell_occupancy(renderer.occupancy, device="cuda")
        args = (occ, renderer.skip_grid(occ))
    else:
        n_cand = cfg.batch_size
        args = (renderer.occupancy.init_state("cuda"),)
    step = make_train_step(renderer, opt, cfg, n_cand, deterministic=True, march=march)
    step(*args, *arrays)
    start = [t.detach().clone() for t in (*opt.params, *opt.mu, *opt.nu)]
    count = opt.count
    runs = []
    for _ in range(DET_RUNS):
        with torch.no_grad():
            for t, t0 in zip((*opt.params, *opt.mu, *opt.nu), start):
                t.copy_(t0)
        opt.count = count
        m = step(*args, *arrays)
        torch.cuda.synchronize()
        run = {"loss": m["loss"].clone()}
        run.update({f"grad {path}": g.clone() for path, g in tree_leaves_with_path(m["grads"])})
        for label, tensors in (("param", opt.params), ("mu", opt.mu), ("nu", opt.nu)):
            run.update({f"{label} {path}": t.detach().clone() for path, t in zip(opt.paths, tensors)})
        runs.append(run)
    assert float(runs[0]["loss"]) > 0 and np.isfinite(float(runs[0]["loss"]))
    assert any(float(v.abs().max()) > 0 for k, v in runs[0].items() if k.startswith("grad "))
    diffs = _differences(runs)
    assert not diffs, f"{name} {march}: {len(diffs)} tensors differ run to run: {diffs[:12]}"


@pytest.mark.cuda
@pytest.mark.parametrize("march", ["dense", "skip"])
@pytest.mark.parametrize("name", ["kplanes_bf16", "cobafa", "vanilla"])
def test_served_chunk_repeats_bit_for_bit(det_pool, name, march):
    """One 2048-ray packed serving chunk (64 samples per ray, the shell
    occupancy), rendered DET_RUNS times: colors, flags and counts bit-equal."""
    from tinynerf_tpu_torch.train import make_render_chunk_packed
    from tinynerf_tpu_torch.utils import make_shell_occupancy

    pool, (rays_o, rays_d, _) = det_pool
    cfg, renderer = _det_world(name, pool)
    occ = make_shell_occupancy(renderer.occupancy, device="cuda")
    grid = (renderer.skip_grid(occ),) if march == "skip" else ()
    fn = make_render_chunk_packed(renderer, cfg.batch_size * cfg.eval_samples_per_ray, march=march)
    runs = []
    with torch.inference_mode():
        for _ in range(DET_RUNS):
            rgb, ok, n_samples, n_complete = fn(occ, rays_o[:cfg.batch_size], rays_d[:cfg.batch_size], *grid)
            torch.cuda.synchronize()
            runs.append({"rgb": rgb.clone(), "ok": ok.clone(), "n_samples": n_samples.clone(),
                         "n_complete": n_complete.clone()})
    assert int(runs[0]["n_samples"]) > 0 and bool(torch.isfinite(runs[0]["rgb"]).all())
    diffs = _differences(runs)
    assert not diffs, f"{name} {march} serving chunk: differs run to run: {diffs}"
