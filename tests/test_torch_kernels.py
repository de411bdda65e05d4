"""The hand-written CUDA kernels against their plain PyTorch versions, and
the wrappers' device dispatch: the packed and dense weights and their
backwards, the radix sort, the windowed table-gradient accumulation, the
oct and quad cell-pack builds and both skip marches (AABB and unbounded).

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
multiset); accumulated table gradients 1e-5 of their largest magnitude
(f32 sums in another order, the atomics' order changing run to run); the
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
# small channel counts (a bf16 row of 4F values is 8F bytes; a float8 row
# takes 16-byte chunks only where F is a multiple of 4) and r = 2
QUAD_SHAPES = [(129, 129, 32), (257, 257, 32), (513, 513, 32), (9, 17, 3), (17, 9, 6), (5, 6, 1), (2, 2, 2),
               (9, 9, 4), (6, 7, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32, torch.float8_e4m3fn])
def test_quad_build_kernel_bit_equal_to_plain(cuda_device, out_dtype):
    """Bit-equal as bytes (a float8 NaN is not equal to itself), float8
    also over values beyond its range (JAX's NaN rule) and subnormals."""
    rng = np.random.default_rng(18)
    for shape in QUAD_SHAPES:
        table = rng.normal(size=shape) * 2.0 ** rng.integers(-12, 10, shape)
        table = T(table.astype(np.float32)).to(cuda_device)
        before = octbuild.build_quad.launches
        out = octbuild.build_quad(table, out_dtype)
        assert octbuild.build_quad.launches == before + 1
        plain = octbuild.build_quad_plain(table, out_dtype)
        assert torch.equal(out.view(torch.uint8), plain.view(torch.uint8)), shape


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
