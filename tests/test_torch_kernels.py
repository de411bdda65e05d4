"""The hand-written CUDA kernels against their plain PyTorch versions, and
the wrappers' device dispatch.

The kernel tests are marked `cuda`: they need a card and skip without one
(a CUDA kernel has no CPU mode).  This file imports neither jax nor the JAX package, so it runs on
a machine with a GPU and no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

(`--noconftest`: tests/conftest.py sets up jax for the JAX suite).  The
plain versions are themselves held against the JAX package in
test_torch_ops.py.  Tolerances: weights atol 1e-5, cumsums rtol 1e-5 /
atol 1e-4 (f32 scans in another summation order).
"""

import numpy as np
import pytest
import torch

from tinynerf_tpu_torch.ops import cuda_lib, segscan, weights_dense

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


def test_segment_starts():
    seg = torch.tensor([0, 0, 2, 2, 2, 3, 5, 5, 5], dtype=torch.int32)
    # by id range: empty segments 1 and 4 get zero-length runs; id 5 is
    # outside n_segments=5, so the last start is where it begins
    assert segscan.segment_starts(seg, 5).tolist() == [0, 2, 2, 5, 6, 6]
    assert segscan.segment_starts(seg, None).tolist() == [0, 2, 5, 6, 9]
    assert segscan.segment_starts(seg[:0], None).tolist() == [0]


def test_kernel_wrappers_raise_off_cpu_and_cuda():
    """A tensor on another device is refused; nothing falls back."""
    m = torch.empty(8, device="meta")
    with pytest.raises(ValueError):
        segscan.compute_weights_packed(m, m, m, torch.empty(8, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        weights_dense.compute_weights_dense(m[None], m[None], m[None])
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
