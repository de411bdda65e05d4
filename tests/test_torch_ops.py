"""Port ops (tinynerf_tpu_torch.ops) against the JAX package's ops.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX Pallas kernels run in interpret mode on the CPU, as the JAX suite runs
them; the port runs its plain versions here (CPU tensors).  The CUDA kernels
against these plain versions are in test_torch_kernels.py.

Tolerances: segment cumsums rtol 1e-5 / atol 1e-4 and packed weights
atol 1e-5 (tests/test_segscan.py's: the port's plain cumsum is float64
then rounded, the JAX kernel's is an f32 Hillis-Steele tree); dense weights
atol 1e-6 (both are f32 row cumsums of the same values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.ops import interp as jinterp
from tinynerf_tpu.ops import segscan as jsegscan
from tinynerf_tpu.ops.trunc_exp import truncated_exp as jtrunc_exp
from tinynerf_tpu.ops.weights import compute_weights as jcompute_weights
from tinynerf_tpu.ops.weights_pallas import compute_weights_pallas
from tinynerf_tpu_torch.ops import interp, segscan, weights_dense
from tinynerf_tpu_torch.ops.trunc_exp import truncated_exp
from tinynerf_tpu_torch.ops.weights import compute_weights

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


def test_segmented_cumsum_plain_matches_jax_kernel():
    sig, _, _, seg, n_rays = _packed(0)
    x = np.random.default_rng(1).normal(size=sig.size).astype(np.float32)
    ref = np.asarray(jsegscan.segmented_cumsum(jnp.asarray(x), jnp.asarray(seg), interpret=True))
    out = segscan.segmented_cumsum(T(x), T(seg))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-4)
    # with n_segments, ids outside [0, n_segments) (the pad tail) come out 0
    out_n = segscan.segmented_cumsum(T(x), T(seg), n_segments=n_rays).numpy()
    in_range = seg < n_rays
    np.testing.assert_allclose(out_n[in_range], ref[in_range], rtol=1e-5, atol=1e-4)
    assert np.all(out_n[~in_range] == 0.0)


def test_segmented_cumsum_plain_any_contiguous_ids():
    """The plain version takes any contiguous ids (not only ascending), as
    the JAX op does; sums stay segment-local."""
    rng = np.random.default_rng(2)
    lengths = [1, 7, 130, 5, 300, 2]
    ids = [5, -1, 9, 0, 3, 7]
    seg = np.concatenate([np.full(n, i) for i, n in zip(ids, lengths)]).astype(np.int32)
    x = rng.uniform(0, 1, seg.size).astype(np.float32) + 1e4 * (seg == 9)
    out = segscan.segmented_cumsum(T(x), T(seg)).numpy()
    start = 0
    for n in lengths:
        sl = slice(start, start + n)
        np.testing.assert_allclose(out[sl], np.cumsum(x[sl].astype(np.float64)), rtol=1e-6)
        start += n


@pytest.mark.parametrize("thr", [0.0, 1e-4, 1e-2])
def test_packed_weights_plain_matches_jax_kernel(thr):
    sig, dlt, valid, seg, n_rays = _packed(3)
    ref = np.asarray(jsegscan.compute_weights_packed(
        jnp.asarray(sig), jnp.asarray(dlt), jnp.asarray(valid), jnp.asarray(seg), thr, True
    ))
    out = segscan.compute_weights_packed(T(sig), T(dlt), T(valid), T(seg), thr)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    out_n = segscan.compute_weights_packed(T(sig), T(dlt), T(valid), T(seg), thr, n_segments=n_rays)
    np.testing.assert_allclose(out_n.numpy(), ref, atol=1e-5)
    assert np.all(out_n.numpy()[seg == n_rays] == 0.0)


@pytest.mark.parametrize("thr", [0.0, 1e-4, 1e-2])
def test_dense_weights_plain_matches_jax(thr):
    rng = np.random.default_rng(4)
    r, s = 64, 150
    sig = rng.uniform(0, 8, (r, s)).astype(np.float32)
    dlt = rng.uniform(0.01, 0.1, (r, s)).astype(np.float32)
    msk = (rng.random((r, s)) > 0.3).astype(np.float32)
    msk[5] = 0.0
    args = (jnp.asarray(sig), jnp.asarray(dlt), jnp.asarray(msk))
    ref = np.asarray(jcompute_weights(*args, thr))
    ref_pallas = np.asarray(compute_weights_pallas(*args, thr, True))
    for fn in (compute_weights, weights_dense.compute_weights_dense):
        out = fn(T(sig), T(dlt), T(msk), thr).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6)
        np.testing.assert_allclose(out, ref_pallas, atol=1e-6)


def test_truncated_exp_matches_jax():
    x = np.linspace(-30, 30, 257).astype(np.float32)
    for clamp in (True, False):
        ref = np.asarray(jtrunc_exp(jnp.asarray(x), clamp))
        np.testing.assert_allclose(truncated_exp(T(x), clamp).numpy(), ref, rtol=1e-6)


def test_interp_pieces_match_jax():
    rng = np.random.default_rng(5)
    r0, r1, f = 9, 17, 32
    table = rng.uniform(0, 1, (r0, r1, f)).astype(np.float32)
    coords = rng.uniform(-1.05, 1.05, (500, 2)).astype(np.float32)
    coords[:4] = [[-1, -1], [1, 1], [1, -1], [0, 0]]  # edges and the last cell
    np.testing.assert_array_equal(
        interp._to_index_space(T(coords[:, 0]), r0).numpy(),
        np.asarray(jinterp._to_index_space(jnp.asarray(coords[:, 0]), r0)),
    )
    cell, w = interp._cell_2d(T(coords), r0, r1)
    jcell, jw = jinterp._cell_2d(jnp.asarray(coords), r0, r1)
    np.testing.assert_array_equal(cell.numpy(), np.asarray(jcell))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-7)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        out = interp._quad_lookup_fwd_value(T(table), T(coords), dt).numpy()
        ref = np.asarray(jinterp._quad_lookup_fwd_value(jnp.asarray(table), jnp.asarray(coords), jdt))
        np.testing.assert_allclose(out, ref, atol=1e-6)
