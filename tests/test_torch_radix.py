"""The bit-range sort and the chunked windowed accumulation of the port
(tinynerf_tpu_torch) on the CPU: the plain versions that the CUDA kernels
of csrc/radix_sort.cu and csrc/table_grad.cu are held against on the card
(test_torch_kernels.py), here against the JAX package and numpy.

Inputs are made with numpy from a seed.  The JAX Pallas sort runs in
interpret mode.  Sorts are compared bit for bit; accumulated gradients
within 1e-5 of their largest magnitude for the f32 payload (f32 sums in
another order) and 3e-5 for the bf16 payload (its weights ride as a (hi,
lo) bf16 pair, ~2^-16 relative; g is rounded to bf16 on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.ops import bitonic as jbitonic
from tinynerf_tpu_torch.ops import bitonic, table_grad

torch.set_num_threads(2)

T = torch.from_numpy


def _bits(n: int) -> int:
    return max(1, (max(n, 2) - 1).bit_length())


@pytest.mark.parametrize("n_buckets,shape", [
    (4, (300,)), (1000, (1000,)), (37, (3, 777)), (1024, (3, 1500)), (2, (2, 1024)), (700, (1,)),
])
def test_bit_range_sort_of_packed_keys_bit_equal_jax(n_buckets, shape):
    """Packed keys (bucket << b) | iota sorted by the bucket bits alone:
    the low bits arrive ascending, so the stable bit-range sort is the full
    sort, bit for bit the JAX package's."""
    rng = np.random.default_rng(20)
    idx_bits = _bits(shape[-1])
    bucket = rng.integers(0, n_buckets, shape).astype(np.int32)
    keys = bitonic.pack_keys(T(bucket), idx_bits)
    np.testing.assert_array_equal(
        keys.numpy(), np.asarray(jbitonic.pack_keys(jnp.asarray(bucket), idx_bits)))
    ref = np.asarray(jbitonic.sort_i32(jnp.asarray(keys.numpy()), interpret=True))
    out = bitonic.sort_i32(keys, begin_bit=idx_bits, end_bit=idx_bits + _bits(n_buckets))
    assert out.dtype == torch.int32 and out.shape == keys.shape
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(bitonic.sort_i32(keys).numpy(), ref)


def _stable_by_digit(keys: np.ndarray, begin_bit: int, end_bit: int) -> np.ndarray:
    """numpy reference: bit 31 flipped, the digit cut out, a stable argsort."""
    digit = ((keys.astype(np.int64) + 2**31) >> begin_bit) & ((1 << (end_bit - begin_bit)) - 1)
    order = np.argsort(digit, axis=-1, kind="stable")
    return np.take_along_axis(keys, order, axis=-1)


@pytest.mark.parametrize("begin_bit,end_bit", [(0, 4), (8, 16), (5, 18), (12, 12)])
def test_bit_range_sort_is_stable(begin_bit, end_bit):
    """Repeated digits over unsorted low (and high) bits: equal digits keep
    their input order; an empty range leaves the keys as they were."""
    rng = np.random.default_rng(21)
    keys = rng.integers(0, 2**31 - 1, (3, 2000), dtype=np.int64).astype(np.int32)
    keys[:, ::3] = keys[:, 1::3][:, : keys[:, ::3].shape[1]]  # repeated whole keys too
    out = bitonic.sort_i32(T(keys), begin_bit=begin_bit, end_bit=end_bit).numpy()
    np.testing.assert_array_equal(out, _stable_by_digit(keys, begin_bit, end_bit))
    if begin_bit == end_bit:
        np.testing.assert_array_equal(out, keys)


@pytest.mark.parametrize("begin_bit", [0, 24, 31])
def test_bit_range_sort_with_the_sign_bit(begin_bit):
    """A range that ends at bit 32 takes bit 31 as the sign: negative keys
    come first."""
    rng = np.random.default_rng(22)
    keys = rng.integers(-(2**31), 2**31 - 1, (2, 1500), dtype=np.int64).astype(np.int32)
    keys[0, :4] = [-(2**31), 2**31 - 1, -1, 0]
    out = bitonic.sort_i32(T(keys), begin_bit=begin_bit, end_bit=32).numpy()
    np.testing.assert_array_equal(out, _stable_by_digit(keys, begin_bit, 32))
    if begin_bit == 0:
        np.testing.assert_array_equal(out, np.sort(keys, axis=-1))
    else:
        top = out >> begin_bit  # the sorted digit, as a signed number
        assert np.all(top[:, 1:] >= top[:, :-1])


def test_bit_range_sort_refuses_a_bad_range():
    keys = torch.zeros(8, dtype=torch.int32)
    for begin_bit, end_bit in ((-1, 8), (9, 8), (0, 33)):
        with pytest.raises(ValueError, match="bit range"):
            bitonic.sort_i32(keys, begin_bit=begin_bit, end_bit=end_bit)


@pytest.mark.parametrize("n,n_windows", [(70_000, 1 << 15), (40_000, 40_000), (70_000, 1 << 14)])
def test_sort_by_window_with_keys_of_all_32_bits(n, n_windows):
    """17 index bits under 15 or 16 window bits: 32-bit keys carry the window
    id with a bias, so that the sign bit sorts; and one bit less, without it.
    perm groups the samples by ascending window, stably, offsets bound them."""
    rng = np.random.default_rng(26)
    window = rng.integers(0, n_windows, (2, n)).astype(np.int32)
    window[0, :3] = [n_windows - 1, 0, n_windows // 2]
    perm, offsets = table_grad.sort_by_window(T(window * 4 + 1), n_windows * 4, 4)
    for p in range(2):
        np.testing.assert_array_equal(perm[p].numpy(), np.argsort(window[p], kind="stable"))
        np.testing.assert_array_equal(
            offsets[p].numpy(), np.searchsorted(np.sort(window[p]), np.arange(n_windows + 1)))


def test_sort_by_window_refuses_keys_beyond_32_bits():
    with pytest.raises(ValueError, match="32 key bits"):
        table_grad.sort_by_window(torch.zeros(1, 70_000, dtype=torch.int32), (1 << 16) * 4 + 4, 4)


@pytest.mark.parametrize("payload", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("extra", [0, 1])
def test_windowed_accumulate_at_the_chunk_boundary(payload, extra):
    """Window 0 has no sample, window 1 exactly ACCUM_CHUNK + extra (one
    work item of the kernel, or two), window 2 a few, window 3 none: the
    plain version against the scatter reference."""
    rng = np.random.default_rng(23)
    w_window, f, n_cells = 64, 8, 4 * 64
    n_full = table_grad.ACCUM_CHUNK + extra
    cell = np.concatenate([rng.integers(w_window, 2 * w_window, n_full),
                           rng.integers(2 * w_window, 3 * w_window, 37)]).astype(np.int32)[None]
    rng.shuffle(cell[0])
    n = cell.shape[1]
    g = T(rng.normal(size=(1, n, f)).astype(np.float32))
    w4 = T(rng.uniform(size=(1, n, 4)).astype(np.float32))
    cell = T(cell)
    perm, offsets = table_grad.sort_by_window(cell, n_cells, w_window)
    assert offsets.tolist() == [[0, 0, n_full, n, n]]
    rows = table_grad.pack_payload(g, w4, cell, w_window, payload)[0, perm[0].long()][None]
    out = table_grad.windowed_accumulate_plain(rows, offsets, f, 4, n_cells, w_window)
    ref = table_grad.windowed_accumulate_ref(g.to(payload).float(), w4, cell, n_cells)
    tol = (1e-5 if payload == torch.float32 else 3e-5) * float(ref.abs().max())
    torch.testing.assert_close(out, ref, atol=tol, rtol=0)
    assert float(out[0, :w_window].abs().max()) == 0.0
    assert float(out[0, 3 * w_window:].abs().max()) == 0.0
    # the wrapper on CPU tensors is the plain version
    torch.testing.assert_close(
        table_grad.windowed_accumulate(rows, offsets, f, 4, n_cells, w_window), out, atol=0, rtol=0)
