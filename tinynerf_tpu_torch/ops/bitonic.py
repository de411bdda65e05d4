"""Ascending sort of packed int32 keys through a hand-written CUDA kernel.

Counterpart of `tinynerf_tpu/ops/bitonic.py`: `sort_i32` sorts int32 keys
along the last axis, several rows batched into one call, any length.  The
TPU kernel is a bitonic network (all compare-exchange passes inside VMEM,
rows padded to a power of two); the port's first kernel copied it and was
2.6x slower than `torch.sort`, 45 launches each streaming every key
through L2.  On this card the sort is a least-significant-digit radix sort
(`csrc/radix_sort.cu`): one pass per 8-bit digit, no padding, and only over
the bits the caller names with `begin_bit` / `end_bit`, by which it sorts
STABLY.  The module keeps its counterpart's name.  On CPU tensors
`sort_i32` runs the plain version, a stable `torch.sort` of the digit and a
gather.  Over the full 32 bits both give `torch.sort`'s keys bit for bit.

`pack_keys` packs (bucket << idx_bits) | sample index into one int32, so a
plain ascending sort groups the samples by bucket and yields the
permutation at once; `packed_bits_ok` says whether the bits fit 31.
"""

from __future__ import annotations

import torch

from . import cuda_lib

RADIX_BITS = 8  # bits per pass of csrc/radix_sort.cu
SORT_TILE = 4096  # keys per block there (kTile)


def _bits(n: int) -> int:
    """ceil(log2(max(n, 2))), at least 1."""
    return max(1, (max(n, 2) - 1).bit_length())


def _check_bits(begin_bit: int, end_bit: int) -> None:
    if not 0 <= begin_bit <= end_bit <= 32:
        raise ValueError(f"sort_i32: bad bit range [{begin_bit}, {end_bit})")


def sort_i32_plain(keys: torch.Tensor, begin_bit: int = 0, end_bit: int = 32) -> torch.Tensor:
    """Plain PyTorch `sort_i32`: a stable sort of the digit, then a gather."""
    _check_bits(begin_bit, end_bit)
    # bit 31 flipped: the signed order as an unsigned digit
    digit = ((keys.long() + 2**31) >> begin_bit) & ((1 << (end_bit - begin_bit)) - 1)
    order = torch.sort(digit, dim=-1, stable=True).indices
    return torch.gather(keys, -1, order)


def sort_i32(keys: torch.Tensor, begin_bit: int = 0, end_bit: int = 32) -> torch.Tensor:
    """keys: [N] or [B, N] int32 -> sorted ascending along the last axis,
    stably, by the key bits [begin_bit, end_bit) (bit 31 is the sign): the
    default range is the plain ascending sort."""
    if cuda_lib.runs_plain("sort_i32", keys):
        return sort_i32_plain(keys, begin_bit, end_bit)
    _check_bits(begin_bit, end_bit)
    squeeze = keys.dim() == 1
    keys2 = (keys[None] if squeeze else keys).contiguous()
    if keys2.dim() != 2:
        raise ValueError(f"sort_i32: expected [N] or [B, N], got {tuple(keys.shape)}")
    b, n = keys2.shape
    cuda_lib.check_cuda_inputs("sort_i32", torch.int32, (b, n), keys2)
    passes = -(-(end_bit - begin_bit) // RADIX_BITS)
    if b == 0 or n == 0 or passes == 0:
        return keys.clone()
    # the passes write two buffers in turns; the input is only read
    bufs = [torch.empty_like(keys2) for _ in range(min(passes, 2))]
    scratch = torch.empty(b * 256 * (-(-n // SORT_TILE) + 1), dtype=torch.int32, device=keys.device)
    cuda_lib.library().call(
        "tn_sort_i32", keys2.data_ptr(), bufs[0].data_ptr(), bufs[-1].data_ptr() if passes > 1 else None,
        scratch.data_ptr(), b, n, begin_bit, end_bit, cuda_lib.stream_of(keys2))
    sort_i32.launches += 1
    out = bufs[(passes - 1) % 2]
    return out[0] if squeeze else out


sort_i32.launches = 0


def pack_keys(bucket: torch.Tensor, idx_bits: int) -> torch.Tensor:
    """(bucket << idx_bits) | index along the last axis, one int32 per
    sample.  Needs bucket_bits + idx_bits <= 31 (`packed_bits_ok`)."""
    n = bucket.shape[-1]
    if n > (1 << idx_bits):
        raise ValueError(f"pack_keys: {n} samples do not fit {idx_bits} index bits")
    iota = torch.arange(n, dtype=torch.int32, device=bucket.device)
    return (bucket.to(torch.int32) << idx_bits) | iota


def unpack_keys(packed: torch.Tensor, idx_bits: int):
    """-> (bucket, index)."""
    return packed >> idx_bits, packed & ((1 << idx_bits) - 1)


def packed_bits_ok(n_buckets: int, n_samples: int) -> bool:
    return _bits(n_buckets) + _bits(n_samples) <= 31
