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

`sort_pairs_i32` is the same sort carrying an int32 value with each key
(one pass of the kernel moves both): the sort for buckets whose id and
sample index do not fit one int32 together.

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


def _rows(name: str, t: torch.Tensor) -> torch.Tensor:
    """[N] or [B, N] as a contiguous [B, N]."""
    rows = (t[None] if t.dim() == 1 else t).contiguous()
    if rows.dim() != 2:
        raise ValueError(f"{name}: expected [N] or [B, N], got {tuple(t.shape)}")
    return rows


def _radix_sort(wrapper, name: str, keys: torch.Tensor, vals, begin_bit: int, end_bit: int):
    """One call of `csrc/radix_sort.cu` on CUDA tensors, counted on
    `wrapper`: (sorted keys, values moved with them or None), shaped as
    `keys`."""
    _check_bits(begin_bit, end_bit)
    keys2 = _rows(name, keys)
    b, n = keys2.shape
    both = (keys2,) if vals is None else (keys2, _rows(name, vals))
    cuda_lib.check_cuda_inputs(name, torch.int32, (b, n), *both)
    passes = -(-(end_bit - begin_bit) // RADIX_BITS)
    if b == 0 or n == 0 or passes == 0:
        return keys.clone(), None if vals is None else vals.clone()
    # the passes write two buffers per array in turns; the inputs are only read
    bufs = [[torch.empty_like(t) for _ in range(min(passes, 2))] for t in both]
    second = [pair[-1].data_ptr() if passes > 1 else None for pair in bufs]
    scratch = torch.empty(b * 256 * (-(-n // SORT_TILE) + 1), dtype=torch.int32, device=keys.device)
    if vals is None:
        args = ("tn_sort_i32", keys2.data_ptr(), bufs[0][0].data_ptr(), second[0])
    else:
        args = ("tn_sort_pairs_i32", keys2.data_ptr(), both[1].data_ptr(), bufs[0][0].data_ptr(), second[0],
                bufs[1][0].data_ptr(), second[1])
    cuda_lib.library().call(*args, scratch.data_ptr(), b, n, begin_bit, end_bit, cuda_lib.stream_of(keys2))
    wrapper.launches += 1
    outs = [pair[(passes - 1) % 2].reshape(t.shape) for pair, t in zip(bufs, (keys, vals))]
    return outs[0], outs[1] if vals is not None else None


def sort_i32(keys: torch.Tensor, begin_bit: int = 0, end_bit: int = 32) -> torch.Tensor:
    """keys: [N] or [B, N] int32 -> sorted ascending along the last axis,
    stably, by the key bits [begin_bit, end_bit) (bit 31 is the sign): the
    default range is the plain ascending sort."""
    if cuda_lib.runs_plain("sort_i32", keys):
        return sort_i32_plain(keys, begin_bit, end_bit)
    return _radix_sort(sort_i32, "sort_i32", keys, None, begin_bit, end_bit)[0]


sort_i32.launches = 0


def sort_pairs_i32_plain(keys: torch.Tensor, vals: torch.Tensor, begin_bit: int = 0, end_bit: int = 32):
    """Plain PyTorch `sort_pairs_i32`: a stable sort of the digit, then two gathers."""
    _check_bits(begin_bit, end_bit)
    digit = ((keys.long() + 2**31) >> begin_bit) & ((1 << (end_bit - begin_bit)) - 1)
    order = torch.sort(digit, dim=-1, stable=True).indices
    return torch.gather(keys, -1, order), torch.gather(vals, -1, order)


def sort_pairs_i32(keys: torch.Tensor, vals: torch.Tensor, begin_bit: int = 0, end_bit: int = 32):
    """keys, vals: [N] or [B, N] int32 -> (keys sorted as `sort_i32` sorts
    them, vals moved with their keys): stable, so equal keys keep their
    values' input order."""
    if cuda_lib.runs_plain("sort_pairs_i32", keys, vals):
        return sort_pairs_i32_plain(keys, vals, begin_bit, end_bit)
    return _radix_sort(sort_pairs_i32, "sort_pairs_i32", keys, vals, begin_bit, end_bit)


sort_pairs_i32.launches = 0


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
