"""Ascending sort of packed int32 keys through a hand-written CUDA kernel.

Counterpart of `tinynerf_tpu/ops/bitonic.py`: `sort_i32` sorts int32 keys
along the last axis, several rows batched into one launch, each row padded
to a power of two >= 256 with INT32_MAX (the pad sorts to the tail and is
cut off).  On CUDA tensors it launches the bitonic network of
`csrc/bitonic.cu`; on CPU tensors it runs the plain version, `torch.sort`.
Both give the same keys bit for bit.

`pack_keys` packs (bucket << idx_bits) | sample index into one int32, so a
plain ascending sort groups the samples by bucket and yields the
permutation at once; `packed_bits_ok` says whether the bits fit 31.
"""

from __future__ import annotations

import torch

from . import cuda_lib

I32_MAX = 2**31 - 1


def _bits(n: int) -> int:
    """ceil(log2(max(n, 2))), at least 1."""
    return max(1, (max(n, 2) - 1).bit_length())


def sort_i32_plain(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(keys, dim=-1).values


def sort_i32(keys: torch.Tensor) -> torch.Tensor:
    """keys: [N] or [B, N] int32 -> sorted ascending along the last axis."""
    if cuda_lib.runs_plain("sort_i32", keys):
        return sort_i32_plain(keys)
    squeeze = keys.dim() == 1
    keys2 = keys[None] if squeeze else keys
    if keys2.dim() != 2:
        raise ValueError(f"sort_i32: expected [N] or [B, N], got {tuple(keys.shape)}")
    b, n = keys2.shape
    cuda_lib.check_cuda_inputs("sort_i32", torch.int32, (b, n), keys2.contiguous())
    if b == 0 or n == 0:
        return keys.clone()
    n_pad = max(256, 1 << (n - 1).bit_length())
    buf = torch.full((b, n_pad), I32_MAX, dtype=torch.int32, device=keys.device)
    buf[:, :n] = keys2
    cuda_lib.library().call("tn_sort_i32", buf.data_ptr(), b, n_pad, cuda_lib.stream_of(buf))
    sort_i32.launches += 1
    out = buf[:, :n]
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
