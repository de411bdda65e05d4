"""NeRF positional (frequency) encoding.

Counterpart of `tinynerf_tpu/models/encodings.py`: frequencies 2^k * pi for
k in [0, n_freqs), per input coordinate the layout
[sin(f_0 x) .. sin(f_K x), cos(f_0 x) .. cos(f_K x)], output dim
in_dim * 2 * n_freqs.  Written elementwise (`x[..., None] * freqs`); the
JAX package's one-hot-matmul form at Precision.HIGHEST computes the same
single f32 product per lane.
"""

from __future__ import annotations

import math

import torch

from ..utils.device import device_constant


def positional_encoding(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """x: [..., d] -> [..., d * 2 * n_freqs]."""
    freqs = device_constant(tuple(2.0**k * math.pi for k in range(n_freqs)), x.dtype, x.device)
    xf = x[..., None] * freqs  # [..., d, K]
    enc = torch.cat([torch.sin(xf), torch.cos(xf)], dim=-1)  # [..., d, 2K]
    return enc.reshape(*x.shape[:-1], x.shape[-1] * 2 * n_freqs)


def posenc_dim(in_dim: int, n_freqs: int) -> int:
    return in_dim * 2 * n_freqs
