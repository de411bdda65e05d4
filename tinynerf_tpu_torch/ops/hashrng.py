"""Stateless per-(ray, sample) jitter hash, bit-exact with the JAX package.

Counterpart of `tinynerf_tpu/ops/hashrng.py`: a murmur3 fmix32 finalizer
over (seed, ray, sample) gives the same uniform in [0, 1) any time a
(ray, sample) pair is queried.  The JAX package computes it in uint32;
torch has no full uint32 arithmetic, so here every value is an int64
holding a uint32, and each product is taken modulo 2^32 from 16-bit halves
(no int64 overflow).  The seed is two uint32 words: the JAX package takes
them from a PRNG key, which torch cannot reproduce, so callers pass the
words in (python ints or an int64 tensor of two).
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64, c a uint32."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_u01(seed, ray_ids: torch.Tensor, sample_ids: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) float32 per (ray, sample), stateless.

    seed: two uint32 words (the raw words of a JAX PRNG key give the JAX
    package's values); ray_ids / sample_ids: broadcastable integer tensors.
    """
    s0, s1 = seed[0], seed[-1]
    if isinstance(s0, torch.Tensor):
        s0, s1 = s0.long() & _M32, s1.long() & _M32
    else:
        s0, s1 = int(s0) & _M32, int(s1) & _M32
    h = (_mul32(ray_ids.long() & _M32, 0x9E3779B9)
         + _mul32(sample_ids.long() & _M32, 0x7FEB352D) + s0) & _M32
    h = _mix(h ^ s1)
    # top 24 bits -> [0, 1), exactly representable in f32
    return (h >> 8).float() * (1.0 / (1 << 24))
