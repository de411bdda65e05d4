"""Truncated exponential: exp with a gradient-explosion guard.

Counterpart of `tinynerf_tpu/ops/trunc_exp.py`.  The backward is
g * exp(clamp(x, -15, 15)) whatever the forward, so one sample with a huge
pre-activation cannot blow up the gradient.  With `clamp_forward` the
forward argument is clipped to [-15, 15] too (an inf guard: exp(15) ~ 3.3e6
is far past opaque); without it the forward is a plain exp (the
reference's).
"""

from __future__ import annotations

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, clamp_forward):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp(x, -15.0, 15.0) if clamp_forward else x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0)), None


def truncated_exp(x: torch.Tensor, clamp_forward: bool = True) -> torch.Tensor:
    return _TruncExp.apply(x, clamp_forward)
