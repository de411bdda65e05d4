"""Truncated exponential, forward only.

Counterpart of `tinynerf_tpu/ops/trunc_exp.py:_fwd_value`.  With
`clamp_forward` the argument is clipped to [-15, 15] first (an inf guard:
exp(15) ~ 3.3e6 is far past opaque); without it this is a plain exp (the
reference's forward).  The clamped backward waits for the training slice.
"""

from __future__ import annotations

import torch


def truncated_exp(x: torch.Tensor, clamp_forward: bool = True) -> torch.Tensor:
    if clamp_forward:
        return torch.exp(torch.clamp(x, -15.0, 15.0))
    return torch.exp(x)
