"""Per-ray transmittance / rendering weights on the dense [R, S] layout.

Counterpart of `tinynerf_tpu/ops/weights.py` (forward only): per ray, with
s_k = sigma_k * delta_k * m_k,

    w_k = T_k * (1 - exp(-s_k)),      T_k = exp(-sum_{j<k} s_j),

and w_k = 0 where m_k = 0 or T_k <= threshold (branch-free early
termination).  This plain PyTorch form is the semantic contract; the CUDA
kernel in `ops/weights_dense.py` is held against it.
"""

from __future__ import annotations

import torch


def compute_weights(
    sigmas: torch.Tensor, deltas: torch.Tensor, maskf: torch.Tensor,
    threshold: float = 1e-4,
) -> torch.Tensor:
    """sigmas/deltas/maskf: [..., S] float32 -> weights [..., S]."""
    s = sigmas * deltas * maskf
    c_incl = torch.cumsum(s, dim=-1)
    t_before = torch.exp(-(c_incl - s))  # transmittance BEFORE sample k
    w = t_before * (1.0 - torch.exp(-s))
    return torch.where((maskf > 0.0) & (t_before > threshold), w, 0.0)
