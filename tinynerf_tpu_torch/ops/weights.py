"""Per-ray transmittance / rendering weights on the dense [R, S] layout.

Counterpart of `tinynerf_tpu/ops/weights.py`: per ray, with
s_k = sigma_k * delta_k * m_k,

    w_k = T_k * (1 - exp(-s_k)),      T_k = exp(-sum_{j<k} s_j),

and w_k = 0 where m_k = 0 or T_k <= threshold (branch-free early
termination), with the closed-form backward

    dL/dsigma_k = delta_k * m_k * (T_{k+1} g_k - sum_{j>k} w_j g_j)

(gradients flow to sigmas only).  This plain PyTorch form is the semantic
contract; the CUDA kernels in `ops/weights_dense.py` are held against it.
"""

from __future__ import annotations

import torch


def compute_weights_value(
    sigmas: torch.Tensor, deltas: torch.Tensor, maskf: torch.Tensor,
    threshold: float = 1e-4,
) -> torch.Tensor:
    """sigmas/deltas/maskf: [..., S] float32 -> weights [..., S] (no graph)."""
    s = sigmas * deltas * maskf
    c_incl = torch.cumsum(s, dim=-1)
    t_before = torch.exp(-(c_incl - s))  # transmittance BEFORE sample k
    w = t_before * (1.0 - torch.exp(-s))
    return torch.where((maskf > 0.0) & (t_before > threshold), w, 0.0)


def compute_weights_bwd(
    sigmas: torch.Tensor, deltas: torch.Tensor, maskf: torch.Tensor,
    w: torch.Tensor, g: torch.Tensor,
) -> torch.Tensor:
    """d loss / d sigmas from the weights w and their cotangent g
    (`tinynerf_tpu/ops/weights.py:_weights_bwd`)."""
    s = sigmas * deltas * maskf
    wg = w * g
    incl = torch.cumsum(wg, dim=-1)
    acc = incl - incl[..., -1:]  # -sum_{j>k} w_j g_j
    t_incl = torch.exp(-torch.cumsum(s, dim=-1))  # transmittance AFTER sample k
    return deltas * (acc + t_incl * g) * maskf


class _Weights(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigmas, deltas, maskf, threshold):
        w = compute_weights_value(sigmas, deltas, maskf, threshold)
        ctx.save_for_backward(sigmas, deltas, maskf, w)
        return w

    @staticmethod
    def backward(ctx, g):
        sigmas, deltas, maskf, w = ctx.saved_tensors
        return compute_weights_bwd(sigmas, deltas, maskf, w, g), None, None, None


def compute_weights(
    sigmas: torch.Tensor, deltas: torch.Tensor, maskf: torch.Tensor,
    threshold: float = 1e-4,
) -> torch.Tensor:
    """Rendering weights with the closed-form backward, on any device."""
    return _Weights.apply(sigmas, deltas, maskf, threshold)
