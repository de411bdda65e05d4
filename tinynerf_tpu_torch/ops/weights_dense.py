"""Dense [R, S] transmittance weights through hand-written CUDA kernels.

Counterpart of `tinynerf_tpu/ops/weights_pallas.py` (the forward
`_fwd_kernel` and the backward `_bwd_kernel`).  On CUDA tensors
`compute_weights_dense` launches `csrc/weights_dense.cu` (one warp per ray
row, a shuffle scan per chunk of 32 samples with the carry in a register)
and its gradient launches the backward kernel of the same file; on CPU
tensors both run the plain versions, `ops.weights`.  A CUDA input the
kernels cannot take raises; nothing falls back.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .weights import compute_weights as compute_weights_dense_plain
from .weights import compute_weights_bwd, compute_weights_value


def _check(name: str, *tensors) -> tuple:
    if tensors[0].dim() != 2:
        raise ValueError(f"{name}: expected [R, S], got {tuple(tensors[0].shape)}")
    cuda_lib.check_cuda_inputs(name, torch.float32, tensors[0].shape, *tensors)
    return tuple(tensors[0].shape)


def weights_dense_fwd(sigmas, deltas, maskf, threshold: float) -> torch.Tensor:
    """The forward value: kernel on CUDA tensors, plain on CPU tensors."""
    if cuda_lib.runs_plain("compute_weights_dense", sigmas, deltas, maskf):
        return compute_weights_value(sigmas, deltas, maskf, threshold)
    r, s = _check("compute_weights_dense", sigmas, deltas, maskf)
    out = torch.empty_like(sigmas)
    if r and s:
        cuda_lib.library().call(
            "tn_weights_dense", sigmas.data_ptr(), deltas.data_ptr(),
            maskf.data_ptr(), r, s, float(threshold), out.data_ptr(),
            cuda_lib.stream_of(sigmas),
        )
        compute_weights_dense.launches += 1
    return out


def weights_dense_bwd(sigmas, deltas, maskf, w, g) -> torch.Tensor:
    """d loss / d sigmas: kernel on CUDA tensors, plain on CPU tensors."""
    if cuda_lib.runs_plain("weights_dense_bwd", sigmas, deltas, maskf, w, g):
        return compute_weights_bwd(sigmas, deltas, maskf, w, g)
    g = g.contiguous()
    r, s = _check("weights_dense_bwd", sigmas, deltas, maskf, w, g)
    out = torch.empty_like(sigmas)
    if r and s:
        cuda_lib.library().call(
            "tn_weights_dense_bwd", sigmas.data_ptr(), deltas.data_ptr(),
            maskf.data_ptr(), w.data_ptr(), g.data_ptr(), r, s, out.data_ptr(),
            cuda_lib.stream_of(sigmas),
        )
        weights_dense_bwd.launches += 1
    return out


weights_dense_bwd.launches = 0


class _WeightsDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigmas, deltas, maskf, threshold):
        w = weights_dense_fwd(sigmas, deltas, maskf, threshold)
        ctx.save_for_backward(sigmas, deltas, maskf, w)
        return w

    @staticmethod
    def backward(ctx, g):
        sigmas, deltas, maskf, w = ctx.saved_tensors
        return weights_dense_bwd(sigmas, deltas, maskf, w, g), None, None, None


def compute_weights_dense(
    sigmas: torch.Tensor, deltas: torch.Tensor, maskf: torch.Tensor,
    threshold: float = 1e-4,
) -> torch.Tensor:
    """Drop-in for `ops.weights.compute_weights` on [R, S] float32 inputs,
    gradients to sigmas through the backward kernel."""
    return _WeightsDense.apply(sigmas, deltas, maskf, threshold)


compute_weights_dense.launches = 0
