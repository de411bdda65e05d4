"""Dense [R, S] transmittance weights through a hand-written CUDA kernel.

Counterpart of `tinynerf_tpu/ops/weights_pallas.py` (the forward,
`_fwd_kernel`).  On a CUDA tensor `compute_weights_dense` launches
`csrc/weights_dense.cu` (one warp per ray row, a shuffle scan per chunk of
32 samples with the carry in a register); on a CPU tensor it runs the plain
version, `ops.weights.compute_weights`.  A CUDA input the kernel cannot take
raises; nothing falls back.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .weights import compute_weights as compute_weights_dense_plain


def compute_weights_dense(
    sigmas: torch.Tensor, deltas: torch.Tensor, maskf: torch.Tensor,
    threshold: float = 1e-4,
) -> torch.Tensor:
    """Drop-in for `ops.weights.compute_weights` on [R, S] float32 inputs."""
    if cuda_lib.runs_plain("compute_weights_dense", sigmas, deltas, maskf):
        return compute_weights_dense_plain(sigmas, deltas, maskf, threshold)
    if sigmas.dim() != 2:
        raise ValueError(f"compute_weights_dense: expected [R, S], got {tuple(sigmas.shape)}")
    r, s = sigmas.shape
    cuda_lib.check_cuda_inputs(
        "compute_weights_dense", torch.float32, (r, s), sigmas, deltas, maskf
    )
    out = torch.empty_like(sigmas)
    if r and s:
        cuda_lib.library().call(
            "tn_weights_dense", sigmas.data_ptr(), deltas.data_ptr(),
            maskf.data_ptr(), r, s, float(threshold), out.data_ptr(),
            cuda_lib.stream_of(sigmas),
        )
        compute_weights_dense.launches += 1
    return out


compute_weights_dense.launches = 0
