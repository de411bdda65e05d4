"""Segmented scan over packed per-ray samples, and the packed weights on it.

Counterpart of `tinynerf_tpu/ops/segscan.py` (forward only).  On a CUDA
tensor each entry point launches the hand-written kernel in
`csrc/segscan.cu` (one warp per segment, the carry in a register); on a CPU
tensor it runs the plain PyTorch version beside it.  There is no fallback
between the two: a CUDA input that the kernel cannot take raises.

Input rule for the kernel: segment ids are contiguous runs in ASCENDING
order (the renderer's ray-major ids are; `core/renderer.py`).  The JAX op
accepts any contiguous ids, and so does the plain version here.

`n_segments`: when given, segments are the ids `0 .. n_segments-1` and
their starts come from a sorted search on the device (no host sync); a
sample whose id lies outside that range is left out of every scan and comes
out 0 (the renderer passes `n_rays`, so its pad tail, id `n_rays`, gets
weight 0, exactly as its `valid = 0` gives in the JAX op).  When None, the
segment boundaries are found from the ids themselves, which costs one host
sync on the CUDA path.

Sums stay segment-local in both versions: the kernel scans each segment on
its own, and the plain version takes a float64 global cumsum minus each
segment's base, so neither loses f32 precision to the buffer's total optical
depth (the concern of `tinynerf_tpu/ops/segscan.py:13-15`).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib


# ------------------------------------------------------------------- plain


def _in_range(seg: torch.Tensor, n_segments: Optional[int]) -> Optional[torch.Tensor]:
    if n_segments is None:
        return None
    return (seg >= 0) & (seg < n_segments)


def segmented_cumsum_plain(
    x: torch.Tensor, seg: torch.Tensor, n_segments: Optional[int] = None
) -> torch.Tensor:
    """Plain PyTorch segment-local inclusive cumsum (any contiguous ids)."""
    n = x.shape[0]
    if n == 0:
        return x.clone()
    idx = torch.arange(n, device=x.device)
    is_start = torch.ones(n, dtype=torch.bool, device=x.device)
    is_start[1:] = seg[1:] != seg[:-1]
    start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    g = torch.cumsum(x.double(), dim=0)
    out = (g - (g - x.double())[start]).to(x.dtype)
    keep = _in_range(seg, n_segments)
    return out if keep is None else torch.where(keep, out, 0.0)


def compute_weights_packed_plain(
    sigmas, deltas, valid, seg, threshold: float = 1e-4,
    n_segments: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch packed weights (`segscan.py:_weights_packed_fwd_math`)."""
    s = sigmas * deltas * valid
    c = segmented_cumsum_plain(s, seg)
    t_before = torch.exp(-(c - s))
    alpha = 1.0 - torch.exp(-s)
    keep = (valid > 0.0) & (t_before > threshold)
    in_range = _in_range(seg, n_segments)
    if in_range is not None:
        keep = keep & in_range
    return torch.where(keep, t_before * alpha, 0.0)


# ------------------------------------------------------------------ kernel


def segment_starts(seg: torch.Tensor, n_segments: Optional[int]) -> torch.Tensor:
    """int32 [n_seg + 1] start offsets of the contiguous runs of `seg`."""
    n = seg.shape[0]
    if n_segments is not None:
        ids = torch.arange(n_segments + 1, device=seg.device, dtype=seg.dtype)
        return torch.searchsorted(seg, ids, out_int32=True)
    bounds = torch.nonzero(seg[1:] != seg[:-1]).flatten().to(torch.int32) + 1
    edge = lambda v: torch.full((1,), v, dtype=torch.int32, device=seg.device)
    return torch.cat([edge(0), bounds, edge(n)]) if n else edge(0)


def segmented_cumsum(
    x: torch.Tensor, seg: torch.Tensor, n_segments: Optional[int] = None
) -> torch.Tensor:
    """Inclusive segment-local cumsum of a flat packed buffer.

    x: [n] float32; seg: [n] int32 segment ids in contiguous ascending runs.
    """
    if cuda_lib.runs_plain("segmented_cumsum", x, seg):
        return segmented_cumsum_plain(x, seg, n_segments)
    (n,) = x.shape
    cuda_lib.check_cuda_inputs("segmented_cumsum", torch.float32, (n,), x)
    cuda_lib.check_cuda_inputs("segmented_cumsum", torch.int32, (n,), seg)
    starts = segment_starts(seg, n_segments)
    out = torch.zeros_like(x)  # samples outside every listed segment stay 0
    n_seg = starts.shape[0] - 1
    if n_seg > 0:
        cuda_lib.library().call(
            "tn_segmented_cumsum", x.data_ptr(), starts.data_ptr(), n_seg,
            out.data_ptr(), cuda_lib.stream_of(x),
        )
        segmented_cumsum.launches += 1
    return out


segmented_cumsum.launches = 0


def compute_weights_packed(
    sigmas: torch.Tensor,
    deltas: torch.Tensor,
    valid: torch.Tensor,
    seg: torch.Tensor,
    threshold: float = 1e-4,
    n_segments: Optional[int] = None,
) -> torch.Tensor:
    """Rendering weights directly on the packed [cap] layout (forward).

    sigmas/deltas/valid: [cap] float32; seg: [cap] int32 ascending ids.
    Same values as `ops.weights.compute_weights` on the dense layout.
    """
    if cuda_lib.runs_plain("compute_weights_packed", sigmas, deltas, valid, seg):
        return compute_weights_packed_plain(
            sigmas, deltas, valid, seg, threshold, n_segments
        )
    (n,) = sigmas.shape
    cuda_lib.check_cuda_inputs(
        "compute_weights_packed", torch.float32, (n,), sigmas, deltas, valid
    )
    cuda_lib.check_cuda_inputs("compute_weights_packed", torch.int32, (n,), seg)
    starts = segment_starts(seg, n_segments)
    out = torch.zeros_like(sigmas)  # samples outside every listed segment: 0
    n_seg = starts.shape[0] - 1
    if n_seg > 0:
        cuda_lib.library().call(
            "tn_weights_packed", sigmas.data_ptr(), deltas.data_ptr(),
            valid.data_ptr(), starts.data_ptr(), n_seg, float(threshold),
            out.data_ptr(), cuda_lib.stream_of(sigmas),
        )
        compute_weights_packed.launches += 1
    return out


compute_weights_packed.launches = 0
