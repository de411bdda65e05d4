"""Segmented scan over packed per-ray samples, and the packed weights on it.

Counterpart of `tinynerf_tpu/ops/segscan.py`.  On a CUDA tensor each entry
point is ONE launch of a hand-written kernel in `csrc/segscan.cu` (a block
per tile of samples, a segmented scan inside the tile, the carry walked
back from the tile's edge), the gradient of `compute_weights_packed`
included; on a CPU tensor it runs the plain PyTorch version beside it.
There is no fallback between the two: a CUDA input that the kernel cannot
take raises.

Segment ids are contiguous runs (the renderer's ray-major ids are;
`core/renderer.py`), ascending or not, as in the JAX op; the kernel finds
the boundaries itself, from `seg[i] != seg[i-1]`.

`n_segments`: when given, a sample whose id lies outside `[0, n_segments)`
comes out 0 (the renderer passes `n_rays`, so its pad tail, id `n_rays`,
gets weight 0, exactly as its `valid = 0` gives in the JAX op); the kernel
writes those zeros itself.  When None, every id counts.

Sums stay segment-local in both versions: the kernel sums a segment's
samples before the tile, then scans the tile, and the plain version takes a
float64 global cumsum minus each segment's base, so neither loses f32
precision to the buffer's total optical depth (the concern of
`tinynerf_tpu/ops/segscan.py:13-15`).
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
    """Plain PyTorch packed weights (`segscan.py:_weights_packed_fwd_math`),
    forward value only."""
    s = sigmas * deltas * valid
    c = segmented_cumsum_plain(s, seg)
    t_before = torch.exp(-(c - s))
    alpha = 1.0 - torch.exp(-s)
    keep = (valid > 0.0) & (t_before > threshold)
    in_range = _in_range(seg, n_segments)
    if in_range is not None:
        keep = keep & in_range
    return torch.where(keep, t_before * alpha, 0.0)


def weights_packed_bwd_plain(
    sigmas, deltas, valid, seg, w, g, n_segments: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch d loss / d sigmas (`segscan.py:_cwp_bwd`): the strict
    segment suffix sum of w*g from a reversed segmented cumsum."""
    s = sigmas * deltas * valid
    c = segmented_cumsum_plain(s, seg)
    wg = w * g
    suffix_incl = segmented_cumsum_plain(wg.flip(0), seg.flip(0)).flip(0)
    grad = deltas * (torch.exp(-c) * g - (suffix_incl - wg)) * valid
    keep = _in_range(seg, n_segments)
    return grad if keep is None else torch.where(keep, grad, 0.0)


# ------------------------------------------------------------------ kernel


def _id_range(n_segments: Optional[int]) -> int:
    """The C entry points' id range: -1 for "every id counts"."""
    return -1 if n_segments is None else int(n_segments)


def _check_packed(name: str, seg, *floats) -> int:
    (n,) = floats[0].shape
    cuda_lib.check_cuda_inputs(name, torch.float32, (n,), *floats)
    cuda_lib.check_cuda_inputs(name, torch.int32, (n,), seg)
    return n


def segmented_cumsum(
    x: torch.Tensor, seg: torch.Tensor, n_segments: Optional[int] = None
) -> torch.Tensor:
    """Inclusive segment-local cumsum of a flat packed buffer.

    x: [n] float32; seg: [n] int32 segment ids in contiguous runs.
    """
    if cuda_lib.runs_plain("segmented_cumsum", x, seg):
        return segmented_cumsum_plain(x, seg, n_segments)
    n = _check_packed("segmented_cumsum", seg, x)
    out = torch.empty_like(x)  # the kernel writes every element
    if n > 0:
        cuda_lib.library().call(
            "tn_segmented_cumsum", x.data_ptr(), seg.data_ptr(), n, _id_range(n_segments),
            out.data_ptr(), cuda_lib.stream_of(x),
        )
        segmented_cumsum.launches += 1
    return out


segmented_cumsum.launches = 0


def weights_packed_fwd(sigmas, deltas, valid, seg, threshold, n_segments=None):
    """The forward value: kernel on CUDA tensors, plain on CPU tensors."""
    if cuda_lib.runs_plain("compute_weights_packed", sigmas, deltas, valid, seg):
        return compute_weights_packed_plain(sigmas, deltas, valid, seg, threshold, n_segments)
    n = _check_packed("compute_weights_packed", seg, sigmas, deltas, valid)
    out = torch.empty_like(sigmas)  # the kernel writes every element
    if n > 0:
        cuda_lib.library().call(
            "tn_weights_packed", sigmas.data_ptr(), deltas.data_ptr(), valid.data_ptr(),
            seg.data_ptr(), n, _id_range(n_segments), float(threshold), out.data_ptr(),
            cuda_lib.stream_of(sigmas),
        )
        compute_weights_packed.launches += 1
    return out


def weights_packed_bwd(sigmas, deltas, valid, seg, w, g, n_segments=None):
    """d loss / d sigmas of the packed weights: kernel on CUDA tensors, plain
    on CPU tensors.  Samples with an id outside `[0, n_segments)` (the pad
    tail) get 0."""
    if cuda_lib.runs_plain("weights_packed_bwd", sigmas, deltas, valid, seg, w, g):
        return weights_packed_bwd_plain(sigmas, deltas, valid, seg, w, g, n_segments)
    g = g.contiguous()
    n = _check_packed("weights_packed_bwd", seg, sigmas, deltas, valid, w, g)
    out = torch.empty_like(sigmas)  # the kernel writes every element
    if n > 0:
        cuda_lib.library().call(
            "tn_weights_packed_bwd", sigmas.data_ptr(), deltas.data_ptr(), valid.data_ptr(),
            seg.data_ptr(), w.data_ptr(), g.data_ptr(), n, _id_range(n_segments),
            out.data_ptr(), cuda_lib.stream_of(sigmas),
        )
        weights_packed_bwd.launches += 1
    return out


weights_packed_bwd.launches = 0


class _WeightsPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigmas, deltas, valid, seg, threshold, n_segments):
        w = weights_packed_fwd(sigmas, deltas, valid, seg, threshold, n_segments)
        ctx.save_for_backward(sigmas, deltas, valid, seg, w)
        ctx.n_segments = n_segments
        return w

    @staticmethod
    def backward(ctx, g):
        sigmas, deltas, valid, seg, w = ctx.saved_tensors
        grad = weights_packed_bwd(sigmas, deltas, valid, seg, w, g, ctx.n_segments)
        return grad, None, None, None, None, None


def compute_weights_packed(
    sigmas: torch.Tensor,
    deltas: torch.Tensor,
    valid: torch.Tensor,
    seg: torch.Tensor,
    threshold: float = 1e-4,
    n_segments: Optional[int] = None,
) -> torch.Tensor:
    """Rendering weights directly on the packed [cap] layout.

    sigmas/deltas/valid: [cap] float32; seg: [cap] int32 ids in contiguous runs.
    Same values as `ops.weights.compute_weights` on the dense layout;
    gradients flow to sigmas only (the closed form, `weights_packed_bwd`).
    """
    if not (torch.is_grad_enabled() and sigmas.requires_grad):
        # serving: no graph to record, and the Function's bookkeeping costs
        # more host time than the kernel takes on the device
        return weights_packed_fwd(sigmas, deltas, valid, seg, threshold, n_segments)
    return _WeightsPacked.apply(sigmas, deltas, valid, seg, threshold, n_segments)


compute_weights_packed.launches = 0
