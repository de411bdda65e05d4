"""Volumetric renderer, forward: field + decoders + marcher + contraction +
occupancy + transmittance weights + compositing.

Counterpart of `NerfRenderer` in `tinynerf_tpu/core/renderer.py` for
serving.  Two paths with static shapes:

  * `render_dense` evaluates every one of the [n_rays, n_samples] marched
    positions, with a validity mask (the reference semantics);
  * `render_packed` compacts the first `cap` valid samples, in ray-major
    order, into a flat buffer; the field and decoders run on those `cap`
    samples only, the weights come from a segmented scan over the packed
    rays, and rays whose samples spilled past `cap` come back flagged
    (`ray_valid = 0`) so the caller can re-render them densely.

The weights op is picked by the tensors' device (the JAX package picks by
`jax.default_backend()`): on a CUDA tensor the hand-written kernels
(`ops/segscan.py`, `ops/weights_dense.py`), on a CPU tensor their plain
versions.  Parameters live in the field and decoder modules.  Marching is
the dense march (every sample point queried against the occupancy grid);
skip marching (`core/skipmarch.py`) is not ported yet, and selects exactly
the same sample set.  Forward only: call under `torch.inference_mode()`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops.segscan import compute_weights_packed
from ..ops.weights_dense import compute_weights_dense
from .contraction import ContractionAABB
from .marching import RayMarcherAABB
from .occupancy import OccupancyGrid, OccupancyState


class RenderOutput(NamedTuple):
    rgb: torch.Tensor        # [n_rays, 3] composited colors
    opacity: torch.Tensor    # [n_rays] sum of weights
    ray_valid: torch.Tensor  # [n_rays] float32; 0 where the packed buffer overflowed
    n_samples: torch.Tensor  # scalar int: valid samples this batch (fill metric)


class NerfRenderer(nn.Module):
    def __init__(
        self,
        field: nn.Module,
        sigma_decoder: nn.Module,
        rgb_decoder: nn.Module,
        marcher: RayMarcherAABB,
        contraction: ContractionAABB,
        occupancy: Optional[OccupancyGrid] = None,
        bg_color: Optional[Tuple[float, float, float]] = None,
        early_termination: float = 1e-4,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.field = field
        self.sigma_decoder = sigma_decoder
        self.rgb_decoder = rgb_decoder
        self.marcher = marcher
        self.contraction = contraction
        self.occupancy = occupancy
        self.bg_color = bg_color
        self.early_termination = early_termination
        self.compute_dtype = compute_dtype

    # ------------------------------------------------------------- sub-fns

    def _march(self, rays_o, rays_d, occ_state: Optional[OccupancyState]):
        """Sample positions (contracted), step sizes and the validity mask."""
        t, deltas = self.marcher(rays_o, rays_d)
        pos = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
        cpos, maskf = self.contraction(pos)
        if self.occupancy is not None and occ_state is not None:
            maskf = maskf * self.occupancy.query(occ_state, cpos)
        return cpos, deltas, maskf

    def _composite(self, weighted_rgb_sum, opacity):
        if self.bg_color is not None:
            bg = torch.tensor(self.bg_color, dtype=torch.float32, device=opacity.device)
            return weighted_rgb_sum + bg * (1.0 - opacity[..., None])
        return weighted_rgb_sum

    # ---------------------------------------------------------- dense path

    def render_dense(
        self, occ_state: Optional[OccupancyState], rays_o: torch.Tensor,
        rays_d: torch.Tensor,
    ) -> RenderOutput:
        cpos, deltas, maskf = self._march(rays_o, rays_d, occ_state)
        feats = self.field.apply_pieces(cpos, self.compute_dtype)
        sigmas = self.sigma_decoder(feats, self.compute_dtype)
        w = compute_weights_dense(
            sigmas.float().contiguous(), deltas.contiguous(), maskf.contiguous(),
            self.early_termination,
        )
        dirs = rays_d[:, None, :].expand(cpos.shape)
        rgbs = self.rgb_decoder(feats, dirs, self.compute_dtype)
        acc_rgb = torch.sum(w[..., None] * rgbs, dim=-2)
        opacity = torch.sum(w, dim=-1)
        return RenderOutput(
            rgb=self._composite(acc_rgb, opacity),
            opacity=opacity,
            ray_valid=torch.ones(rays_o.shape[0], dtype=torch.float32, device=rays_o.device),
            n_samples=maskf.sum().long(),
        )

    # --------------------------------------------------------- packed path

    def render_packed(
        self, occ_state: Optional[OccupancyState], rays_o: torch.Tensor,
        rays_d: torch.Tensor, cap: int,
    ) -> RenderOutput:
        """Fixed-capacity packed rendering, forward only.  The rgb decoder's
        direction branch runs once per ray (the JAX package's
        `rgb_dir_branch="ray"`, its serving form; same values as per sample)."""
        n_rays = rays_o.shape[0]
        cpos, deltas, maskf = self._march(rays_o, rays_d, occ_state)
        n_samples = self.marcher.n_samples
        total = n_rays * n_samples
        dev = rays_o.device
        maskb = maskf > 0.0

        # --- compaction: the first `cap` valid samples in ray-major order,
        # padded with index `total` (jnp.nonzero(size=cap)'s fill), without
        # a host sync: each valid sample's rank is a cumsum, and ranks below
        # `cap` scatter their flat index into the buffer (slot `cap` takes
        # the rest and is dropped)
        flat = maskb.reshape(-1)
        rank = torch.cumsum(flat, dim=0) - 1
        slot = torch.where(flat & (rank < cap), rank, cap)
        valid_idx = torch.full((cap + 1,), total, dtype=torch.long, device=dev)
        valid_idx.scatter_(0, slot, torch.arange(total, device=dev))
        valid_idx = valid_idx[:cap]
        is_pad = valid_idx >= total
        safe_idx = torch.where(is_pad, 0, valid_idx)
        seg_ids = torch.where(is_pad, n_rays, safe_idx // n_samples)

        cpos_cap = cpos.reshape(total, 3)[safe_idx]
        ray_of = torch.where(is_pad, 0, seg_ids)

        # --- the field and decoders run on exactly `cap` samples
        feats_cap = self.field.apply_pieces(cpos_cap, self.compute_dtype)
        sigma_cap = self.sigma_decoder(feats_cap, self.compute_dtype)

        # --- transmittance directly on the packed layout: segment k is ray
        # k; the pad tail (id n_rays) lies outside the n_rays segments and
        # gets weight 0, as its valid = 0 gives
        valid_cap = 1.0 - is_pad.float()
        delta_cap = deltas.reshape(total)[safe_idx]
        w_cap = compute_weights_packed(
            sigma_cap.float().contiguous(), delta_cap.contiguous(), valid_cap,
            seg_ids.to(torch.int32), self.early_termination, n_segments=n_rays,
        )

        rgbs_cap = self.rgb_decoder.apply_per_ray(feats_cap, rays_d, ray_of, self.compute_dtype)

        # --- per-ray reduction (a segment sum; pads land in row n_rays)
        acc_rgb = torch.zeros(n_rays + 1, 3, dtype=torch.float32, device=dev)
        acc_rgb.index_add_(0, seg_ids, w_cap[:, None] * rgbs_cap)
        opacity = torch.zeros(n_rays + 1, dtype=torch.float32, device=dev)
        opacity.index_add_(0, seg_ids, w_cap)
        acc_rgb, opacity = acc_rgb[:n_rays], opacity[:n_rays]

        # --- rays whose samples spilled past `cap` are flagged; zero-sample
        # rays render exact bg and always stay valid
        counts = maskb.sum(dim=-1)
        ends = torch.cumsum(counts, dim=0)
        ray_valid = ((ends <= cap) | (counts == 0)).float()
        return RenderOutput(
            rgb=self._composite(acc_rgb, opacity),
            opacity=opacity,
            ray_valid=ray_valid,
            n_samples=torch.clamp(counts.sum(), max=cap),
        )
