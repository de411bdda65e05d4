"""Volumetric renderer: field + decoders + marcher + contraction + occupancy
+ transmittance weights + compositing, for serving and training.

Counterpart of `NerfRenderer` in `tinynerf_tpu/core/renderer.py`.  Two
paths with static shapes:

  * `render_dense` evaluates every one of the [n_rays, n_samples] marched
    positions, with a validity mask (the reference semantics);
  * `render_packed` compacts the first `cap` valid samples, in ray-major
    order, into a flat buffer; the field and decoders run on those `cap`
    samples only, the weights come from a segmented scan over the packed
    rays and each ray's color and opacity from a segment sum (in a fixed
    order on the card, so a view repeats itself bit for bit), and rays
    whose samples spilled past `cap` come back flagged (`ray_valid = 0`) so
    the caller can re-render them densely.

Both marchers run through both paths: the AABB one (box entry, uniform
steps, the box mask) and the unbounded one (the disparity grid and the
Mip-360 contraction, whose mask is all ones).

The weights ops and their gradients are picked by the tensors' device (the
JAX package picks by `jax.default_backend()`): on a CUDA tensor the
hand-written kernels (`ops/segscan.py`, `ops/weights_dense.py`), on a CPU
tensor their plain versions.  Parameters live in the field and decoder
modules, and gradients flow to them through both paths (serving calls
them under `torch.inference_mode()`).  At train time every
sample is jittered by the stateless hash of `ops/hashrng.py`, seeded with
two uint32 words, and a field with dropout (Cobafa) gets two more words
for its mask, where the JAX package's renderer passes `fold_in(key, 1)`;
`sigma_fn` and serving pass none.  `render_packed` marches densely (every
sample point queried against the occupancy grid) or, with `march="skip"`
and the skip grid of the current occupancy state (`skip_grid`), with the
empty-space-skipping march of its marcher (`core/skipmarch.py`, a CUDA
kernel on the card): the same sample set, found in at most `skip_steps`
rounds per ray instead of `n_samples` queries; rays that exhaust that
budget come back flagged (`ray_valid = 0`, `n_complete`).

`remat_field` recomputes the field's activations in the backward
(`torch.utils.checkpoint`, the JAX package's `jax.checkpoint`) instead of
keeping them, when gradients are recorded; the recomputed forward gets the
same inputs and dropout words, and the dropout hash is stateless, so it
gives the same values.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from ..models.cobafa import CobafaFeatureField
from ..ops.hashrng import hash_u01
from ..ops.segscan import compute_weights_packed, segment_sum
from ..ops.weights_dense import compute_weights_dense
from ..utils.device import device_constant
from ..utils.trace import span
from .contraction import ContractionAABB, ContractionMip360
from .marching import RayMarcherAABB, RayMarcherUnbounded
from .occupancy import OccupancyGrid, OccupancyState
from .skipmarch import make_skip_grid, make_skip_grid_iso, skip_march, skip_march_unbounded


class RenderOutput(NamedTuple):
    rgb: torch.Tensor        # [n_rays, 3] composited colors
    opacity: torch.Tensor    # [n_rays] sum of weights
    ray_valid: torch.Tensor  # [n_rays] float32; 0 where the packed buffer overflowed
    n_samples: torch.Tensor  # scalar int: valid samples this batch (fill metric)
    # scalar int: rays that finished marching (n_rays except on the skip
    # path, where the round budget may run out)
    n_complete: torch.Tensor


def compact(maskb: torch.Tensor, cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The packed path's compaction of the valid samples `maskb` [R, S]:
    the first `cap` in ray-major order, padded with index R * S
    (jnp.nonzero(size=cap)'s fill), without a host sync: each valid
    sample's rank is a cumsum, and ranks below `cap` scatter their flat
    index into the buffer (slot `cap` takes the rest and is dropped).
    Returns (is_pad [cap], the flat index with pads at 0 [cap], the ray of
    each sample with pads at R [cap])."""
    n_rays, n_samples = maskb.shape
    total = n_rays * n_samples
    flat = maskb.reshape(-1)
    rank = torch.cumsum(flat, dim=0) - 1
    slot = torch.where(flat & (rank < cap), rank, cap)
    valid_idx = torch.full((cap + 1,), total, dtype=torch.long, device=maskb.device)
    valid_idx.scatter_(0, slot, torch.arange(total, device=maskb.device))
    valid_idx = valid_idx[:cap]
    is_pad = valid_idx >= total
    safe_idx = torch.where(is_pad, 0, valid_idx)
    return is_pad, safe_idx, torch.where(is_pad, n_rays, safe_idx // n_samples)


class NerfRenderer(nn.Module):
    def __init__(
        self,
        field: nn.Module,
        sigma_decoder: nn.Module,
        rgb_decoder: nn.Module,
        marcher: Union[RayMarcherAABB, RayMarcherUnbounded],
        contraction: Union[ContractionAABB, ContractionMip360],
        occupancy: Optional[OccupancyGrid] = None,
        bg_color: Optional[Tuple[float, float, float]] = None,
        early_termination: float = 1e-4,
        compute_dtype: torch.dtype = torch.float32,
        skip_steps: int = 96,
        remat_field: bool = False,
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
        # round budget per ray of the skip march; rays needing more are
        # flagged incomplete
        self.skip_steps = skip_steps
        self.remat_field = remat_field

    # ------------------------------------------------------------- sub-fns

    def _field_apply(self, x: torch.Tensor, dropout_seed=None) -> tuple:
        """The field's feature pieces; `dropout_seed` (two uint32 words)
        reaches only a field with dropout.  With `remat_field`, and only
        while gradients are recorded, through a checkpoint."""
        if dropout_seed is not None and isinstance(self.field, CobafaFeatureField):
            fn = lambda xx: self.field.apply_pieces(xx, self.compute_dtype, dropout_seed=dropout_seed)
        else:
            fn = lambda xx: self.field.apply_pieces(xx, self.compute_dtype)
        if self.remat_field and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)
        return fn(x)

    def sigma_fn(self, x: torch.Tensor) -> torch.Tensor:
        """Density at contracted coords [n, 3] -> [n]; feeds occupancy updates."""
        feats = self._field_apply(x)
        return self.sigma_decoder(feats, self.compute_dtype)

    def _weights_dense(self, sigmas, deltas, maskf):
        return compute_weights_dense(sigmas.float().contiguous(), deltas.contiguous(),
                                     maskf.contiguous(), self.early_termination)

    def _march(self, rays_o, rays_d, occ_state: Optional[OccupancyState], jitter_seed=None):
        """Sample positions (contracted), step sizes and the validity mask.
        With `jitter_seed` (two uint32 words) every sample moves by
        u * delta, u = hash_u01(seed, ray, sample): the JAX package's
        train-time jitter, given the words of its `fold_in(key, 0)`."""
        t, deltas = self.marcher(rays_o, rays_d)
        if jitter_seed is not None:
            dev = rays_o.device
            u = hash_u01(
                jitter_seed,
                torch.arange(rays_o.shape[0], device=dev)[:, None],
                torch.arange(t.shape[1], device=dev)[None, :],
            )
            t = t + u * deltas
        pos = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
        cpos, maskf = self.contraction(pos)
        if self.occupancy is not None and occ_state is not None:
            maskf = maskf * self.occupancy.query(occ_state, cpos)
        return cpos, deltas, maskf

    # ------------------------------------------------------- skip marching

    @property
    def supports_skip_march(self) -> bool:
        """Skip grids are built from, and probed at, nearest-voxel occupancy.
        The cone grids certify straight contracted-space rays (the AABB
        marcher); the isotropic grid the curved paths of the unbounded
        marcher, with the advance bound of the order-inf contraction."""
        if self.occupancy is None or self.occupancy.interp != "nearest":
            return False
        aabb = isinstance(self.marcher, RayMarcherAABB) and isinstance(self.contraction, ContractionAABB)
        unbounded = (isinstance(self.marcher, RayMarcherUnbounded) and isinstance(self.contraction, ContractionMip360)
                     and self.contraction.order == float("inf"))
        return aabb or unbounded

    def skip_grid(self, occ_state: OccupancyState) -> torch.Tensor:
        """The skip grid of the thresholded occupancy state: the cone grids
        [6, r0, r1, r2] for the AABB marcher, the isotropic grid [r, r, r]
        for the unbounded one.  Rebuilt at each occupancy update, never
        checkpointed."""
        if not self.supports_skip_march:
            raise ValueError("this renderer does not support skip marching")
        with span("occupancy.skip_grid"):
            occ = occ_state.grid > self.occupancy._threshold(occ_state)
            return make_skip_grid_iso(occ) if isinstance(self.marcher, RayMarcherUnbounded) else make_skip_grid(occ)

    def _march_skip(self, rays_o, rays_d, skip_grid, jitter_seed=None):
        """Skip-marching front half: the candidate grid [R, skip_steps] whose
        valid entries are exactly the dense march's surviving samples, with
        positions recomputed by the dense march's operations, and the
        per-ray completeness flag."""
        if isinstance(self.marcher, RayMarcherUnbounded):
            k_idx, complete = skip_march_unbounded(
                rays_o, rays_d, self.marcher, self.contraction, skip_grid, jitter_seed, self.skip_steps)
            kk = torch.clamp(k_idx, min=0)
            # positions and steps from the dense march's own grid
            t_grid, d_grid = self.marcher.grid_on(rays_o.device)
            t, deltas = t_grid[kk], d_grid[kk]
        else:
            t_min, t_exit = self.marcher.entry_exit(rays_o, rays_d)
            step = self.marcher.step_size
            k_idx, complete = skip_march(
                rays_o, rays_d, t_min, t_exit, step, self.marcher.n_samples,
                self.contraction.aabb, skip_grid, jitter_seed, self.skip_steps,
            )
            kk = torch.clamp(k_idx, min=0)
            delta = np.float32(step).item()
            t = t_min[:, None] + kk.float() * delta
            deltas = torch.full_like(t, delta)
        if jitter_seed is not None:
            u = hash_u01(jitter_seed, torch.arange(rays_o.shape[0], device=rays_o.device)[:, None], kk)
            t = t + u * deltas
        pos = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
        cpos, _ = self.contraction(pos)
        return cpos, deltas, (k_idx >= 0).float(), complete

    def _composite(self, weighted_rgb_sum, opacity):
        if self.bg_color is not None:
            bg = device_constant(tuple(self.bg_color), torch.float32, opacity.device)
            return weighted_rgb_sum + bg * (1.0 - opacity[..., None])
        return weighted_rgb_sum

    # ---------------------------------------------------------- dense path

    def render_dense(
        self, occ_state: Optional[OccupancyState], rays_o: torch.Tensor,
        rays_d: torch.Tensor, jitter_seed=None, dropout_seed=None,
    ) -> RenderOutput:
        with span("render.march"):
            cpos, deltas, maskf = self._march(rays_o, rays_d, occ_state, jitter_seed)
        with span("render.field"):
            feats = self._field_apply(cpos, dropout_seed)
        with span("render.decode"):
            sigmas = self.sigma_decoder(feats, self.compute_dtype)
            w = self._weights_dense(sigmas, deltas, maskf)
            dirs = rays_d[:, None, :].expand(cpos.shape)
            rgbs = self.rgb_decoder(feats, dirs, self.compute_dtype)
            acc_rgb = torch.sum(w[..., None] * rgbs, dim=-2)
            opacity = torch.sum(w, dim=-1)
            return RenderOutput(
                rgb=self._composite(acc_rgb, opacity),
                opacity=opacity,
                ray_valid=torch.ones(rays_o.shape[0], dtype=torch.float32, device=rays_o.device),
                n_samples=maskf.sum().long(),
                n_complete=torch.full((), rays_o.shape[0], device=rays_o.device),
            )

    # --------------------------------------------------------- packed path

    def render_packed(
        self, occ_state: Optional[OccupancyState], rays_o: torch.Tensor,
        rays_d: torch.Tensor, cap: int, jitter_seed=None, dropout_seed=None,
        rgb_dir_branch: str = "sample", march: str = "dense",
        skip_grid: Optional[torch.Tensor] = None,
    ) -> RenderOutput:
        """Fixed-capacity packed rendering.  `rgb_dir_branch="ray"` runs the
        rgb decoder's direction branch once per ray and gathers it to the
        samples (serving; the same values as "sample", the per-sample branch
        training uses, as in the JAX package).  `march="skip"` takes the
        candidates from the skip march over `skip_grid` (`skip_grid()` of
        the occupancy state); rays that exhaust its round budget are flagged
        invalid."""
        with span("render.march"):
            n_rays = rays_o.shape[0]
            if march == "skip":
                if skip_grid is None:
                    raise ValueError("march='skip' needs a skip_grid")
                cpos, deltas, maskf, complete = self._march_skip(rays_o, rays_d, skip_grid, jitter_seed)
                n_samples = self.skip_steps  # the candidate grid's width
            elif march == "dense":
                cpos, deltas, maskf = self._march(rays_o, rays_d, occ_state, jitter_seed)
                complete = None
                n_samples = self.marcher.n_samples
            else:
                raise ValueError(f"unknown march {march!r}")
            total = n_rays * n_samples
            dev = rays_o.device
            maskb = maskf > 0.0
            # --- compaction: the first `cap` valid samples in ray-major order
            is_pad, safe_idx, seg_ids = compact(maskb, cap)
            cpos_cap = cpos.reshape(total, 3)[safe_idx]
            ray_of = torch.where(is_pad, 0, seg_ids)

        # --- the field and decoders run on exactly `cap` samples
        with span("render.field"):
            feats_cap = self._field_apply(cpos_cap, dropout_seed)
        with span("render.decode"):
            sigma_cap = self.sigma_decoder(feats_cap, self.compute_dtype)

            # --- transmittance directly on the packed layout: segment k is ray
            # k; the pad tail (id n_rays) lies outside the n_rays segments and
            # gets weight 0, as its valid = 0 gives
            valid_cap = 1.0 - is_pad.float()
            delta_cap = deltas.reshape(total)[safe_idx]
            seg32 = seg_ids.to(torch.int32)
            w_cap = compute_weights_packed(
                sigma_cap.float().contiguous(), delta_cap.contiguous(), valid_cap,
                seg32, self.early_termination, n_segments=n_rays,
            )

            if rgb_dir_branch == "ray":
                rgbs_cap = self.rgb_decoder.apply_per_ray(feats_cap, rays_d, ray_of, self.compute_dtype)
            else:
                rgbs_cap = self.rgb_decoder(feats_cap, rays_d[ray_of], self.compute_dtype)

            # --- per-ray reduction: one segment sum of (w * rgb, w), in a fixed
            # order on the card; the pad tail (id n_rays) is dropped
            sums = segment_sum(torch.cat([w_cap[:, None] * rgbs_cap, w_cap[:, None]], dim=1), seg32, n_rays)
            acc_rgb, opacity = sums[:, :3], sums[:, 3]

            # --- rays whose samples spilled past `cap`, or whose skip march ran
            # out of rounds, are flagged; zero-sample rays render exact bg and
            # always stay valid
            counts = maskb.sum(dim=-1)
            ends = torch.cumsum(counts, dim=0)
            ray_valid = ((ends <= cap) | (counts == 0)).float()
            if complete is not None:
                ray_valid = ray_valid * complete.float()
            return RenderOutput(
                rgb=self._composite(acc_rgb, opacity),
                opacity=opacity,
                ray_valid=ray_valid,
                n_samples=torch.clamp(counts.sum(), max=cap),
                n_complete=complete.sum() if complete is not None else torch.full((), n_rays, device=dev),
            )
