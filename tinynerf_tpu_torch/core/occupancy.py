"""Occupancy grid: state, adaptive threshold, the nearest-voxel and
trilinear queries and the decay/confirm update.

Counterpart of `tinynerf_tpu/core/occupancy.py`: the grid is explicit
state (`OccupancyState`, a NamedTuple of a `[r0, r1, r2]` float32 grid
indexed by (x, y, z) and its mean), queried at the nearest voxel in
align_corners index space (`interp="nearest"`) or trilinearly
(`"trilinear"`, the reference's grid_sample) against the threshold
min(base, mean).  An update evaluates the density at one jittered point
per voxel,

    grid = 1 if 1 - exp(-sigma * step_size) > threshold else decay * grid,

sweeping the grid in chunks of x-slices to bound the field's memory; a
data-parallel group splits the sweep into contiguous x-slabs, one per rank
(`update_slab`).  The jitter comes from an explicit `torch.Generator` (or is
passed in: jax.random and torch cannot give the same numbers).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..ops.interp import trilinear_lookup
from ..utils.device import device_constant

# field evaluations per chunk of the update sweep (16 x-slices of a 128^2
# plane): bounds the sigma field's activations to a few hundred MB
UPDATE_CHUNK_POINTS = 1 << 18


class OccupancyState(NamedTuple):
    grid: torch.Tensor  # [r0, r1, r2] float32
    mean: torch.Tensor  # scalar float32, grid.mean() after the last update


@dataclass(frozen=True)
class OccupancyGrid:
    size: Tuple[int, int, int]
    step_size: float
    threshold: float = 0.01
    decay: float = 0.95
    interp: str = "nearest"

    def __post_init__(self):
        if self.interp not in ("nearest", "trilinear"):
            raise ValueError(f"unknown occupancy interp {self.interp!r}")

    @staticmethod
    def cube(res: int, step_size: float, threshold: float = 0.01,
             decay: float = 0.95, interp: str = "nearest") -> "OccupancyGrid":
        return OccupancyGrid((res, res, res), step_size, threshold, decay, interp)

    def init_state(self, device=None) -> OccupancyState:
        return OccupancyState(
            grid=torch.ones(self.size, dtype=torch.float32, device=device),
            mean=torch.tensor(1.0, dtype=torch.float32, device=device),
        )

    def _threshold(self, state: OccupancyState) -> torch.Tensor:
        return torch.clamp(state.mean, max=self.threshold)

    def query(self, state: OccupancyState, coords: torch.Tensor) -> torch.Tensor:
        """coords: [..., 3] in [-1, 1] -> float32 mask (1.0 = occupied)."""
        thr = self._threshold(state)
        if self.interp == "trilinear":
            vals = trilinear_lookup(state.grid[..., None], coords)[..., 0]
            return (vals > thr).float()
        r0, r1, r2 = self.size

        def nearest_idx(c, res):
            x = (c + 1.0) * 0.5 * (res - 1)
            # torch.round is half-to-even, as jnp.round
            return torch.clamp(torch.round(x), 0, res - 1).long()

        ix = nearest_idx(coords[..., 0], r0)
        iy = nearest_idx(coords[..., 1], r1)
        iz = nearest_idx(coords[..., 2], r2)
        vals = state.grid.reshape(-1)[(ix * r1 + iy) * r2 + iz]
        return (vals > thr).float()

    def occupancy(self, state: OccupancyState) -> torch.Tensor:
        """Fraction of voxels considered occupied (a device scalar)."""
        return (state.grid > self._threshold(state)).float().mean()

    def update_slices(
        self,
        grid_slices: torch.Tensor,  # [n_slices, r1, r2]
        x_indices: torch.Tensor,  # [n_slices] voxel x index of each slice
        jitter: torch.Tensor,  # [n_slices, r1, r2, 3] uniform [0, 1)
        threshold: torch.Tensor,
        sigma_fn: Callable[[torch.Tensor], torch.Tensor],
    ) -> torch.Tensor:
        """Decay/confirm sweep over x-slices, in chunks of
        UPDATE_CHUNK_POINTS field evaluations."""
        _, r1, r2 = self.size
        dev = grid_slices.device
        size_f = device_constant(self.size, torch.float32, dev)
        yz = torch.stack(torch.meshgrid(
            torch.arange(r1, dtype=torch.float32, device=dev),
            torch.arange(r2, dtype=torch.float32, device=dev), indexing="ij"), dim=-1)
        per = max(1, UPDATE_CHUNK_POINTS // (r1 * r2))
        out = torch.empty_like(grid_slices)
        for a in range(0, grid_slices.shape[0], per):
            xi = x_indices[a : a + per].float()
            c = xi.shape[0]
            idx = torch.cat([xi[:, None, None, None].expand(c, r1, r2, 1),
                             yz.expand(c, r1, r2, 2)], dim=-1)  # voxel (x, y, z)
            coords = -1.0 + 2.0 * (idx + jitter[a : a + per]) / size_f
            sigma = sigma_fn(coords.reshape(-1, 3)).float().reshape(c, r1, r2)
            alpha = 1.0 - torch.exp(-sigma * self.step_size)
            out[a : a + per] = torch.where(alpha > threshold, 1.0, self.decay * grid_slices[a : a + per])
        return out

    def update_slab(
        self,
        state: OccupancyState,
        sigma_fn: Callable[[torch.Tensor], torch.Tensor],
        jitter: torch.Tensor,
        slab: int,
        n_slabs: int,
    ) -> torch.Tensor:
        """x-slab `slab` of `n_slabs` (r0 / n_slabs contiguous slices; r0
        must divide) of the grid `update(state, sigma_fn, jitter=jitter)`
        gives, computed from that slab's slices and jitter alone."""
        r0 = self.size[0]
        if r0 % n_slabs:
            raise ValueError(f"{r0} grid slices do not split into {n_slabs} slabs")
        lo, hi = slab * r0 // n_slabs, (slab + 1) * r0 // n_slabs
        with torch.no_grad():
            return self.update_slices(
                state.grid[lo:hi], torch.arange(lo, hi, device=state.grid.device), jitter[lo:hi],
                self._threshold(state), sigma_fn,
            )

    def update(
        self,
        state: OccupancyState,
        sigma_fn: Callable[[torch.Tensor], torch.Tensor],
        generator: Optional[torch.Generator] = None,
        jitter: Optional[torch.Tensor] = None,
    ) -> OccupancyState:
        """One full sweep: one jittered sigma sample per voxel.  `sigma_fn`
        maps [n, 3] contracted coords to [n] densities; `jitter` [r0, r1,
        r2, 3] in [0, 1) is drawn from `generator` when not given."""
        dev = state.grid.device
        if jitter is None:
            jitter = torch.rand((*self.size, 3), generator=generator, device=dev)
        with torch.no_grad():
            grid = self.update_slices(
                state.grid, torch.arange(self.size[0], device=dev), jitter,
                self._threshold(state), sigma_fn,
            )
        return OccupancyState(grid=grid, mean=grid.mean())
