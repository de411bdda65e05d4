"""Occupancy grid: state, adaptive threshold and the nearest-voxel query.

Counterpart of `tinynerf_tpu/core/occupancy.py` for serving: the grid is
explicit state (`OccupancyState`, a NamedTuple of a `[r0, r1, r2]` float32
grid indexed by (x, y, z) and its mean), queried at the nearest voxel in
align_corners index space against the threshold min(base, mean).  The
decay/confirm update and the trilinear query come with training
(ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch


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
        if self.interp != "nearest":
            raise NotImplementedError(
                "only the nearest-voxel occupancy query is ported (ROADMAP.md Queue 1)"
            )

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
