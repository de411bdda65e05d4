"""Scene contraction into the unit cube [-1, 1]^3.

Counterpart of `ContractionAABB` in `tinynerf_tpu/core/contraction.py`: an
affine map of an axis-aligned box plus an inside-the-box mask (float32,
1.0 = valid).  The Mip-360 contraction comes with unbounded scenes
(ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class ContractionAABB:
    """`aabb` is ((min x, y, z), (max x, y, z))."""

    aabb: Tuple[Tuple[float, float, float], Tuple[float, float, float]]

    def __call__(self, coords: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        lo = torch.tensor(self.aabb[0], dtype=coords.dtype, device=coords.device)
        hi = torch.tensor(self.aabb[1], dtype=coords.dtype, device=coords.device)
        mask = torch.all((coords >= lo) & (coords <= hi), dim=-1).float()
        contracted = (coords - lo) / (hi - lo) * 2.0 - 1.0
        return contracted, mask
