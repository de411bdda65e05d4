"""Scene contractions into the unit cube [-1, 1]^3.

Counterpart of `tinynerf_tpu/core/contraction.py`: each returns
(coords, valid mask), the mask float32 (1.0 = valid) so that it composes
with the weights.  `ContractionAABB` is an affine map of an axis-aligned
box with an inside-the-box mask; `ContractionMip360` (unbounded scenes) is
total, its mask all ones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..utils.device import device_constant


@dataclass(frozen=True)
class ContractionMip360:
    """Mip-NeRF-360 contraction with a p-norm (inf by default, the reference's
    train() wiring):

        x                       if ||x|| <= 1
        (2 - 1/||x||) x/||x||   otherwise

    then divided by 2, so that order inf lands in [-1, 1]^3.  The f32 ops
    run in the JAX package's order, `((2 - 1/safe) * x) / safe`, then `/ 2`."""

    order: float = float("inf")

    def __call__(self, coords: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.order == float("inf"):
            norm = torch.amax(torch.abs(coords), dim=-1, keepdim=True)
        else:
            norm = torch.linalg.vector_norm(coords, ord=self.order, dim=-1, keepdim=True)
        safe = torch.clamp(norm, min=1e-12)
        contracted = torch.where(norm <= 1.0, coords, (2.0 - 1.0 / safe) * coords / safe)
        contracted = contracted / 2.0
        mask = torch.ones(coords.shape[:-1], dtype=torch.float32, device=coords.device)
        return contracted, mask


@dataclass(frozen=True)
class ContractionAABB:
    """`aabb` is ((min x, y, z), (max x, y, z))."""

    aabb: Tuple[Tuple[float, float, float], Tuple[float, float, float]]

    def __call__(self, coords: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        lo = device_constant(self.aabb[0], coords.dtype, coords.device)
        hi = device_constant(self.aabb[1], coords.dtype, coords.device)
        mask = torch.all((coords >= lo) & (coords <= hi), dim=-1).float()
        contracted = (coords - lo) / (hi - lo) * 2.0 - 1.0
        return contracted, mask
