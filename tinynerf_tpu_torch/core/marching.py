"""AABB ray marcher: per-ray sample distances t and step sizes delta.

Counterpart of `RayMarcherAABB` in `tinynerf_tpu/core/marching.py`: a slab
test gives the entry distance t_min (clamped to [near, far] and nudged
1e-4 steps inside the box), then n_samples uniform steps of
||aabb diagonal|| / n_samples.  Samples past the box are culled downstream
by the contraction mask.  The unbounded marcher comes later (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class RayMarcherAABB:
    aabb: Tuple[Tuple[float, float, float], Tuple[float, float, float]]
    n_samples: int = 200
    near: float = 0.0
    far: float = 1e5

    @property
    def step_size(self) -> float:
        lo = np.array(self.aabb[0], dtype=np.float32)
        hi = np.array(self.aabb[1], dtype=np.float32)
        return float(np.linalg.norm(hi - lo) / self.n_samples)

    def entry_exit(self, rays_o: torch.Tensor, rays_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Slab-test (t_min clamped to [near, far] and nudged, t_exit)."""
        eps = 1e-9
        box = torch.tensor(self.aabb, dtype=rays_o.dtype, device=rays_o.device)  # [2, 3]
        d_safe = torch.where(rays_d == 0.0, rays_d + eps, rays_d)
        t_planes = (box[:, None, :] - rays_o[None]) / d_safe[None]  # [2, R, 3]
        t_min = torch.amax(torch.amin(t_planes, dim=0), dim=-1)  # [R]
        t_exit = torch.amin(torch.amax(t_planes, dim=0), dim=-1)  # [R]
        t_min = torch.clamp(t_min, self.near, self.far)
        # nudge the first sample strictly inside the box: at t_min exactly the
        # position sits ON the box surface, where the in-box test resolves
        # differently under 1-ulp differences between implementations
        t_min = t_min + np.float32(1e-4 * self.step_size).item()
        return t_min, t_exit

    def __call__(self, rays_o: torch.Tensor, rays_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        t_min, _ = self.entry_exit(rays_o, rays_d)
        step = np.float32(self.step_size).item()
        steps = torch.arange(self.n_samples, dtype=rays_o.dtype, device=rays_o.device) * step
        t_values = t_min[:, None] + steps[None, :]
        step_sizes = torch.full_like(t_values, step)
        return t_values, step_sizes
