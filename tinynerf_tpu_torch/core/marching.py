"""Ray marchers: per-ray sample distances t and step sizes delta.

Counterpart of `tinynerf_tpu/core/marching.py`, both [n_rays, n_samples]:

  * `RayMarcherUnbounded`: the disparity spacing f(x) = 2x (x < 0.5) or
    1 / (2 - 2x) over x_k = k * step_x, scaled by the scene scale and
    shifted by `near`.  The grid does not depend on the ray, so it is
    computed once on the host in numpy f32, as the JAX file does, and
    broadcast; the unbounded skip march evaluates the same f32 expression
    per sample and must match it bit for bit.
  * `RayMarcherAABB`: a slab test gives the entry distance t_min (clamped
    to [near, far] and nudged 1e-4 steps inside the box), then n_samples
    uniform steps of ||aabb diagonal|| / n_samples.  Samples past the box
    are culled downstream by the contraction mask.

The disparity grid and the box reach a device once (`grid_on`, through
`utils/device.py` `device_constant`), not at every call.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..utils.device import device_constant


@dataclass(frozen=True)
class RayMarcherUnbounded:
    n_samples: int = 200
    near: float = 0.0
    far: float = 1e5
    uniform_range: float = 1.0

    @property
    def step_size(self) -> float:
        """Representative step (the occupancy update's)."""
        return self.uniform_range / self.n_samples

    @property
    def step_x(self) -> float:
        """Spacing of the disparity parameter x (x_k = k * step_x)."""
        return (1.0 - 1.0 / (self.n_samples + 2)) / self.n_samples

    def _grid(self) -> Tuple[np.ndarray, np.ndarray]:
        """(t [n_samples], deltas [n_samples]) in f32, from k * step_x (not
        linspace): the skip march's closed form gives the same bits."""
        x = np.arange(self.n_samples + 1, dtype=np.float32) * np.float32(self.step_x)
        f = np.where(x < 0.5, 2.0 * x, 1.0 / (2.0 - 2.0 * x)).astype(np.float32)
        t = f * np.float32(self.uniform_range) + np.float32(self.near)
        return t[:-1], t[1:] - t[:-1]

    def grid_on(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """`_grid()` on `device`, made there once (f32 values, exact
        through Python floats)."""
        t, deltas = (device_constant(tuple(a.tolist()), torch.float32, device) for a in self._grid())
        return t, deltas

    def __call__(self, rays_o: torch.Tensor, rays_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        t, deltas = self.grid_on(rays_o.device)
        shape = (rays_o.shape[0], self.n_samples)
        return t.expand(shape), deltas.expand(shape)


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
        box = device_constant(self.aabb, rays_o.dtype, rays_o.device)  # [2, 3]
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
