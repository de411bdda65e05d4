"""Training rays and per-image rays for rendering and eval.

Counterpart of `tinynerf_tpu/data/pipeline.py`.  `RayPool` holds every
training ray (origin, direction, color) flattened and resident on the
training device, so a step's batch is one device-side gather
(`sample_ray_batch`, uniform with replacement, from an explicit
`torch.Generator`: jax.random and torch cannot draw the same indices, so
parity tests pass their batches in).  `PoseSet` keeps per-image rays on the
host (numpy); the renderer moves each chunk to its device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .formats import Intrinsics, NerfData


class RayPool:
    """All training rays of `data`, flattened, as float32 tensors on `device`."""

    def __init__(self, data: NerfData, device=None):
        if data.imgs is None:
            raise ValueError("a ray pool requires ground-truth images")
        rays_o, rays_d = data.generate_rays()
        flat = lambda arrs: torch.from_numpy(
            np.concatenate([np.asarray(a, np.float32).reshape(-1, 3) for a in arrs])).to(device)
        self.rays_o = flat(rays_o)
        self.rays_d = flat(rays_d)
        self.rgbs = flat(data.imgs)
        self.scene_scale = data.scene_scale()
        self.bg_color = data.bg_color
        self.n_rays = self.rays_o.shape[0]

    def arrays(self):
        return self.rays_o, self.rays_d, self.rgbs


def sample_ray_batch(generator: Optional[torch.Generator], pool_o, pool_d, pool_rgb, n: int):
    """Uniform-with-replacement batch of `n` rays, gathered on the pool's
    device (`generator` must live on that device)."""
    idx = torch.randint(0, pool_o.shape[0], (n,), generator=generator, device=pool_o.device)
    return pool_o[idx], pool_d[idx], pool_rgb[idx]


class PoseSet:
    def __init__(self, data: NerfData):
        self.rays_o, self.rays_d = data.generate_rays()  # lists of [h, w, 3]
        self.rgbs: Optional[List[np.ndarray]] = data.imgs
        self.scene_scale = data.scene_scale()
        self.bg_color = data.bg_color
        self._data = data

    def __len__(self) -> int:
        return len(self.rays_o)

    def img_intrinsics(self, idx: int) -> Intrinsics:
        return self._data.img_intrinsics(idx)

    def __getitem__(self, idx: int) -> dict:
        item = {"rays_o": self.rays_o[idx], "rays_d": self.rays_d[idx]}
        if self.rgbs is not None:
            item["rgbs"] = self.rgbs[idx]
        return item
