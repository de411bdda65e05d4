"""Canonical data structs and pinhole ray generation (host side, numpy).

Counterpart of `tinynerf_tpu/data/formats.py`, the same numpy code: the JAX
package's data modules cannot be imported here (its `data` package imports
jax at import time).  `Intrinsics`, `NerfData` (cameras + intrinsics +
optional images + bg color), pinhole rays in the OpenGL/Blender convention
(-z forward, y up) and `scene_scale` (max unbiased variance of the camera
positions) must match it bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np


@dataclass
class Intrinsics:
    fx: float
    fy: float
    cx: float
    cy: float
    w: int
    h: int


@dataclass
class NerfData:
    """Images + poses in a common struct.

    Labeled data (``imgs`` not None) carries ground-truth colors; unlabeled
    data is poses only (novel-view synthesis).  Intrinsics may be shared
    (single `Intrinsics`) or per-image (list).
    """

    cameras: np.ndarray  # [n_images, 4, 4] float32 camera-to-world matrices
    intrinsics: Union[Intrinsics, List[Intrinsics]]
    imgs: Optional[List[np.ndarray]] = None  # [n_images] of [h, w, 3] float32 in [0,1]
    bg_color: Optional[np.ndarray] = None  # [3] float32 in [0,1]

    @property
    def n_img(self) -> int:
        return len(self.cameras)

    def img_intrinsics(self, idx: int) -> Intrinsics:
        if isinstance(self.intrinsics, Intrinsics):
            return self.intrinsics
        return self.intrinsics[idx]

    def generate_rays(self) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Per-image pinhole rays.

        Returns (rays_o, rays_d): two lists of [h, w, 3] float32 arrays.
        Convention: pixel grid offset by +0.5 to pixel centers, x right,
        y down in image space mapped through (fx, -fy), camera looks down -z
        (OpenGL/Blender); directions are rotated to world and L2-normalized;
        origins are the camera translation broadcast per pixel.
        """
        rays_o, rays_d = [], []
        for i in range(self.n_img):
            K = self.img_intrinsics(i)
            o, d = pinhole_rays(self.cameras[i], K)
            rays_o.append(o)
            rays_d.append(d)
        return rays_o, rays_d

    def scene_scale(self) -> float:
        """Max per-axis (unbiased) variance of camera positions."""
        pos = self.cameras[:, :3, 3].astype(np.float64)
        if len(pos) < 2:
            return 1.0
        return float(np.max(np.var(pos.astype(np.float32), axis=0, ddof=1)))


def pinhole_rays(camera: np.ndarray, K: Intrinsics) -> Tuple[np.ndarray, np.ndarray]:
    """Rays for one camera-to-world matrix `camera` [4,4] and intrinsics `K`.

    Pure float32 throughout, matching the reference pipeline's numerics.
    """
    xs = np.arange(K.w, dtype=np.float32)
    ys = np.arange(K.h, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")  # each [h, w]
    grid = np.stack([gx, gy], axis=-1)  # [h, w, 2]
    center = np.array([K.cx, K.cy], dtype=np.float32)
    focal = np.array([K.fx, -K.fy], dtype=np.float32)
    grid = (grid - center + np.float32(0.5)) / focal
    # pad with -1 for the z coordinate: camera looks down -z
    grid = np.concatenate(
        [grid, np.full((*grid.shape[:-1], 1), -1.0, dtype=np.float32)], axis=-1
    )  # [h, w, 3]

    R = camera[:3, :3].astype(np.float32)
    t = camera[:3, 3].astype(np.float32)
    d = grid @ R.T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True).astype(np.float32)
    o = np.broadcast_to(t, d.shape).copy()
    return o.astype(np.float32), d.astype(np.float32)
