"""Generated scenes for tests and chip runs, built in memory.

Counterpart of `tinynerf_tpu/utils/fixtures.py`: the three-lambertian-
spheres scene (ray-traced analytically, camera poses drawn from a seeded
numpy generator on a ring around the origin) returned as a `PoseSet`
directly, with no files, and `make_shell_occupancy`, the converged-like
occupancy state (a thin spherical shell) that the JAX package's bench
renders against.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.occupancy import OccupancyGrid, OccupancyState
from ..data.formats import Intrinsics, NerfData
from ..data.pipeline import PoseSet

CAMERA_ANGLE_X = 0.6911112070083618


def look_at_matrix(eye: np.ndarray) -> np.ndarray:
    """Camera-to-world with -z looking from `eye` at the origin, z-up world."""
    eye = np.asarray(eye, dtype=np.float64)
    forward = eye / np.linalg.norm(eye)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(up, forward)
    right /= np.linalg.norm(right)
    true_up = np.cross(forward, right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, true_up, forward, eye
    return m


# three lambertian spheres (center, radius, base rgb) inside the [-1.5,1.5]^3 box
_SPHERES = (
    (np.array([0.0, 0.0, 0.0]), 0.55, np.array([0.85, 0.25, 0.2])),
    (np.array([0.7, 0.5, 0.3]), 0.3, np.array([0.2, 0.6, 0.85])),
    (np.array([-0.6, 0.4, -0.4]), 0.35, np.array([0.95, 0.8, 0.25])),
)
_LIGHT = np.array([0.5, -0.3, 0.8]) / np.linalg.norm([0.5, -0.3, 0.8])


def render_spheres(cam: np.ndarray, res: int) -> np.ndarray:
    """Analytic ray-traced [res, res, 4] uint8 RGBA image of the spheres."""
    focal = res / (2.0 * np.tan(0.5 * CAMERA_ANGLE_X))
    xs = (np.arange(res) - res / 2.0 + 0.5) / focal
    ys = -(np.arange(res) - res / 2.0 + 0.5) / focal
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    d = np.stack([gx, gy, -np.ones_like(gx)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d @ cam[:3, :3].T
    o = cam[:3, 3]

    best_t = np.full(d.shape[:2], np.inf)
    rgb = np.zeros((*d.shape[:2], 3))
    for center, radius, color in _SPHERES:
        oc = o - center
        b = np.sum(d * oc, -1)
        c = float(oc @ oc) - radius * radius
        disc = b * b - c
        hit = disc > 0
        t = -b - np.sqrt(np.where(hit, disc, 0.0))
        hit &= (t > 0) & (t < best_t)
        p = o + d * t[..., None]
        n = (p - center) / radius
        shade = 0.35 + 0.65 * np.clip(n @ _LIGHT, 0.0, 1.0)
        rgb = np.where(hit[..., None], color * shade[..., None], rgb)
        best_t = np.where(hit, t, best_t)

    alpha = np.isfinite(best_t).astype(np.float64)
    img = np.concatenate([rgb, alpha[..., None]], -1)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def make_spheres_pose_set(n_views: int = 2, res: int = 800, seed: int = 0) -> PoseSet:
    """`n_views` labeled res x res views of the spheres scene, composited
    over a white background, as the Blender-synthetic loader composites."""
    rng = np.random.default_rng(seed)
    bg = np.ones(3, np.float32)
    cameras, imgs = [], []
    for _ in range(n_views):
        theta = rng.uniform(0, 2 * np.pi)
        eye = 4.0 * np.array([np.cos(theta), np.sin(theta), 0.5 + 0.2 * rng.uniform()])
        cam = look_at_matrix(eye)
        rgba = render_spheres(cam, res).astype(np.float32) / np.float32(255.0)
        a = rgba[..., 3:]
        imgs.append(rgba[..., :3] * a + bg * (np.float32(1.0) - a))
        cameras.append(cam.astype(np.float32))
    focal = res / (2.0 * np.tan(0.5 * CAMERA_ANGLE_X))
    data = NerfData(
        cameras=np.stack(cameras),
        intrinsics=Intrinsics(focal, focal, res / 2.0, res / 2.0, res, res),
        imgs=imgs,
        bg_color=bg,
    )
    return PoseSet(data)


def shell_grid(res: int) -> np.ndarray:
    """[res]^3 float32 grid that is 1 on a thin spherical shell (radius 0.35
    in contracted units, half-width 0.04) and 0 elsewhere."""
    ax = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    rad = np.sqrt(gx**2 + gy**2 + gz**2)
    return (np.abs(rad - 0.35) < 0.04).astype(np.float32)


def make_shell_occupancy(occupancy: OccupancyGrid, device=None) -> OccupancyState:
    """Converged-like occupancy state: only a thin spherical shell stays
    occupied, what grids converge to on opaque objects."""
    shell = shell_grid(occupancy.size[0])
    return OccupancyState(
        grid=torch.from_numpy(shell).to(device),
        mean=torch.tensor(float(shell.mean()), dtype=torch.float32, device=device),
    )
