"""The AABB scene type: the generated three-spheres scene inside the
[-1.5, 1.5]^3 box, its training ray pool and served rays, the occupancy
states of the traffic, the reference's march through the box, and the
configuration's box as the program's TrainConfig takes it.

The scene and the pose rule follow `tinynerf_tpu_torch/utils/fixtures.py`
(`make_spheres_data`, `shell_grid`), rewritten in torch so that 100 views
of 800x800 rays are built on the card in a few large calls instead of being
ray-traced in numpy on the host.  Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from nerfbench import scene
from nerfbench.reference.nerf import hash_u01

# three lambertian spheres (center, radius, base rgb) inside the [-1.5, 1.5]^3 box
SPHERES = (
    ((0.0, 0.0, 0.0), 0.55, (0.85, 0.25, 0.2)),
    ((0.7, 0.5, 0.3), 0.3, (0.2, 0.6, 0.85)),
    ((-0.6, 0.4, -0.4), 0.35, (0.95, 0.8, 0.25)),
)
LIGHT = np.array([0.5, -0.3, 0.8]) / np.linalg.norm([0.5, -0.3, 0.8])
VIEWS_PER_CALL = 10  # views ray-traced together: ~640 MB of f32 temporaries


def train_keys(train: dict) -> dict:
    """The configuration's train keys as the program's TrainConfig takes
    them: the box as a pair of float tuples."""
    return dict(train, aabb=tuple(tuple(float(v) for v in corner) for corner in train["aabb"]))


def spheres_rgb(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Colors of rays [..., 3] through the spheres, lit from LIGHT, quantized
    to 8 bits as an image file holds them and composited over white."""
    best = torch.full(d.shape[:-1], math.inf, device=d.device)
    rgb = torch.zeros_like(d)
    light = torch.tensor(LIGHT, dtype=torch.float32, device=d.device)
    for center, radius, color in SPHERES:
        oc = o - torch.tensor(center, dtype=torch.float32, device=d.device)
        b = torch.sum(d * oc, dim=-1)
        c = torch.sum(oc * oc, dim=-1) - radius * radius
        disc = b * b - c
        hit = disc > 0
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        hit &= (t > 0) & (t < best)
        n = (o + d * t[..., None] - torch.tensor(center, device=d.device)) / radius
        shade = 0.35 + 0.65 * torch.clamp(n @ light, 0.0, 1.0)
        col = torch.tensor(color, dtype=torch.float32, device=d.device) * shade[..., None]
        rgb = torch.where(hit[..., None], col, rgb)
        best = torch.where(hit, t, best)
    hit_any = torch.isfinite(best)[..., None]
    rgb = torch.floor(torch.clamp(rgb, 0.0, 1.0) * 255.0) / 255.0
    return torch.where(hit_any, rgb, torch.ones_like(rgb))


def training_pool(seed: int, traffic: dict, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ray pool of the training views: origins, directions and colors,
    each [views * res^2, 3] f32 on `device`."""
    n, res = traffic["views"], traffic["res"]
    cams = torch.from_numpy(scene.ring_poses(seed, 0, n, traffic["ring_radius"])).to(device)
    o_all = torch.empty(n * res * res, 3, device=device)
    d_all = torch.empty_like(o_all)
    rgb_all = torch.empty_like(o_all)
    per = res * res
    for a in range(0, n, VIEWS_PER_CALL):
        b = min(n, a + VIEWS_PER_CALL)
        o, d = scene.pinhole_rays(cams[a:b], res, traffic["camera_angle_x"])
        o_all[a * per : b * per] = o.reshape(-1, 3)
        d_all[a * per : b * per] = d.reshape(-1, 3)
        rgb_all[a * per : b * per] = spheres_rgb(o, d).reshape(-1, 3)
    return o_all, d_all, rgb_all


def served_rays(traffic: dict, device) -> Tuple[np.ndarray, np.ndarray]:
    """Rays of the serving loop's views, the same at every run seed: the
    first `views` of `ring_poses` test poses drawn from the traffic's fixed
    `pose_seed`, (origins, directions) [views, res, res, 3] f32 on the
    host, where the program's serving entry reads them."""
    cams = scene.ring_poses(traffic["pose_seed"], 1, traffic["ring_poses"], traffic["ring_radius"])[: traffic["views"]]
    o, d = scene.pinhole_rays(torch.from_numpy(cams).to(device), traffic["res"], traffic["camera_angle_x"])
    return o.contiguous().cpu().numpy(), d.contiguous().cpu().numpy()


def occupancy_grid(kind: str, res: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grid [res]^3 f32, its mean) of the traffic's occupancy state: "all",
    every voxel occupied (a run's start), or "shell", a thin spherical shell
    (radius 0.35 in contracted units, half-width 0.04: what grids converge
    to on opaque objects)."""
    if kind == "all":
        grid = torch.ones(res, res, res, device=device)
    elif kind == "shell":
        ax = (torch.arange(res, dtype=torch.float64, device=device) + 0.5) / res * 2.0 - 1.0
        rad = torch.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2 + ax[None, None, :] ** 2)
        grid = (torch.abs(rad - 0.35) < 0.04).float()
    else:
        raise ValueError(f"unknown occupancy state {kind!r}")
    return grid, grid.mean()


# ------------------------------------------------------------------ march


def step_size(aabb, n_samples: int) -> float:
    lo, hi = np.array(aabb[0], np.float32), np.array(aabb[1], np.float32)
    return float(np.linalg.norm(hi - lo) / n_samples)


def march(rays_o: torch.Tensor, rays_d: torch.Tensor, train: dict, grid: torch.Tensor, grid_mean: torch.Tensor,
          jitter_seed: Optional[torch.Tensor] = None):
    """The AABB march: entry by the slab test (clamped to [near, 1e5] and
    nudged 1e-4 steps in), n_samples uniform steps of |diagonal| / n, each
    moved by u * step with the jitter hash; positions contracted to
    [-1, 1]^3 and kept where inside the box and at an occupied voxel
    (nearest, against min(mean, threshold)).  -> (x [R, S, 3], step, keep
    [R, S] bool)."""
    aabb, n = train["aabb"], train["n_samples"]
    step = step_size(aabb, n)
    box = torch.tensor(aabb, dtype=torch.float32, device=rays_o.device)
    d_safe = torch.where(rays_d == 0.0, rays_d + 1e-9, rays_d)
    planes = (box[:, None, :] - rays_o[None]) / d_safe[None]
    t_min = torch.clamp(torch.amax(torch.amin(planes, dim=0), dim=-1), train["near"], 1e5)
    t_min = t_min + np.float32(1e-4 * step).item()
    t = t_min[:, None] + (torch.arange(n, dtype=torch.float32, device=rays_o.device) * np.float32(step).item())[None]
    if jitter_seed is not None:
        u = hash_u01(jitter_seed, torch.arange(t.shape[0], device=t.device)[:, None],
                     torch.arange(n, device=t.device)[None, :])
        t = t + u * torch.full_like(t, np.float32(step).item())
    pos = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    inside = torch.all((pos >= box[0]) & (pos <= box[1]), dim=-1)
    x = (pos - box[0]) / (box[1] - box[0]) * 2.0 - 1.0
    r0, r1, r2 = grid.shape
    thr = torch.clamp(grid_mean, max=train["occupancy_threshold"])
    idx = [torch.clamp(torch.round((x[..., a] + 1.0) * 0.5 * (r - 1)), 0, r - 1).long()
           for a, r in enumerate((r0, r1, r2))]
    occupied = grid.reshape(-1)[(idx[0] * r1 + idx[1]) * r2 + idx[2]] > thr
    return x, np.float32(step).item(), inside & occupied
