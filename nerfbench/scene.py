"""The benchmark's inputs, made from the seed on the device: camera poses on
a ring, pinhole rays, the three-spheres scene's colors, the occupancy
states and the seeded parameters.

The scene and the pose rule follow `tinynerf_tpu_torch/utils/fixtures.py`
(`make_spheres_data`, `shell_grid`), rewritten in torch so that 100 views
of 800x800 rays are built on the card in a few large calls instead of being
ray-traced in numpy on the host.  Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

# three lambertian spheres (center, radius, base rgb) inside the [-1.5, 1.5]^3 box
SPHERES = (
    ((0.0, 0.0, 0.0), 0.55, (0.85, 0.25, 0.2)),
    ((0.7, 0.5, 0.3), 0.3, (0.2, 0.6, 0.85)),
    ((-0.6, 0.4, -0.4), 0.35, (0.95, 0.8, 0.25)),
)
LIGHT = np.array([0.5, -0.3, 0.8]) / np.linalg.norm([0.5, -0.3, 0.8])
VIEWS_PER_CALL = 10  # views ray-traced together: ~640 MB of f32 temporaries


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for stream `stream` of run seed `seed` (any whole
    number, negative or past 64 bits included)."""
    return ((seed % (1 << 62)) * 1_000_003 + stream * 7_919) % (1 << 63)


def look_at(eye: np.ndarray) -> np.ndarray:
    """Camera-to-world with -z looking from `eye` at the origin, z-up world."""
    forward = eye / np.linalg.norm(eye)
    right = np.cross(np.array([0.0, 0.0, 1.0]), forward)
    right /= np.linalg.norm(right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, np.cross(forward, right), forward, eye
    return m


def ring_poses(seed: int, stream: int, n: int, radius: float) -> np.ndarray:
    """`n` camera-to-world matrices [n, 4, 4] f32 on the ring rule of
    `make_spheres_data`: an angle and a height drawn per view."""
    rng = np.random.default_rng(stream_seed(seed, stream))
    cams = []
    for _ in range(n):
        theta = rng.uniform(0, 2 * np.pi)
        eye = radius * np.array([np.cos(theta), np.sin(theta), 0.5 + 0.2 * rng.uniform()])
        cams.append(look_at(eye))
    return np.stack(cams).astype(np.float32)


def pinhole_rays(cams: torch.Tensor, res: int, camera_angle_x: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays of cams [n, 4, 4] at res x res: (origins, unit directions), each
    [n, res, res, 3] f32, pixel centers, -z forward and y up (the Blender
    convention of `data/formats.py`)."""
    dev = cams.device
    focal = res / (2.0 * math.tan(0.5 * camera_angle_x))
    pix = (torch.arange(res, dtype=torch.float32, device=dev) - res / 2.0 + 0.5)
    gx = (pix / focal)[None, :].expand(res, res)
    gy = (-pix / focal)[:, None].expand(res, res)
    grid = torch.stack([gx, gy, -torch.ones_like(gx)], dim=-1)  # [res, res, 3]
    d = torch.einsum("hwk,nck->nhwc", grid, cams[:, :3, :3])
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    o = cams[:, None, None, :3, 3].expand_as(d)
    return o, d


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
    cams = torch.from_numpy(ring_poses(seed, 0, n, traffic["ring_radius"])).to(device)
    o_all = torch.empty(n * res * res, 3, device=device)
    d_all = torch.empty_like(o_all)
    rgb_all = torch.empty_like(o_all)
    per = res * res
    for a in range(0, n, VIEWS_PER_CALL):
        b = min(n, a + VIEWS_PER_CALL)
        o, d = pinhole_rays(cams[a:b], res, traffic["camera_angle_x"])
        o_all[a * per : b * per] = o.reshape(-1, 3)
        d_all[a * per : b * per] = d.reshape(-1, 3)
        rgb_all[a * per : b * per] = spheres_rgb(o, d).reshape(-1, 3)
    return o_all, d_all, rgb_all


def test_views(seed: int, traffic: dict, device) -> Tuple[np.ndarray, np.ndarray]:
    """Rays of the serving loop's views: the first `views` of `ring_poses`
    test poses, (origins, directions) [views, res, res, 3] f32 on the host,
    where the program's serving entry reads them."""
    cams = ring_poses(seed, 1, traffic["ring_poses"], traffic["ring_radius"])[: traffic["views"]]
    o, d = pinhole_rays(torch.from_numpy(cams).to(device), traffic["res"], traffic["camera_angle_x"])
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


def param_shapes(config: dict) -> Dict[str, tuple]:
    """Every parameter of the configuration by the program's module names,
    in draw order, from the configuration's widths alone."""
    shapes: Dict[str, tuple] = {}
    field = config["field"]

    def mlp(prefix, dims):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            shapes[f"{prefix}.w.{i}"] = (a, b)
        for i, b in enumerate(dims[1:]):
            shapes[f"{prefix}.b.{i}"] = (b,)

    if field["kind"] == "kplanes":
        for s, r in enumerate(field["resolutions"]):
            for p in range(len(field["pairs"])):
                shapes[f"field.planes.{s}.{p}"] = (r, r, field["features"])
    elif field["kind"] == "cobafa":
        for i, (r, c) in enumerate(zip(field["basis_res"], field["channels"])):
            shapes[f"field.basis.{i}"] = (r, r, r, c)
        r = field["coef_res"]
        shapes["field.coef"] = (r, r, r, len(field["basis_res"]))
        mlp("field.mlp", field["mlp"])
    else:
        raise ValueError(f"unknown field {field['kind']!r}")
    mlp("sigma_decoder.mlp", config["sigma_decoder"])
    mlp("rgb_decoder.mlp", config["rgb_decoder"]["dims"])
    return shapes


def _init_rule(config: dict, name: str) -> dict:
    for prefix, rule in config["init"].items():
        if name == prefix or name.startswith(prefix + "."):
            return rule
    raise ValueError(f"no init rule for parameter {name}")


def make_params(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The parameters of the configuration, made on `device` from the seed
    in one draw: each leaf uniform on its rule's range ("uniform": [lo, hi];
    "linear": "torch" is U(+-1/sqrt(fan_in)) for weights and biases, "he" is
    U(+-sqrt(6/fan_in)) weights and zero biases)."""
    shapes = param_shapes(config)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 2))
    u = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        rule = _init_rule(config, name)
        if "uniform" in rule:
            lo, hi = rule["uniform"]
        else:
            prefix, kind, idx = name.rsplit(".", 2)
            fan_in = shapes[f"{prefix}.w.{idx}"][0]
            if rule["linear"] == "he":
                lo, hi = (0.0, 0.0) if kind == "b" else (-math.sqrt(6.0 / fan_in), math.sqrt(6.0 / fan_in))
            else:
                lo, hi = -1.0 / math.sqrt(fan_in), 1.0 / math.sqrt(fan_in)
        out[name] = (lo + (hi - lo) * u[at : at + n]).reshape(shape)
        at += n
    return out
