"""The benchmark's inputs that every scene and field share, made from the
seed: run-seed streams, camera poses on a ring (the pose rule of
`tinynerf_tpu_torch/utils/fixtures.py` `make_spheres_data`), pinhole rays
and the seeded parameters, drawn on the device in one call.  The scene
itself is the configuration's scene file (`scenes/`), the field's
parameters its field file (`fields/`).  Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from .reference.nerf import field_of, mlp_shapes


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


def param_shapes(config: dict) -> Dict[str, tuple]:
    """Every parameter of the configuration by the program's module names,
    in draw order, from the configuration's widths alone: the field's (its
    field file's), then the two decoders'."""
    shapes = dict(field_of(config).param_shapes(config))
    shapes.update(mlp_shapes("sigma_decoder.mlp", config["sigma_decoder"]))
    shapes.update(mlp_shapes("rgb_decoder.mlp", config["rgb_decoder"]["dims"]))
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
