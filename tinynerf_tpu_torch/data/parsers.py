"""Blender-synthetic dataset parser.

Counterpart of `parse_nerf_synthetic` in `tinynerf_tpu/data/parsers.py`:
`transforms_{split}.json`, focal from `camera_angle_x`, RGBA composited
over a bg color, [0, 1] float32 images.  PNGs are decoded by the port's
native loader (`tinynerf_tpu_torch.native`, ctypes and libpng); Pillow is
imported only for its fallback, so a machine without Pillow reads scenes
whenever the native loader builds.  The nerfstudio parser comes later
(ROADMAP.md).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Tuple

import numpy as np

from .. import native
from .formats import Intrinsics, NerfData


def _load_image_rgb(path: Path, bg_color: Tuple[int, int, int]) -> np.ndarray:
    """Pillow fallback: RGBA composited over `bg_color` -> [h, w, 3] in [0, 1]."""
    from PIL import Image

    with Image.open(path) as img:
        if img.mode == "RGBA":
            bg = Image.new("RGBA", img.size, bg_color)
            img = Image.alpha_composite(bg, img).convert("RGB")
        elif img.mode != "RGB":
            img = img.convert("RGB")
        arr = np.asarray(img, dtype=np.float32) / np.float32(255.0)
    return arr


def parse_nerf_synthetic(
    scene_path: Path,
    split: str = "train",
    bg_color: Tuple[int, int, int] = (255, 255, 255),
) -> NerfData:
    scene_path = Path(scene_path)
    bg = np.array(bg_color, dtype=np.float32) / np.float32(255.0)
    with open(scene_path / f"transforms_{split}.json") as f_in:
        meta = json.load(f_in)
    paths = [
        (scene_path / frame["file_path"]).with_suffix(".png") for frame in meta["frames"]
    ]
    cameras = [np.array(frame["transform_matrix"], dtype=np.float32) for frame in meta["frames"]]

    batch = native.load_images(paths, tuple(float(c) for c in bg))
    if batch is not None:
        imgs: List[np.ndarray] = list(batch)
    else:
        imgs = [_load_image_rgb(p, bg_color) for p in paths]
    if not imgs:
        raise ValueError(f"empty dataset split {split!r} in {scene_path}")
    h, w = imgs[0].shape[:2]
    focal = w / (2.0 * np.tan(0.5 * float(meta["camera_angle_x"])))
    return NerfData(
        cameras=np.stack(cameras).astype(np.float32),
        intrinsics=Intrinsics(focal, focal, w / 2.0, h / 2.0, w, h),
        imgs=imgs,
        bg_color=bg,
    )
