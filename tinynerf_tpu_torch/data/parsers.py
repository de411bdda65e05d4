"""Dataset parsers: Blender-synthetic and nerfstudio.

Counterpart of `tinynerf_tpu/data/parsers.py`:

  * `parse_nerf_synthetic`: `transforms_{split}.json`, focal from
    `camera_angle_x`;
  * `parse_nerfstudio`: one `transforms.json` (`ns-process-data` output)
    with global and/or per-frame pinhole intrinsics, frames sorted by
    `file_path`, the `{split}_filenames` lists when present, otherwise
    every 8th frame held out for val and test.  Distortion coefficients are
    ignored, as in the JAX parser.

Both give RGBA composited over a bg color, [0, 1] float32 images.  PNGs are
decoded by the port's native loader (`tinynerf_tpu_torch.native`, ctypes
and libpng), one call per image size; Pillow is imported only for other
formats and for its fallback, so a machine without Pillow reads PNG scenes
whenever the native loader builds, and raises, naming the file, on any
other.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import native
from .formats import Intrinsics, NerfData


def _load_image_rgb(path: Path, bg_color: Tuple[int, int, int]) -> np.ndarray:
    """Pillow fallback: RGBA composited over `bg_color` -> [h, w, 3] in [0, 1]."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"cannot decode {path}: the native loader reads only PNGs it can open, "
                           "and Pillow is not installed") from e

    with Image.open(path) as img:
        if img.mode == "RGBA":
            bg = Image.new("RGBA", img.size, bg_color)
            img = Image.alpha_composite(bg, img).convert("RGB")
        elif img.mode != "RGB":
            img = img.convert("RGB")
        arr = np.asarray(img, dtype=np.float32) / np.float32(255.0)
    return arr


def _load_images(paths: Sequence[Path], bg_color: Tuple[int, int, int]) -> List[np.ndarray]:
    """Decode `paths` in order: PNGs with the native loader, one call per
    image size; anything else, or every file if the loader is unavailable,
    with Pillow."""
    bg = tuple(float(c) for c in np.array(bg_color, dtype=np.float32) / np.float32(255.0))
    imgs: List[Optional[np.ndarray]] = [None] * len(paths)
    by_size: Dict[Tuple[int, int], List[int]] = {}
    for i, p in enumerate(paths):
        size = native.png_size(p)
        if size is not None:
            by_size.setdefault(size, []).append(i)
    for idx in by_size.values():
        batch = native.load_images([paths[i] for i in idx], bg)
        if batch is not None:
            for i, img in zip(idx, batch):
                imgs[i] = img
    return [img if img is not None else _load_image_rgb(p, bg_color) for img, p in zip(imgs, paths)]


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

    imgs = _load_images(paths, bg_color)
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


def parse_nerfstudio(
    scene_path: Path,
    split: str = "train",
    bg_color: Tuple[int, int, int] = (255, 255, 255),
) -> NerfData:
    """nerfstudio's `transforms.json`: per-frame `file_path` and
    `transform_matrix` (camera-to-world, OpenGL convention), intrinsics
    (fl_x, fl_y, cx, cy, w, h) per frame or global.  Per-frame intrinsics
    collapse to one `Intrinsics` when all frames agree."""
    scene_path = Path(scene_path)
    bg = np.array(bg_color, dtype=np.float32) / np.float32(255.0)
    with open(scene_path / "transforms.json") as f_in:
        meta = json.load(f_in)
    frames = sorted(meta["frames"], key=lambda fr: fr["file_path"])
    names = meta.get(f"{split}_filenames")
    if names:
        names = set(names)
        frames = [fr for fr in frames if fr["file_path"] in names]
    elif split == "train":
        frames = [fr for i, fr in enumerate(frames) if i % 8 != 0]
    else:  # val and test share the holdout: frames 0, 8, 16, ...
        frames = [fr for i, fr in enumerate(frames) if i % 8 == 0]
    if not frames:
        raise ValueError(f"no frames for split {split!r} in {scene_path}")

    def frame_intrinsics(frame: dict) -> Intrinsics:
        def get(key, default=None):
            return frame.get(key, meta.get(key, default))

        w, h = int(get("w")), int(get("h"))
        fl_x = float(get("fl_x"))
        return Intrinsics(fl_x, float(get("fl_y", fl_x)), float(get("cx", w / 2.0)),
                          float(get("cy", h / 2.0)), w, h)

    intrinsics: Union[Intrinsics, List[Intrinsics]] = [frame_intrinsics(fr) for fr in frames]
    if all(k == intrinsics[0] for k in intrinsics):
        intrinsics = intrinsics[0]
    return NerfData(
        cameras=np.stack([np.array(fr["transform_matrix"], dtype=np.float32) for fr in frames]),
        intrinsics=intrinsics,
        imgs=_load_images([scene_path / fr["file_path"] for fr in frames], bg_color),
        bg_color=bg,
    )
