"""Per-image rays and labels for rendering and eval.

Counterpart of `PoseSet` in `tinynerf_tpu/data/pipeline.py` (host-side
numpy; the renderer moves each chunk to its device).  The training ray pool
comes with training (ROADMAP.md).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .formats import Intrinsics, NerfData


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
