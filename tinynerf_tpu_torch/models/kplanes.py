"""K-Planes feature field (arXiv 2301.10241), forward.

Counterpart of `KPlanesFeatureField` in `tinynerf_tpu/models/kplanes.py`
with its default lookup (fused, per-scale forward): n_scales x 3
axis-aligned planes (xy, xz, yz), feature-last `[r, r, F]`, init U(0, 1);
per scale the feature is the PRODUCT of the three bilinear lookups, in
projection order.  Tables are rounded to `gather_dtype` before the f32
lerp (`ops/interp.py`).  The TV/L1 regularizers, their row-partitioned
partials and the explicit decoders come with training (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.interp import _quad_lookup_fwd_value

# coordinate pairs used per plane, in order: (x,y), (x,z), (y,z)
DIMENSION_PAIRS: Tuple[Tuple[int, int], ...] = ((0, 1), (0, 2), (1, 2))

# the JAX field's default gather_dtype: tables round to bf16 before the lerp
GATHER_DTYPE = torch.bfloat16


class KPlanesFeatureField(nn.Module):
    def __init__(
        self,
        feature_dim_per_plane: int = 32,
        resolutions: Tuple[int, ...] = (129, 257, 513),
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.feature_dim_per_plane = feature_dim_per_plane
        self.resolutions = tuple(resolutions)
        # planes[s][p]: scale s, projection p (DIMENSION_PAIRS order)
        self.planes = nn.ModuleList()
        for res in self.resolutions:
            scale = nn.ParameterList()
            for _ in DIMENSION_PAIRS:
                t = torch.empty(res, res, feature_dim_per_plane)
                t.uniform_(0.0, 1.0, generator=generator)
                scale.append(nn.Parameter(t.to(device)))
            self.planes.append(scale)

    @property
    def feature_dim(self) -> int:
        return self.feature_dim_per_plane * len(self.resolutions)

    def apply_pieces(self, x: torch.Tensor, compute_dtype=torch.float32) -> tuple:
        """x: [..., 3] in [-1, 1] -> per-scale features ([..., F] x n_scales),
        not concatenated: the decoders' split first layers take them as is."""
        features = []
        for scale_planes in self.planes:
            acc = None
            for (i, j), plane in zip(DIMENSION_PAIRS, scale_planes):
                v = _quad_lookup_fwd_value(plane, x[..., [i, j]], GATHER_DTYPE)
                acc = v if acc is None else acc * v
            features.append(acc.to(compute_dtype))
        return tuple(features)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        """x: [..., 3] -> [..., feature_dim] (the concatenated form)."""
        return torch.cat(self.apply_pieces(x, compute_dtype), dim=-1)
