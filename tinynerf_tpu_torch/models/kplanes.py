"""K-Planes feature field (arXiv 2301.10241).

Counterpart of `KPlanesFeatureField` in `tinynerf_tpu/models/kplanes.py`
with its default lookup (fused, per-scale forward): n_scales x 3
axis-aligned planes (xy, xz, yz), feature-last `[r, r, F]`, init U(0, 1);
per scale the feature is the PRODUCT of the three bilinear lookups, in
projection order.  Each lookup builds its plane's cell-packed quad table
in `gather_dtype` (`ops/octbuild.py:build_quad`, a CUDA kernel on the card:
nine builds per field call) and gathers one 4F row per sample, lerped in
f32.  All lookups run under one autograd Function
(`ops/interp.py:multiscale_lookup_multiproj`), whose backward takes every
table gradient on the finest grid through the sorted-window pipeline (on a
CUDA device) or a scatter (on the CPU).  The TV and L1 regularizers are
here; their row-partitioned partials (sharded training) and the explicit
decoders are not ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.interp import multiscale_lookup_multiproj

# coordinate pairs used per plane, in order: (x,y), (x,z), (y,z)
DIMENSION_PAIRS: Tuple[Tuple[int, int], ...] = ((0, 1), (0, 2), (1, 2))

# the JAX field's default gather_dtype: tables round to bf16 before the lerp
GATHER_DTYPE = torch.bfloat16


class KPlanesFeatureField(nn.Module):
    # optimizer groups (train/loop.py `_decay_mask`): the planes are tables
    table_keys = frozenset({"planes"})
    mlp_keys = frozenset()

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
        n_scales = len(self.resolutions)
        per_proj = multiscale_lookup_multiproj(
            [[self.planes[s][p] for s in range(n_scales)] for p in range(len(DIMENSION_PAIRS))],
            [x[..., [i, j]] for (i, j) in DIMENSION_PAIRS],
            GATHER_DTYPE,
        )
        features = []
        for s in range(n_scales):
            acc = None
            for pieces in per_proj:
                acc = pieces[s] if acc is None else acc * pieces[s]
            features.append(acc.to(compute_dtype))
        return tuple(features)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        """x: [..., 3] -> [..., feature_dim] (the concatenated form)."""
        return torch.cat(self.apply_pieces(x, compute_dtype), dim=-1)

    def _planes(self):
        return (plane for scale_planes in self.planes for plane in scale_planes)

    def loss_tv(self) -> torch.Tensor:
        """Total-variation penalty averaged over all planes: the mean squared
        difference of neighbours along each plane axis (on the [r, r*F]
        view, as the JAX package computes it)."""
        total, count = 0.0, 0
        for plane in self._planes():
            r0, r1, f = plane.shape
            v = plane.reshape(r0, r1 * f)
            tv0 = torch.mean((v[1:, :] - v[:-1, :]) ** 2)
            tv1 = torch.mean((v[:, f:] - v[:, :-f]) ** 2)
            total = total + tv0 + tv1
            count += 1
        return total / count

    def loss_l1(self) -> torch.Tensor:
        """Mean |plane| averaged over all planes."""
        total, count = 0.0, 0
        for plane in self._planes():
            total = total + torch.mean(torch.abs(plane))
            count += 1
        return total / count
