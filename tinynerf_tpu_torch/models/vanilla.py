"""The sigma and color decoders every field shares.

Counterpart of `OpacityDecoder` and `ColorDecoder` in
`tinynerf_tpu/models/vanilla.py` (forward).  The vanilla feature field
itself is not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.trunc_exp import truncated_exp
from .encodings import posenc_dim, positional_encoding
from .mlp import MLP, mlp_apply_split, mlp_apply_split_per_ray


def _pieces(features) -> tuple:
    return tuple(features) if isinstance(features, (tuple, list)) else (features,)


class OpacityDecoder(nn.Module):
    """features -> sigma = truncated_exp(MLP(features) - 1) >= 0."""

    def __init__(
        self, feature_dim: int, hidden_features: int = 64, fwd_clamp: bool = True,
        generator: Optional[torch.Generator] = None, device=None,
    ):
        super().__init__()
        self.feature_dim = feature_dim
        self.fwd_clamp = fwd_clamp
        self.mlp = MLP(feature_dim, hidden_features, 0, 1, generator, device)

    def forward(self, features, compute_dtype=torch.float32) -> torch.Tensor:
        """features: [..., F] or a tuple of pieces summing to F -> sigma [...]."""
        x = mlp_apply_split(self.mlp.layers(), _pieces(features), compute_dtype)
        return truncated_exp(x.float() - 1.0, self.fwd_clamp)[..., 0]


class ColorDecoder(nn.Module):
    """[posenc(d) | d | features] -> MLP -> sigmoid, as a split first layer."""

    def __init__(
        self, n_freqs: int, in_features: int, hidden_features: int = 64,
        hidden_layers: int = 3, generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.n_freqs = n_freqs
        total = in_features + posenc_dim(3, n_freqs) + 3
        self.mlp = MLP(total, hidden_features, hidden_layers, 3, generator, device)

    def forward(self, features, rays_d: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        pieces = (positional_encoding(rays_d, self.n_freqs), rays_d) + _pieces(features)
        out = mlp_apply_split(self.mlp.layers(), pieces, compute_dtype)
        return torch.sigmoid(out.float())

    def apply_per_ray(
        self, features, d_ray: torch.Tensor, seg: torch.Tensor,
        compute_dtype=torch.float32,
    ) -> torch.Tensor:
        """Serving variant: the direction branch (posenc + direction rows of
        the first layer) once per RAY (d_ray [n_rays, 3]), gathered to the
        sample rows through `seg`."""
        ray_pieces = (positional_encoding(d_ray, self.n_freqs), d_ray)
        out = mlp_apply_split_per_ray(
            self.mlp.layers(), ray_pieces, seg, _pieces(features), compute_dtype
        )
        return torch.sigmoid(out.float())
