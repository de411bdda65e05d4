"""The vanilla NeRF field and the sigma and color decoders every field shares.

Counterpart of `tinynerf_tpu/models/vanilla.py`; gradients come from
autograd (the clamped exp's through `ops/trunc_exp.py`):

  * `VanillaFeatureField`: posenc(n_freqs) -> MLP(hidden, layers), the
    features the MLP's last layer (`feature_dim = hidden_features`);
    train() takes (10, 256, 8) with He init (`init_mode`);
  * `OpacityDecoder`: MLP(dim -> 64 -> 1) then truncated_exp(x - 1) >= 0;
  * `ColorDecoder`: [posenc(d) | d | features] -> MLP -> sigmoid, the
    concat computed as a split first layer.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.trunc_exp import truncated_exp
from .encodings import posenc_dim, positional_encoding
from .mlp import MLP, mlp_apply, mlp_apply_split, mlp_apply_split_per_ray


def _pieces(features) -> tuple:
    return tuple(features) if isinstance(features, (tuple, list)) else (features,)


class VanillaFeatureField(nn.Module):
    # optimizer groups (train/loop.py `_decay_mask`): no tables
    table_keys = frozenset()
    mlp_keys = frozenset({"mlp"})

    def __init__(
        self, n_freqs: int = 10, hidden_features: int = 256, hidden_layers: int = 8,
        init_mode: str = "he", generator: Optional[torch.Generator] = None, device=None,
    ):
        """`init_mode` (the JAX field's): "he", the default, keeps the
        positional signal alive through the 10-layer stack, where the
        reference's init ("torch") decays it ~3x per layer."""
        super().__init__()
        self.n_freqs = n_freqs
        self.hidden_features = hidden_features
        self.init_mode = init_mode
        self.mlp = MLP(posenc_dim(3, n_freqs), hidden_features, hidden_layers,
                       generator=generator, device=device, init=init_mode)

    @property
    def feature_dim(self) -> int:
        return self.hidden_features

    def apply_pieces(self, x: torch.Tensor, compute_dtype=torch.float32) -> tuple:
        """x: [..., 3] in [-1, 1] -> ([..., feature_dim],), the decoders'
        single piece."""
        return (mlp_apply(self.mlp.layers(), positional_encoding(x, self.n_freqs), compute_dtype),)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        return self.apply_pieces(x, compute_dtype)[0]


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
