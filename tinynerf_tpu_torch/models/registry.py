"""Method registry: field + the shared decoders, wired as the JAX package's
`tinynerf_tpu/models/registry.py:make_model` does.  Only K-Planes is ported."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kplanes import KPlanesFeatureField
from .vanilla import ColorDecoder, OpacityDecoder

METHODS = ("vanilla", "kplanes", "cobafa")


def make_model(
    method: str,
    fwd_clamp: bool = True,
    field_scale: float = 1.0,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Tuple[KPlanesFeatureField, OpacityDecoder, ColorDecoder]:
    """Returns (feature_field, sigma_decoder, rgb_decoder), initialized from
    `generator` on `device`.

    `field_scale` scales the table resolutions while keeping the structure:
    the base resolution b = max(9, round(129 * s) | 1) and the nesting
    (b, 2b-1, 4b-3) the fused multiscale lookup requires; 1.0 gives the
    reference's (129, 257, 513)."""
    if method == "kplanes":
        b = max(9, int(round(129 * float(field_scale))) | 1)
        field = KPlanesFeatureField(
            feature_dim_per_plane=32, resolutions=(b, 2 * b - 1, 4 * b - 3),
            generator=generator, device=device,
        )
    elif method in ("vanilla", "cobafa"):
        raise NotImplementedError(
            f"method {method!r} is not ported yet (ROADMAP.md Queue 1, items 11-12)"
        )
    else:
        raise NotImplementedError(f"Unknown method {method!r}.")

    dim = field.feature_dim
    sigma_decoder = OpacityDecoder(
        feature_dim=dim, fwd_clamp=fwd_clamp, generator=generator, device=device
    )
    rgb_decoder = ColorDecoder(
        n_freqs=8, in_features=dim, hidden_features=64, hidden_layers=3,
        generator=generator, device=device,
    )
    return field, sigma_decoder, rgb_decoder
