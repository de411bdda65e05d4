"""Method registry: field + the shared decoders, wired as the JAX package's
`tinynerf_tpu/models/registry.py:make_model` does, for the vanilla, K-Planes
and Cobafa fields, and for Instant-NGP's hash grid, which only the port has."""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..ops.hashgrid import level_resolutions
from .cobafa import CobafaFeatureField
from .hashgrid import NGP_LOG2_HASHMAP_SIZE, HashGridFeatureField
from .kplanes import KPlanesFeatureField
from .vanilla import ColorDecoder, OpacityDecoder, VanillaFeatureField

METHODS = ("vanilla", "kplanes", "cobafa", "instantngp")


def make_model(
    method: str,
    fwd_clamp: bool = True,
    field_scale: float = 1.0,
    generator: Optional[torch.Generator] = None,
    device=None,
    **field_kw,
) -> Tuple[Union[VanillaFeatureField, KPlanesFeatureField, CobafaFeatureField, HashGridFeatureField],
           OpacityDecoder, ColorDecoder]:
    """Returns (feature_field, sigma_decoder, rgb_decoder), initialized from
    `generator` on `device`.

    `field_scale` scales the field's spatial capacity while keeping its
    structure.  Vanilla: the MLP width max(32, round(256 * s)), 8 hidden
    layers on posenc(10).  K-Planes: the base resolution b =
    max(9, round(129 * s) | 1) and the nesting (b, 2b-1, 4b-3) the fused
    multiscale lookup requires; 1.0 gives the reference's (129, 257, 513).  Cobafa: basis grids max(8, int(r * s))
    for r in linspace(32, 128, 6) and a coefficient grid max(8, int(64 * s)),
    with the channels, frequencies and MLP width unchanged.  Instant-NGP:
    16 levels from N_min 16 to N_max max(32, round(2048 s)) and T =
    2^max(13, round(19 + 3 log2 s)) rows a hashed level; 1.0 gives the
    published widths, 0.1 levels 0-1 dense and 14 hashed.

    `field_kw` go to the field's constructor as they are (the JAX tools
    `dataclasses.replace` the field with them): K-Planes takes
    `init_range`, `gather_dtype`, `lookup_mode`, `scatter_dtype` and
    `fwd_mode`; Cobafa `init_range`, `gather_dtype`, `lookup_mode`,
    `scatter_dtype`, `dropout_p` and `mlp_init_mode`; the vanilla field
    `init_mode`.  None changes a parameter's shape, so `convert.py` carries
    parameters across every layout."""
    s = float(field_scale)
    if method == "vanilla":
        field = VanillaFeatureField(
            n_freqs=10, hidden_features=max(32, int(round(256 * s))), hidden_layers=8,
            generator=generator, device=device, **field_kw,
        )
    elif method == "kplanes":
        b = max(9, int(round(129 * s)) | 1)
        field = KPlanesFeatureField(
            feature_dim_per_plane=32, resolutions=(b, 2 * b - 1, 4 * b - 3),
            generator=generator, device=device, **field_kw,
        )
    elif method == "cobafa":
        field = CobafaFeatureField(
            basis_res=tuple(max(8, int(r * s)) for r in np.linspace(32.0, 128.0, 6)),
            coef_res=max(8, int(64 * s)),
            freqs=tuple(float(f) for f in np.linspace(2.0, 8.0, 6)),
            channels=(8, 8, 8, 4, 4, 4),
            mlp_hidden_dim=128,
            generator=generator, device=device, **field_kw,
        )
    elif method == "instantngp":
        field = HashGridFeatureField(
            resolutions=level_resolutions(16, max(32, int(round(2048 * s))), 16),
            log2_hashmap_size=max(13, int(round(NGP_LOG2_HASHMAP_SIZE + 3 * math.log2(s)))),
            generator=generator, device=device, **field_kw,
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
