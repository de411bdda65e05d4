"""Instant-NGP's field: the multiresolution hash encoding (Mueller et al.
2022, arXiv:2201.05989, sections 3 and 5.4), the encoding of nerfstudio's
`nerfacto` field.

The JAX package has no such field.  L levels of F = 2 features over one
flat table `tables` [rows, F] (`ops/hashgrid.py` `HashLayout`): a level
whose (N_l + 1)^3 vertices fit T = 2^log2_hashmap_size rows is a dense
grid, every finer one a hashed table of T rows.  The features are the L
levels' trilinear lookups concatenated (`feature_dim` = L F), the corner
rows rounded to bf16 and the lerp in f32 (`hash_lookup`: one kernel launch
for all levels on the card, its gradient summed in a fixed order), as the
decoders' single piece.  The published widths, which `make_model` gives at
`field_scale` 1.0: L = 16, N_min = 16, N_max = 2048 (`NGP_RESOLUTIONS`,
floor(N_min b^l) in float64), T = 2^19; levels 0-4 dense, 6,098,925 rows.
Tables are initialized U(-1e-4, 1e-4), the paper's, and are the field's
only parameters (`table_keys`: the table learning rate, no weight decay).
There is no dropout.  The heads are the shared decoders of
`models/vanilla.py`, not NGP's own density and SH color networks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.hashgrid import FEATURES, HashLayout, hash_lookup, level_resolutions
from ..utils.trace import span

NGP_RESOLUTIONS = level_resolutions(16, 2048, 16)
NGP_LOG2_HASHMAP_SIZE = 19
INIT_RANGE = (-1e-4, 1e-4)


class HashGridFeatureField(nn.Module):
    # optimizer groups (train/loop.py `_decay_mask`): the flat table is a table
    table_keys = frozenset({"tables"})
    mlp_keys = frozenset()

    def __init__(
        self,
        resolutions: Tuple[int, ...] = NGP_RESOLUTIONS,
        log2_hashmap_size: int = NGP_LOG2_HASHMAP_SIZE,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.layout = HashLayout(tuple(int(r) for r in resolutions), int(log2_hashmap_size))
        lo, hi = INIT_RANGE
        self.tables = nn.Parameter(
            torch.empty(self.layout.rows, FEATURES).uniform_(lo, hi, generator=generator).to(device))

    @property
    def feature_dim(self) -> int:
        return len(self.layout.resolutions) * FEATURES

    def apply_pieces(self, x: torch.Tensor, compute_dtype=torch.float32) -> tuple:
        """x: [..., 3] in [-1, 1] -> ([..., feature_dim] f32,), the decoders'
        single piece."""
        with span("field.hash_encode"):
            feats = hash_lookup(self.tables, x.reshape(-1, 3), self.layout)
        return (feats.reshape(*x.shape[:-1], self.feature_dim),)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        return self.apply_pieces(x, compute_dtype)[0]
