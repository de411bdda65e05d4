"""Cobafa field: cosine/periodic basis factorization (arXiv 2302.01226).

Counterpart of `CobafaFeatureField` in `tinynerf_tpu/models/cobafa.py`
with the lookup the JAX package runs on its accelerator (`lookup_mode=
"quad"`): L basis grids `[r, r, r, C]` queried at sawtooth-tiled
coordinates `sawtooth(x, f_l)`, each scaled by channel l of a trilinearly
interpolated coefficient grid `[R, R, R, L]`; the per-level features go
into the field MLP's split first layer (5 hidden layers of `mlp_hidden_dim`,
He init) without a concat.  Grids are initialized U(lo, hi) (`init_range`,
U(0.5, 1.5) by default).  Every lookup is `ops/interp.py:
trilinear_lookup_oct` (the oct table built by the CUDA kernel on the card),
with corners rounded to bf16 as the JAX default does (`gather_dtype=
"bfloat16"`); any other `gather_dtype`, "float8" included, is f32 there
(`tinynerf_tpu/models/cobafa.py`), and so here.

Dropout(p = 0.01) runs at train time only, when the caller passes the
step's seed words: keep where the stateless hash of `ops/hashrng.py` gives
u >= p, survivors scaled by 1 / (1 - p).  The hash is keyed by (seed words,
sample row, feature column of the concatenated features), so each level
draws from ids of its own and every feature element gets its own
Bernoulli draw, the semantics of the reference's Dropout over the
concatenated features; the CPU and the card give the same mask from the
same words.  jax.random cannot be reproduced, so the JAX package's own mask
differs (tests compare with dropout off).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.hashrng import hash_u01
from ..ops.interp import sawtooth, trilinear_lookup_oct
from .mlp import MLP, mlp_apply_split

# the JAX field's default gather_dtype: corners round to bf16 before the lerp
GATHER_DTYPE = torch.bfloat16
DROPOUT_P = 0.01


def dropout(y: torch.Tensor, seed, col0: int) -> torch.Tensor:
    """Train-time dropout of y [..., C] keyed by `seed` (two uint32 words)
    and the feature columns col0 .. col0 + C - 1."""
    c = y.shape[-1]
    flat = y.reshape(-1, c)
    dev = y.device
    u = hash_u01(seed, torch.arange(flat.shape[0], device=dev)[:, None],
                 torch.arange(col0, col0 + c, device=dev)[None, :])
    keep = u >= DROPOUT_P
    return torch.where(keep, flat / (1.0 - DROPOUT_P), 0.0).reshape(y.shape)


class CobafaFeatureField(nn.Module):
    # optimizer groups (train/loop.py `_decay_mask`): the grids are tables
    table_keys = frozenset({"basis", "coef"})
    mlp_keys = frozenset({"mlp"})

    def __init__(
        self,
        basis_res: Tuple[int, ...] = (32, 51, 70, 89, 108, 128),
        coef_res: int = 64,
        freqs: Tuple[float, ...] = (2.0, 3.2, 4.4, 5.6, 6.8, 8.0),
        channels: Tuple[int, ...] = (8, 8, 8, 4, 4, 4),
        mlp_hidden_dim: int = 128,
        init_range: Tuple[float, float] = (0.5, 1.5),
        gather_dtype: str = "bfloat16",
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if not len(basis_res) == len(freqs) == len(channels):
            raise ValueError("basis_res, freqs and channels need one entry per level")
        self.basis_res, self.coef_res = tuple(basis_res), coef_res
        self.freqs, self.channels = tuple(freqs), tuple(channels)
        self.mlp_hidden_dim = mlp_hidden_dim
        self.init_range = tuple(init_range)
        self.gather_dtype = gather_dtype
        lo, hi = self.init_range
        grid = lambda *shape: nn.Parameter(
            torch.empty(shape).uniform_(lo, hi, generator=generator).to(device))
        self.basis = nn.ParameterList([grid(r, r, r, c) for r, c in zip(self.basis_res, self.channels)])
        self.coef = grid(coef_res, coef_res, coef_res, len(self.basis_res))
        self.mlp = MLP(sum(self.channels), mlp_hidden_dim, 5, generator=generator, device=device, init="he")

    @property
    def feature_dim(self) -> int:
        return self.mlp_hidden_dim

    def apply_pieces(self, x: torch.Tensor, compute_dtype=torch.float32, dropout_seed=None) -> tuple:
        """x: [..., 3] in [-1, 1] -> ([..., feature_dim],): the MLP's output
        as the decoders' single piece.  `dropout_seed` (two uint32 words)
        turns on train-time dropout; None is eval (the identity)."""
        gd = GATHER_DTYPE if self.gather_dtype == "bfloat16" else torch.float32
        coefs = trilinear_lookup_oct(self.coef, x, gd)  # [..., L]
        feats, col = [], 0
        for i, (f, basis) in enumerate(zip(self.freqs, self.basis)):
            y = trilinear_lookup_oct(basis, sawtooth(x, f), gd) * coefs[..., i : i + 1]
            if dropout_seed is not None:
                y = dropout(y, dropout_seed, col)
            feats.append(y)
            col += y.shape[-1]
        return (mlp_apply_split(self.mlp.layers(), feats, compute_dtype),)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32, dropout_seed=None) -> torch.Tensor:
        return self.apply_pieces(x, compute_dtype, dropout_seed)[0]
