"""Cobafa field: cosine/periodic basis factorization (arXiv 2302.01226).

Counterpart of `CobafaFeatureField` in `tinynerf_tpu/models/cobafa.py`: L
basis grids `[r, r, r, C]` queried at sawtooth-tiled coordinates
`sawtooth(x, f_l)`, each scaled by channel l of a trilinearly interpolated
coefficient grid `[R, R, R, L]`; the per-level features go into the field
MLP's split first layer (5 hidden layers of `mlp_hidden_dim`; `mlp_init_mode`
"he", the default, or "torch", the reference's) without a concat.  Grids are
initialized U(lo, hi) (`init_range`, U(0.5, 1.5) by default).

`lookup_mode` (`ops/interp.py` has each lookup): "auto" (the default) and
"quad" are `trilinear_lookup_oct`, one 8F row per sample from the grid's oct
table (built by the CUDA kernel on the card): the layout the JAX package
runs on its accelerator, which the port runs on every device (JAX's "auto"
is "mixed" off a TPU); "mixed" gathers the eight corner rows from the grid
rounded to `gather_dtype` (`trilinear_lookup_mixed`; with `scatter_dtype`
"bfloat16" the gradient's f32 sums are rounded once to bf16); "plain" gathers
them in f32 (`trilinear_lookup`).  Every backward is the oct gradient, summed
in a fixed order.  Corners round to bf16 with the default `gather_dtype=
"bfloat16"`; any other `gather_dtype`, "float8" included, is f32 there
(`tinynerf_tpu/models/cobafa.py`), and so here.  An unknown `lookup_mode`,
`scatter_dtype` or `mlp_init_mode` raises (the JAX field takes an unknown
lookup for "plain").

Dropout (`dropout_p`, 0.01 by default; 0 turns it off) runs at train time
only, when the caller passes the step's seed words: keep where the
stateless hash of `ops/hashrng.py` gives u >= p, survivors scaled by 1 / (1 -
p).  The hash is keyed by (seed words, sample row, feature column of the
concatenated features), so each level draws from ids of its own and every
feature element gets its own Bernoulli draw, the semantics of the
reference's Dropout over the concatenated features; the CPU and the card
give the same mask from the same words.  jax.random cannot be reproduced,
so the JAX package's own mask differs (tests compare with dropout off).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.hashrng import hash_u01
from ..ops.interp import sawtooth, trilinear_lookup, trilinear_lookup_mixed, trilinear_lookup_oct
from .mlp import MLP, mlp_apply_split

# the JAX field's default gather_dtype: corners round to bf16 before the lerp
GATHER_DTYPE = torch.bfloat16
DROPOUT_P = 0.01  # the default dropout_p
LOOKUP_MODES = ("auto", "quad", "mixed", "plain")
SCATTER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dropout(y: torch.Tensor, seed, col0: int, p: float = DROPOUT_P) -> torch.Tensor:
    """Train-time dropout of y [..., C] with probability p, keyed by `seed`
    (two uint32 words) and the feature columns col0 .. col0 + C - 1."""
    c = y.shape[-1]
    flat = y.reshape(-1, c)
    dev = y.device
    u = hash_u01(seed, torch.arange(flat.shape[0], device=dev)[:, None],
                 torch.arange(col0, col0 + c, device=dev)[None, :])
    keep = u >= p
    return torch.where(keep, flat / (1.0 - p), 0.0).reshape(y.shape)


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
        lookup_mode: str = "auto",
        scatter_dtype: str = "float32",
        dropout_p: float = DROPOUT_P,
        mlp_init_mode: str = "he",
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
        self.lookup_mode = lookup_mode
        self.scatter_dtype = scatter_dtype  # "mixed" only
        self.dropout_p = float(dropout_p)
        self.mlp_init_mode = mlp_init_mode
        self._lookup()  # the options are known ones
        lo, hi = self.init_range
        grid = lambda *shape: nn.Parameter(
            torch.empty(shape).uniform_(lo, hi, generator=generator).to(device))
        self.basis = nn.ParameterList([grid(r, r, r, c) for r, c in zip(self.basis_res, self.channels)])
        self.coef = grid(coef_res, coef_res, coef_res, len(self.basis_res))
        self.mlp = MLP(sum(self.channels), mlp_hidden_dim, 5, generator=generator, device=device, init=mlp_init_mode)

    @property
    def feature_dim(self) -> int:
        return self.mlp_hidden_dim

    def _lookup(self):
        """(table, coords) -> the f32 lookup of `lookup_mode`."""
        gd = GATHER_DTYPE if self.gather_dtype == "bfloat16" else torch.float32
        if self.scatter_dtype not in SCATTER_DTYPES:
            raise ValueError(f"scatter_dtype must be one of {sorted(SCATTER_DTYPES)}, got {self.scatter_dtype!r}")
        if self.lookup_mode in ("auto", "quad"):
            return lambda t, c: trilinear_lookup_oct(t, c, gd)
        if self.lookup_mode == "mixed":
            sd = SCATTER_DTYPES[self.scatter_dtype]
            return lambda t, c: trilinear_lookup_mixed(t, c, gd, sd)
        if self.lookup_mode == "plain":
            return trilinear_lookup
        raise ValueError(f"lookup_mode must be one of {LOOKUP_MODES}, got {self.lookup_mode!r}")

    def apply_pieces(self, x: torch.Tensor, compute_dtype=torch.float32, dropout_seed=None) -> tuple:
        """x: [..., 3] in [-1, 1] -> ([..., feature_dim],): the MLP's output
        as the decoders' single piece.  `dropout_seed` (two uint32 words)
        turns on train-time dropout; None is eval (the identity)."""
        lookup = self._lookup()
        coefs = lookup(self.coef, x)  # [..., L]
        feats, col = [], 0
        for i, (f, basis) in enumerate(zip(self.freqs, self.basis)):
            y = lookup(basis, sawtooth(x, f)) * coefs[..., i : i + 1]
            if dropout_seed is not None and self.dropout_p > 0.0:
                y = dropout(y, dropout_seed, col, self.dropout_p)
            feats.append(y)
            col += y.shape[-1]
        return (mlp_apply_split(self.mlp.layers(), feats, compute_dtype),)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32, dropout_seed=None) -> torch.Tensor:
        return self.apply_pieces(x, compute_dtype, dropout_seed)[0]
