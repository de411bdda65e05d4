"""A plain PyTorch reference of Instant-NGP's multiresolution hash encoding
(Mueller et al. 2022, arXiv:2201.05989, section 3), written from the paper
and the published widths, for the tests of `tinynerf_tpu_torch`'s hash-grid
field.  It imports neither JAX nor any module of the program: gradients come
from autograd on it.

Levels of resolution N_l share one flat table of rows of F features.  A
level whose (N_l + 1)^3 vertices fit T rows is dense (vertex (x, y, z) at
row (x (N_l + 1) + y) (N_l + 1) + z), any other hashed: (x * 1 xor y *
2654435761 xor z * 805459861) mod 2^32 mod T.  A position p in [-1, 1]^3 is
x = (p + 1) / 2, at vertex coordinate x N_l (clamped to [0, N_l]); the cell
origin is its floor, clipped to [0, N_l - 1], and the 8 corners are
interpolated trilinearly.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

HASH_PRIMES = (1, 2654435761, 805459861)


def level_rows(resolutions: Sequence[int], log2_size: int) -> List[int]:
    size = 2**log2_size
    return [min((r + 1) ** 3, size) for r in resolutions]


def is_hashed(resolution: int, log2_size: int) -> bool:
    return (resolution + 1) ** 3 > 2**log2_size


def spatial_hash(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor, log2_size: int) -> torch.Tensor:
    """The hash of integer vertices (int64, >= 0) in uint32 arithmetic, mod T."""
    m32 = 2**32 - 1
    h = ((ix * HASH_PRIMES[0]) & m32) ^ ((iy * HASH_PRIMES[1]) & m32) ^ ((iz * HASH_PRIMES[2]) & m32)
    return h % (2**log2_size)


def dense_index(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor, resolution: int) -> torch.Tensor:
    side = resolution + 1
    return (ix * side + iy) * side + iz


def vertex_rows(level: int, ix, iy, iz, resolutions: Sequence[int], log2_size: int) -> torch.Tensor:
    """Rows of the flat table of level `level`'s vertices."""
    offset = sum(level_rows(resolutions, log2_size)[:level])
    r = resolutions[level]
    local = spatial_hash(ix, iy, iz, log2_size) if is_hashed(r, log2_size) else dense_index(ix, iy, iz, r)
    return offset + local


def cell(x: torch.Tensor, resolution: int):
    """(origin [n, 3] int64, fraction [n, 3] f32) of positions x [n, 3] in [-1, 1]."""
    v = torch.clamp((x + 1.0) * 0.5 * resolution, 0.0, float(resolution))
    origin = torch.clamp(torch.floor(v), 0.0, float(resolution - 1))
    return origin.long(), v - origin


def corners(x: torch.Tensor, level: int, resolutions: Sequence[int], log2_size: int):
    """(rows [n, 8], weights [n, 8]) of one level, corner (dx, dy, dz) at
    index 4 dx + 2 dy + dz."""
    origin, frac = cell(x, resolutions[level])
    rows, weights = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                d = torch.tensor([dx, dy, dz])
                v = origin + d
                rows.append(vertex_rows(level, v[:, 0], v[:, 1], v[:, 2], resolutions, log2_size))
                weights.append(torch.prod(torch.where(d.bool(), frac, 1.0 - frac), dim=-1))
    return torch.stack(rows, dim=-1), torch.stack(weights, dim=-1)


def rounded(t: torch.Tensor, prec: str) -> torch.Tensor:
    """t rounded to bf16 ("bf16") or kept ("f32"), its gradient passed through."""
    if prec == "f32":
        return t
    return t + (t.to(torch.bfloat16).float() - t).detach()


def features(table: torch.Tensor, x: torch.Tensor, resolutions: Sequence[int], log2_size: int,
             prec: str = "bf16") -> torch.Tensor:
    """The concatenated levels' lookups [n, L F] of the table [rows, F] at
    positions x [n, 3] in [-1, 1], the table's values rounded to `prec`."""
    t = rounded(table, prec)
    out = []
    for level in range(len(resolutions)):
        rows, w = corners(x, level, resolutions, log2_size)
        out.append(torch.einsum("nc,ncf->nf", w, t[rows]))
    return torch.cat(out, dim=-1)


class PlainHashField(nn.Module):
    """The field on a given table parameter, with the program's field API
    (`apply_pieces`, `feature_dim`, `table_keys`), the lookup by autograd."""

    table_keys = frozenset({"tables"})
    mlp_keys = frozenset()

    def __init__(self, tables: nn.Parameter, resolutions: Sequence[int], log2_size: int, prec: str = "bf16"):
        super().__init__()
        self.tables = tables
        self.resolutions, self.log2_size, self.prec = tuple(resolutions), log2_size, prec

    @property
    def feature_dim(self) -> int:
        return len(self.resolutions) * self.tables.shape[-1]

    def apply_pieces(self, x: torch.Tensor, compute_dtype=torch.float32) -> tuple:
        f = features(self.tables, x.reshape(-1, 3).float(), self.resolutions, self.log2_size, self.prec)
        return (f.reshape(*x.shape[:-1], self.feature_dim),)
