"""Instant-NGP's multiresolution hash encoding (Mueller et al. 2022,
arXiv:2201.05989, section 3), as the reference computes it: per level the
eight corners of the sample's cell, each a row of a dense grid or of a
table indexed by the spatial hash, interpolated trilinearly; the levels'
features concatenated into one piece.  No extra loss term.

A level of resolution N is dense when its (N + 1)^3 vertices fit the table
size T (vertex (x, y, z) at row (x (N + 1) + y) (N + 1) + z), else hashed:
(x p0 xor y p1 xor z p2) mod 2^32 mod T.  A position p in [-1, 1]^3 is at
vertex coordinate ((p + 1) / 2) N, clamped to [0, N]; the cell origin its
floor, clipped to [0, N - 1]."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from nerfbench.reference.nerf import rounded

# the control one precision below bfloat16: the reference in float8_e4m3fn
# (the program has no float8 path for this field)
CONTROL = None
# the CPU tests' sizes: the same 16 levels at the program's field_scale 0.1
TINY = {"train": {"field_scale": 0.1},
        "field": {"log2_hashmap_size": 13, "max_resolution": 205,
                  "resolutions": [16, 18, 22, 26, 31, 37, 44, 52, 62, 73, 87, 103, 123, 145, 172, 205]}}


def level_rows(field: dict) -> List[int]:
    size = 2 ** field["log2_hashmap_size"]
    return [min((r + 1) ** 3, size) for r in field["resolutions"]]


def param_shapes(config: dict) -> Dict[str, tuple]:
    """One flat table of every level's rows."""
    field = config["field"]
    return {"field.tables": (sum(level_rows(field)), field["features_per_level"])}


def _rows(field: dict, level: int, v: torch.Tensor) -> torch.Tensor:
    """Rows of the vertices v [n, 3] (int64) of level `level`."""
    res, log2 = field["resolutions"][level], field["log2_hashmap_size"]
    offset = sum(level_rows(field)[:level])
    if (res + 1) ** 3 <= 2**log2:
        return offset + (v[:, 0] * (res + 1) + v[:, 1]) * (res + 1) + v[:, 2]
    p = field["hash_primes"]
    h = ((v[:, 0] * p[0]) ^ (v[:, 1] * p[1]) ^ (v[:, 2] * p[2])) & 0xFFFFFFFF
    return offset + h % 2**log2


def features(config: dict, params: Dict[str, torch.Tensor], x: torch.Tensor, prec: str,
             dropout_seed: Optional[torch.Tensor] = None, rows: Optional[torch.Tensor] = None) -> list:
    """The L levels' lookups at contracted positions x [n, 3], the table
    rounded to `prec`, concatenated [n, L F] (no dropout)."""
    field = config["field"]
    table = rounded(params["field.tables"], prec)
    out = []
    for level, res in enumerate(field["resolutions"]):
        v = torch.clamp((x + 1.0) * 0.5 * res, 0.0, float(res))
        origin = torch.clamp(torch.floor(v), 0.0, float(res - 1))
        t = v - origin
        acc = 0.0
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    d = torch.tensor([dx, dy, dz], device=x.device)
                    w = torch.prod(torch.where(d.bool(), t, 1.0 - t), dim=-1)
                    acc = acc + table[_rows(field, level, origin.long() + d)] * w[:, None]
        out.append(acc)
    return [torch.cat(out, dim=-1)]


def extra_loss(config: dict, params: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
    return None
