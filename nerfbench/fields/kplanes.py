"""The K-Planes field (Fridovich-Keil et al. 2023, arXiv:2301.10241), as
the reference computes it: per scale three feature planes, the product of
their bilinear lookups at the sample's coordinate pairs, and total
variation on the planes as an extra loss term."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from nerfbench.reference.nerf import bilinear, rounded

# the control one precision below bfloat16: the program's float8 table gathers
CONTROL = {"gather_dtype": "float8"}
# the CPU tests' sizes: the same structure at the program's field_scale 0.07
TINY = {"train": {"field_scale": 0.07}, "field": {"resolutions": [9, 17, 33]}}


def param_shapes(config: dict) -> Dict[str, tuple]:
    """The field's parameters in draw order: per scale, per plane [r, r, F]."""
    field = config["field"]
    return {f"field.planes.{s}.{p}": (r, r, field["features"])
            for s, r in enumerate(field["resolutions"]) for p in range(len(field["pairs"]))}


def features(config: dict, params: Dict[str, torch.Tensor], x: torch.Tensor, prec: str,
             dropout_seed: Optional[torch.Tensor] = None, rows: Optional[torch.Tensor] = None) -> list:
    """Per scale the product of the three planes' lookups at contracted
    positions x [n, 3], rounded (no dropout)."""
    field = config["field"]
    scales = []
    for s in range(len(field["resolutions"])):
        acc = None
        for p, (a, b) in enumerate(field["pairs"]):
            v = bilinear(rounded(params[f"field.planes.{s}.{p}"], prec), x[:, [a, b]])
            acc = v if acc is None else acc * v
        scales.append(rounded(acc, prec))
    return scales


def tv_loss(config: dict, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The mean over planes of the mean squared neighbour differences along
    both plane axes."""
    field = config["field"]
    total, count = 0.0, 0
    for s in range(len(field["resolutions"])):
        for p in range(len(field["pairs"])):
            plane = params[f"field.planes.{s}.{p}"]
            r0, r1, f = plane.shape
            v = plane.reshape(r0, r1 * f)
            total = total + torch.mean((v[1:] - v[:-1]) ** 2) + torch.mean((v[:, f:] - v[:, :-f]) ** 2)
            count += 1
    return total / count


def extra_loss(config: dict, params: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
    """Total variation weighted by `tv_reg_alpha` (none at 0)."""
    alpha = config["train"]["tv_reg_alpha"]
    return alpha * tv_loss(config, params) if alpha else None
