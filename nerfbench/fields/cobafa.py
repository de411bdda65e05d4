"""The CoBaFa field of Factor Fields (Chen et al. 2023, arXiv:2302.01226),
as the reference computes it: per level a basis grid at sawtooth(f x)
times the level's coefficient from one coefficient grid, dropout, and the
field MLP.  No extra loss term."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from nerfbench.reference.nerf import hash_u01, mlp, mlp_shapes, rounded, trilinear

# the control one precision below bfloat16: the reference in float8_e4m3fn
# (the program has no float8 path for this field)
CONTROL = None
# the CPU tests' sizes: the same structure at the program's field_scale 0.1
TINY = {"train": {"field_scale": 0.1}, "field": {"basis_res": [8, 8, 8, 8, 10, 12], "coef_res": 8}}


def param_shapes(config: dict) -> Dict[str, tuple]:
    """The field's parameters in draw order: the basis grids [r, r, r, C],
    the coefficient grid [r, r, r, levels], then the field MLP."""
    field = config["field"]
    shapes = {f"field.basis.{i}": (r, r, r, c) for i, (r, c) in enumerate(zip(field["basis_res"], field["channels"]))}
    r = field["coef_res"]
    shapes["field.coef"] = (r, r, r, len(field["basis_res"]))
    shapes.update(mlp_shapes("field.mlp", field["mlp"]))
    return shapes


def features(config: dict, params: Dict[str, torch.Tensor], x: torch.Tensor, prec: str,
             dropout_seed: Optional[torch.Tensor] = None, rows: Optional[torch.Tensor] = None) -> list:
    """The field MLP's output at contracted positions x [n, 3]: per level
    the basis grid at sawtooth(f x) times the level's coefficient, with
    dropout when `dropout_seed` is given (keyed by the sample's row and
    feature column)."""
    field = config["field"]
    coefs = trilinear(rounded(params["field.coef"], prec), x)
    feats, col = [], 0
    for i, f in enumerate(field["freqs"]):
        saw = 2.0 * torch.remainder(f * x, 1.0) - 1.0
        y = trilinear(rounded(params[f"field.basis.{i}"], prec), saw) * coefs[:, i : i + 1]
        if dropout_seed is not None:
            p = field["dropout_p"]
            cols = torch.arange(col, col + y.shape[1], device=x.device)
            keep = hash_u01(dropout_seed, rows[:, None], cols[None, :]) >= p
            y = torch.where(keep, y / (1.0 - p), 0.0)
        feats.append(y)
        col += y.shape[1]
    return [mlp(params, "field.mlp", len(field["mlp"]) - 1, feats, prec)]


def extra_loss(config: dict, params: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
    return None
