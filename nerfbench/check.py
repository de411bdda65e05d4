"""The numbers that decide `correct`: what the timed path produced against
the plain reference (`reference/nerf.py`), each beside the limit that
`limits/<workload>.json` sets for it (PERF.md gives the readings each
limit was set from)."""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict, List

import numpy as np

LIMITS = Path(__file__).resolve().parent / "limits"
# leaves whose reference gradient is under this share of the median leaf's
# move under Adam by round-off alone: left out of the change's comparison
ROUNDOFF_LEAF = 1e-3


def norm_gap(prog: Dict[str, float], ref: Dict[str, float], leaves: List[str]) -> float:
    """The worst leaf's |program norm - reference norm| over the larger of
    the reference's norm of that leaf and of the median leaf."""
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """first_loss_gap: the first step's relative loss gap (its forward alone:
    steady from seed to seed); loss_gap: the checked steps' worst; count_gap:
    kept samples and rays trained on that differ, summed over those steps
    (an exact comparison); grad_gap: the first gradient's worst leaf;
    update_gap: the change after the checked steps' worst leaf, leaves with
    a round-off gradient left out."""
    leaves = sorted(ref["grad_norm"])
    med = statistics.median(ref["grad_norm"][k] for k in leaves)
    moved = [k for k in leaves if ref["grad_norm"][k] >= ROUNDOFF_LEAF * med]
    return {
        "first_loss_gap": abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]),
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])),
        "count_gap": float(sum(abs(p - r) for key in ("samples", "rays_used")
                               for p, r in zip(prog[key], ref[key]))),
        "grad_gap": norm_gap(prog["grad_norm"], ref["grad_norm"], leaves),
        "update_gap": norm_gap(prog["update_norm"], ref["update_norm"], moved),
    }


def serve_numbers(images: List[np.ndarray], refs: List[np.ndarray]) -> Dict[str, float]:
    """view_rmse: the worst checked view's root mean square pixel gap;
    view_max_gap: the widest gap of any checked pixel channel."""
    rmse = max(float(np.sqrt(np.mean((a.astype(np.float64) - b) ** 2))) for a, b in zip(images, refs))
    gap = max(float(np.max(np.abs(a.astype(np.float64) - b))) for a, b in zip(images, refs))
    return {"view_rmse": rmse, "view_max_gap": gap}


def load_limits(workload: str) -> Dict[str, float]:
    with open(LIMITS / f"{workload}.json") as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number the cell compares beside its limit; one that is missing
    or not finite fails."""
    return {k: {"value": numbers.get(k, float("nan")), "limit": lim,
                "ok": math.isfinite(numbers.get(k, float("nan"))) and numbers[k] <= lim}
            for k, lim in limits.items()}
