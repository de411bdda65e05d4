"""Checkpoints in the JAX package's format, read and written without jax.

Counterpart of `tinynerf_tpu/train/checkpoint.py`.  A checkpoint is
`ckpt_{step}.pkl`, one pickle of `{"step": int, "state": {"params",
"occ_state", "meta", ...}}` whose leaves are numpy arrays: params in the
JAX pytree layout (`convert.py`), the occupancy state as a NamedTuple
(grid, mean).

Reading uses a restricted unpickler: it resolves only numpy's array
reconstruction and the two classes a JAX-written checkpoint names,
`tinynerf_tpu.core.occupancy.OccupancyState` and
`optax._src.transform.ScaleByAdamState`, which it maps to local stand-ins
so neither jax nor optax is imported.  Anything else is refused.
"""

from __future__ import annotations

import os
import pickle
import re
from pathlib import Path
from typing import Any, NamedTuple, Optional, Tuple

from ..core.occupancy import OccupancyState

_CKPT_RE = re.compile(r"ckpt_(\d+)\.pkl$")


class ScaleByAdamState(NamedTuple):
    """Stand-in for optax's Adam state (count, mu, nu), as numpy leaves."""

    count: Any
    mu: Any
    nu: Any


_NUMPY_NAMES = {"_reconstruct", "scalar", "ndarray", "dtype"}
_NUMPY_MODULES = {"numpy", "numpy.core.multiarray", "numpy._core.multiarray"}
_MAPPED = {
    ("tinynerf_tpu.core.occupancy", "OccupancyState"): OccupancyState,
    ("tinynerf_tpu_torch.core.occupancy", "OccupancyState"): OccupancyState,
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("tinynerf_tpu_torch.train.checkpoint", "ScaleByAdamState"): ScaleByAdamState,
}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _MAPPED:
            return _MAPPED[(module, name)]
        if module in _NUMPY_MODULES and name in _NUMPY_NAMES:
            return super().find_class(module, name)
        if module.startswith("numpy") and name.endswith("DType"):
            return super().find_class(module, name)  # numpy >= 2 dtype classes
        raise pickle.UnpicklingError(f"checkpoint refers to {module}.{name}, which is not allowed")


def save_checkpoint(folder: Path, step: int, state: Any) -> Path:
    """Atomically write `state` (numpy leaves) as ckpt_{step}.pkl."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    path = folder / f"ckpt_{step}.pkl"
    tmp = folder / f".ckpt_{step}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump({"step": step, "state": state}, f)
    os.replace(tmp, path)
    return path


def latest_checkpoint(folder: Path) -> Optional[Path]:
    folder = Path(folder)
    if not folder.is_dir():
        return None
    best: Tuple[int, Optional[Path]] = (-1, None)
    for p in folder.iterdir():
        m = _CKPT_RE.search(p.name)
        if m and int(m.group(1)) > best[0]:
            best = (int(m.group(1)), p)
    return best[1]


def load_checkpoint(path: Path) -> Tuple[int, Any]:
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    return payload["step"], payload["state"]
