"""Operation and byte counts of the roofline and utilization metrics: the
card's peaks (`peaks.json`), each configuration's matrix products
(`<config>.json`) and each hand-written kernel's bytes (`<kernel>.py`).
The byte model is the one of `chip_smoke.py` phase 2: each input read once
and each output written once."""

from __future__ import annotations

import json
from pathlib import Path

from ..reference.nerf import module_at

HERE = Path(__file__).resolve().parent


def peaks() -> dict:
    return json.loads((HERE / "peaks.json").read_text())


def flops(config_name: str) -> dict:
    return json.loads((HERE / f"{config_name}.json").read_text())


def forward_flops(counts: dict, direction_per_sample: bool) -> tuple:
    """(operations per sample, per ray) of one forward."""
    sample = sum(2 * a * b for a, b in counts["sample_matmuls"])
    direction = sum(2 * a * b for a, b in counts["direction_matmuls"])
    return (sample + direction, 0) if direction_per_sample else (sample, direction)


def kernel(name: str):
    """The byte model of kernel `name` (`counts/<name>.py`)."""
    return module_at(HERE / f"{name}.py")


def roofline(r, name: str):
    """Kernel `name`'s share (%) of its bytes bound over the traced window:
    the bound of every call (a kernel with `launches_per_call` is called
    that many times per field call with fixed shapes; any other once per
    training step, from the step's kept samples) over its device seconds.
    None where the trace holds no launch of it."""
    if r.trace is None:
        return None
    model = kernel(name)
    seconds, launches = r.trace.device_seconds(model.MATCH)
    if seconds <= 0.0 or launches == 0:
        return None
    if hasattr(model, "launches_per_call"):
        total = launches / model.launches_per_call(r.config) * model.bytes_per_call(r.config)
    else:
        total = sum(model.bytes_per_call(r.config, n) for n in r.counters.get("samples", ()))
    return 100.0 * total / peaks()["hbm_bytes_per_s"] / seconds
