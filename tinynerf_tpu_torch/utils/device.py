"""The device a tool runs on: CUDA unless the caller asks for the CPU, and
never the CPU in place of a card that is missing; and the forward's
constants, made on a device once."""

from __future__ import annotations

import functools
import subprocess

import torch


def resolve_device(name: str, tool: str) -> torch.device:
    """`name` ("cuda", "cuda:N" or "cpu") as a device; raise SystemExit for
    a CUDA device when there is no card (no fallback to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{tool}: torch.cuda.is_available() is false; this needs a GPU "
                         "(--device cpu runs the kernels' plain versions)")
    return device


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@functools.lru_cache(maxsize=None)
def device_constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype, device=device)`, made once per
    (values, dtype, device) and kept: a constant the forward would otherwise
    copy to the card at every call (a pageable copy and a stream sync, which
    a CUDA graph cannot hold).  `values` is a tuple of numbers, or of such
    tuples.  Made outside inference mode, so autograd may save it; callers
    only read it."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)
