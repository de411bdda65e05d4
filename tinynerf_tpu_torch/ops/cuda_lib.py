"""Build, load and call the port's hand-written CUDA kernels (`csrc/*.cu`).

`nvcc` compiles every source in `csrc/` into one shared library with a
plain C interface, for `sm_90a` (H100), at first use.  The library is cached
under `<checkout>/build/tinynerf_tpu_torch/`, keyed by a hash of the sources
and the flags, and bound with ctypes: each C entry point takes pointers,
sizes and the stream, launches on PyTorch's current stream, allocates
nothing and returns `cudaGetLastError()`.  Nothing here runs at import time,
so the CPU-only tests import every module without a toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tinynerf_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers / shared memory / spills per kernel, into the log
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "tn_segmented_cumsum": (_P, _P, _I, _P, _P),
    "tn_weights_packed": (_P, _P, _P, _P, _I, _F, _P, _P),
    "tn_weights_dense": (_P, _P, _P, _I, _I, _F, _P, _P),
}


@dataclass
class Library:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when the cached library was reused
    log: str  # nvcc's output (ptxas resource usage) or "" when cached

    def call(self, name: str, *args) -> None:
        """Call C entry point `name`; raise if it reports a CUDA error."""
        rc = getattr(self.lib, name)(*args)
        if rc != 0:
            msg = self.lib.tn_error_string(rc).decode()
            raise RuntimeError(f"{name} failed with CUDA error {rc}: {msg}")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset, no nvcc on PATH)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _build(out: Path) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(p) for p in sorted(CSRC.glob("*.cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return proc.stdout + proc.stderr


@functools.cache
def library() -> Library:
    """The compiled kernel library, built on first call (cached on disk)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libtn_kernels_{h.hexdigest()[:16]}.so"
    built = not out.exists()
    t0 = time.perf_counter()
    log = _build(out) if built else ""
    seconds = time.perf_counter() - t0 if built else 0.0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.tn_error_string.argtypes = [ctypes.c_int]
    lib.tn_error_string.restype = ctypes.c_char_p
    return Library(lib, out, seconds, log)


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on `t`'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def runs_plain(name: str, *tensors: torch.Tensor) -> bool:
    """The wrappers' dispatch: True when every input lies on the CPU (run
    the plain version), False when every input is a CUDA tensor (launch the
    kernel); anything else raises.  Nothing falls back from one to the other."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"{name}: inputs must all be CPU or all CUDA tensors, got {sorted(kinds)}")


def check_cuda_inputs(name: str, dtype: torch.dtype, shape, *tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of `dtype` and
    `shape` on one device (what the C entry points assume)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all inputs must be on one CUDA device, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
