"""Build, load and call the port's hand-written CUDA kernels (`csrc/*.cu`).

`nvcc` compiles every source in `csrc/` (one process per source, all
started together) and links the objects into one shared library with a
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers / shared memory / spills per kernel, into the log
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "tn_segmented_cumsum": (_P, _P, _I, _I, _P, _P),
    "tn_weights_packed": (_P, _P, _P, _P, _I, _I, _F, _P, _P),
    "tn_weights_dense": (_P, _P, _P, _I, _I, _F, _P, _P),
    "tn_weights_packed_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _P, _P),
    "tn_segment_sum": (_P, _P, _I, _I, _P, _P),
    "tn_weights_dense_bwd": (_P, _P, _P, _P, _P, _I, _I, _P, _P),
    "tn_sort_i32": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "tn_sort_pairs_i32": (_P,) * 7 + (_I,) * 4 + (_P,),
    "tn_windowed_accumulate": (_P, _P, _P) + (_I,) * 16 + (_P, _I, _P, ctypes.c_longlong, _P, _P),
    "tn_oct_accumulate": (_P,) * 6 + (_I,) * 6 + (_P, _I, _P, ctypes.c_longlong, _P, _P),
    "tn_oct_fold": (_P, _I, _I, _I, _I, _P, _P),
    "tn_build_oct": (_P, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    "tn_build_quad": (_P,) + (_I,) * 8 + (_P, _P),
    "tn_skip_march": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                      _F, _F, _F, _F, _F, _F, _F, _F, _F, _P, _P, _P),
    "tn_skip_march_unbounded": (_P, _P, _P, _P, _I, _I, _I, _I) + (_F,) * 7 + (_P, _P, _P),
    "tn_hash_encode": (_P, _P, _P, _I, _P, _P),
    "tn_hash_terms": (_P, _P, _P, _I, _I, _P, _P, _P, _P),
    "tn_hash_group": (_P, _I, _I, _P, ctypes.c_longlong, _P, _P, _P, _P, _P),
    "tn_hash_accumulate": (_P, _P, _P, ctypes.c_longlong, _I, _P, _P, _P, _P, _P),
    "tn_skip_grid": (_P, _I, _I, _I, _P, _P),
    # these three return a value, not an error code
    "tn_skip_lanes": (_I,),  # the lanes per ray both marches take
    "tn_skip_grid_smem": (_I, _I, _I),  # a tn_skip_grid block's shared memory
    "tn_smem_optin": (),  # the shared memory a block may take on the current device
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


def _run_all(cmds: list) -> str:
    """Run the commands concurrently; raise with the log of any that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]  # waits for every process
    failed = [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs) if p.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(
            f"nvcc failed ({rc}):\n{' '.join(c)}\n{o}" for c, rc, o in failed
        ))
    return "".join(outs)


def _build(out: Path) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    objs = [out.with_name(f"{src.stem}.{tag}.o") for src in sorted(CSRC.glob("*.cu"))]
    tmp = out.with_suffix(f".{tag}.so")
    try:
        log = _run_all([
            [_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            for src, obj in zip(sorted(CSRC.glob("*.cu")), objs)
        ])
        log += _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)]])
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return log


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


# PyTorch's own accessor of the raw handle, where this build has it: a
# fraction of a microsecond against several for building a Stream object
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on `t`'s device."""
    if _raw_stream is not None:
        return _raw_stream(t.device.index)
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
    for t in tensors:  # one test on the way every call takes; the reasons apart, below
        if t.dtype is dtype and t.shape == shape and t.is_cuda and t.device == dev and t.is_contiguous():
            continue
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all inputs must be on one CUDA device, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def launch_counters() -> dict:
    """Every kernel wrapper's launch count, by name: (wrapper, attribute).
    Each wrapper adds one where it launches its kernel and nowhere else;
    the quad build counts its float8 launches apart as well."""
    from ..core import skipmarch
    from . import bitonic, hashgrid, octbuild, segscan, table_grad, weights_dense

    return {
        "segscan": (segscan.compute_weights_packed, "launches"),
        "weights_dense": (weights_dense.compute_weights_dense, "launches"),
        "segscan_bwd": (segscan.weights_packed_bwd, "launches"),
        "segment_sum": (segscan.segment_sum, "launches"),
        "weights_dense_bwd": (weights_dense.weights_dense_bwd, "launches"),
        "sort": (bitonic.sort_i32, "launches"),
        "sort_pairs": (bitonic.sort_pairs_i32, "launches"),
        "accumulate": (table_grad.windowed_accumulate, "launches"),
        "oct_accumulate": (table_grad.oct_accumulate, "launches"),
        "oct_build": (octbuild.build_oct, "launches"),
        "oct_fold": (octbuild.oct_fold, "launches"),
        "quad_build": (octbuild.build_quad, "launches"),
        "quad_build_fp8": (octbuild.build_quad, "fp8_launches"),
        "hash_encode": (hashgrid.hash_encode, "launches"),
        "hash_terms": (hashgrid.hash_terms, "launches"),
        "hash_group": (hashgrid.hash_group, "launches"),
        "hash_accumulate": (hashgrid.hash_accumulate, "launches"),
        "skip_march": (skipmarch.skip_march, "launches"),
        "skip_march_unbounded": (skipmarch.skip_march_unbounded, "launches"),
        "skip_grid": (skipmarch.make_skip_grid, "launches"),
    }


def launch_counts() -> dict:
    """The launch count of every kernel, by name (`launch_counters`)."""
    return {name: getattr(fn, attr) for name, (fn, attr) in launch_counters().items()}


def zero_launch_counts() -> None:
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)


def launches_since(before: dict) -> dict:
    """The launches of each kernel since `before = launch_counts()`."""
    return {name: n - before[name] for name, n in launch_counts().items()}
