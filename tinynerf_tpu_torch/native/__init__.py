"""The native PNG loader (`loader.cpp`, libpng and a C++ thread pool), bound
with ctypes.

The port's own copy of `tinynerf_tpu/native`: the same C++ source and
interface.  The shared library is built with g++ at first use into
`<checkout>/build/tinynerf_tpu_torch/`, named by a hash of the source, never
next to the source.  If the toolchain or libpng is missing, `load_images`
returns None and the parser falls back to Pillow.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tinynerf_tpu_torch"


def _build(out: Path) -> bool:
    # compile to a private temp file and rename into place, so concurrent
    # builds (parallel test workers) never load a partial file
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", str(SRC), "-lpng", "-lz", "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


@functools.cache
def get_lib() -> Optional[ctypes.CDLL]:
    """The loader library, built on first call; None if it cannot be built."""
    out = BUILD_DIR / f"libtn_loader_{hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]}.so"
    if not out.exists() and not _build(out):
        return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError:
        return None
    lib.tn_png_dims.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.tn_png_dims.restype = ctypes.c_int
    lib.tn_load_pngs.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.tn_load_pngs.restype = ctypes.c_int
    return lib


def png_size(path: Path) -> Optional[Tuple[int, int]]:
    """(w, h) of a PNG from its header; None if the loader is unavailable
    or the file is not a PNG it reads."""
    lib = get_lib()
    if lib is None or not str(path).lower().endswith(".png"):
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.tn_png_dims(str(path).encode(), ctypes.byref(w), ctypes.byref(h)):
        return None
    return w.value, h.value


def load_images(
    paths: List[Path], bg_color: Tuple[float, float, float], n_threads: int = 8
) -> Optional[np.ndarray]:
    """Decode same-sized PNGs into [n, h, w, 3] float32 in [0, 1], RGBA
    composited over bg_color (values in [0, 1]) with Pillow's integer
    arithmetic.  None if the loader is unavailable or a file fails."""
    lib = get_lib()
    if lib is None or not paths:
        return None
    if not all(str(p).lower().endswith(".png") for p in paths):
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.tn_png_dims(str(paths[0]).encode(), ctypes.byref(w), ctypes.byref(h)):
        return None
    n = len(paths)
    out = np.empty((n, h.value, w.value, 3), dtype=np.float32)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = lib.tn_load_pngs(
        c_paths, n, w.value, h.value,
        float(bg_color[0]), float(bg_color[1]), float(bg_color[2]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads,
    )
    return None if rc else out
