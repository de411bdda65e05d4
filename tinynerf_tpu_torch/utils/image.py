"""PNG output with the standard library only (zlib + struct), so rendering
saves images on machines without Pillow."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_COLOR_TYPE = {3: 2, 4: 6}  # RGB, RGBA


def write_png(arr: np.ndarray, path: Path) -> None:
    """arr: [h, w, 3 or 4] uint8 -> 8-bit RGB(A) PNG, no filtering."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w, c = arr.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0 per scanline
    rows[:, 1:] = arr.reshape(h, w * c)

    def chunk(tag: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)

    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", header))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def save_png(img: np.ndarray, path: Path) -> None:
    """img: [h, w, 3] float in [0, 1] -> 8-bit PNG."""
    write_png(np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8), path)
