"""An 8-bit greyscale PNG writer with the standard library (zlib +
struct), so that the sample dumps and the training image grids need no
imaging package."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png_gray(path: str, img: np.ndarray) -> None:
    """An 8-bit greyscale PNG from a (H, W) uint8 array (zlib + struct)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))
