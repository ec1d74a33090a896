"""A PNG writer from the standard library (zlib + struct), so image output
needs no imaging package."""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data +
            struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: Path, img: np.ndarray) -> None:
    """(H, W, 3) RGB or (H, W) grey uint8 -> an 8-bit PNG at ``path``."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"want (H, W) or (H, W, 3) uint8, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    color_type = 2 if img.ndim == 3 else 0
    # filter type 0 (none) before every row
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)
    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n" +
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)) +
        _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) +
        _chunk(b"IEND", b""))
