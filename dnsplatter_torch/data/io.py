"""Image output (the `write_image` of dnsplatter_tpu/data/io.py).

PNGs are encoded here with zlib, so writing renders needs no imaging
package; the pixel values are those of the JAX package's writer:
uint8(clip(img, 0, 1) * 255), greyscale for one channel, RGB for three.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_image(path: Path, img: np.ndarray) -> None:
    """(H, W), (H, W, 1) or (H, W, 3) float image in [0, 1] -> 8-bit PNG."""
    arr = np.clip(np.asarray(img), 0.0, 1.0)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    px = (arr * 255).astype(np.uint8)
    if px.ndim == 2:
        colour = 0
    elif px.ndim == 3 and px.shape[-1] == 3:
        colour = 2
    else:
        raise ValueError(f"write_image takes 1 or 3 channels, got {px.shape}")
    h, w = px.shape[:2]
    rows = px.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
           + _chunk(b"IEND", b""))
    Path(path).write_bytes(png)
