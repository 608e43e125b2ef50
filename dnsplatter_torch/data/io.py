"""Image, depth and normal files (the image side of
dnsplatter_tpu/data/io.py; PLY point clouds are not ported yet).

PNGs are encoded here with zlib, so writing renders needs no imaging
package; the pixel values are those of the JAX package's writer:
uint8(clip(img, 0, 1) * 255), greyscale for one channel, RGB for three.
Reading goes through PIL. Depth files follow the reference: 16-bit PNG in
millimetres times a scale factor, or raw .npy in metres.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def read_image(path: Path) -> np.ndarray:
    """(H, W, 3) float32 RGB in [0, 1]."""
    from PIL import Image

    img = Image.open(path)
    if img.mode not in ("RGB", "RGBA"):
        img = img.convert("RGB")
    return (np.asarray(img, np.float32) / 255.0)[..., :3]


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


def resize_image(img: np.ndarray, height: int, width: int,
                 nearest: bool = False) -> np.ndarray:
    """Resize an (H, W[, C]) float array (PIL bilinear or nearest), channel
    by channel in float32."""
    from PIL import Image

    if img.shape[0] == height and img.shape[1] == width:
        return img
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    chans = []
    for c in range(img.shape[-1]):
        p = Image.fromarray(img[..., c].astype(np.float32), mode="F")
        p = p.resize((width, height),
                     Image.NEAREST if nearest else Image.BILINEAR)
        chans.append(np.asarray(p, np.float32))
    out = np.stack(chans, axis=-1)
    return out[..., 0] if squeeze else out


def read_depth(path: Path, scale_factor: float = 1.0) -> np.ndarray:
    """(H, W, 1) float32 depth in scene units: the file's values (16-bit
    PNG or .npy) times `scale_factor`."""
    path = Path(path)
    if path.suffix == ".npy":
        d = np.load(path).astype(np.float32) * scale_factor
    else:
        from PIL import Image

        d = np.asarray(Image.open(path)).astype(np.float32) * scale_factor
    if d.ndim == 2:
        d = d[..., None]
    return d[..., :1]


def write_depth_png(path: Path, depth: np.ndarray, unit: float = 1e-3
                    ) -> None:
    """16-bit PNG depth (millimetres by default), clipped to the format's
    range before the cast: a larger value would wrap to a small depth."""
    from PIL import Image

    d = np.clip(np.asarray(depth).squeeze() / unit, 0, 65535)
    Image.fromarray(d.astype(np.uint16)).save(path)


def read_normal(path: Path, format: str = "omnidata",
                c2w: Optional[np.ndarray] = None) -> np.ndarray:
    """(H, W, 3) normals in the [0, 1] image encoding, from a png or an
    npy ((H, W, 3) or (3, H, W)). 'omnidata' flips the OpenGL components to
    OpenCV, (1, -1, -1) in [-1, 1] space; with `c2w` (OpenGL) the vectors
    are rotated from the camera frame into the world."""
    path = Path(path)
    if path.suffix == ".npy":
        n = np.load(path).astype(np.float32)
        if n.ndim == 3 and n.shape[0] == 3:
            n = np.transpose(n, (1, 2, 0))
    else:
        from PIL import Image

        n = np.asarray(Image.open(path)).astype(np.float32) / 255.0
    vec = 2.0 * n[..., :3] - 1.0
    rot = None if c2w is None else np.asarray(c2w)[:3, :3]
    if format == "omnidata":
        vec = vec * np.array([1.0, -1.0, -1.0], np.float32)
        if rot is not None:
            # the flip put vec into the OpenCV camera frame; c2w is OpenGL
            rot = rot @ np.diag([1.0, -1.0, -1.0])
    if rot is not None:
        vec = vec @ rot.T
    return (vec + 1.0) * 0.5
