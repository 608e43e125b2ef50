"""Image, depth, normal and PLY files (counterpart of
dnsplatter_tpu/data/io.py).

PNGs are encoded here with zlib, so writing renders needs no imaging
package; the pixel values are those of the JAX package's writer:
uint8(clip(img, 0, 1) * 255), greyscale for one channel, RGB for three.
Reading goes through PIL. Depth files follow the reference: 16-bit PNG in
millimetres times a scale factor, or raw .npy in metres. PLY point clouds
and triangle meshes are read in ascii and binary little-endian and written
in binary little-endian, in the JAX package's layout, so either package
reads what the other writes.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, Optional

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
    Path(path).write_bytes(encode_png(img))


def encode_png(img: np.ndarray) -> bytes:
    """The 8-bit PNG file of an (H, W), (H, W, 1) or (H, W, 3) float image
    in [0, 1]."""
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
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


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


# numpy dtypes of the PLY scalar types
_PLY_NP_TYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def read_ply(path: Path) -> Dict[str, np.ndarray]:
    """Vertex (and face) data of an ascii or binary little-endian PLY:
    'points' (N, 3) float32, and where present 'colors' (N, 3) in [0, 1],
    'normals' (N, 3) and 'faces' (F, 3) int32 of a triangle mesh."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        n_vertex = n_face = 0
        props = []  # (name, type) of the vertex element
        face_list_types = None  # (count type, index type)
        current = None
        while True:
            line = f.readline().strip().decode("ascii")
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, current, cnt = line.split()
                if current == "vertex":
                    n_vertex = int(cnt)
                elif current == "face":
                    n_face = int(cnt)
            elif line.startswith("property") and current == "vertex":
                parts = line.split()
                if parts[1] == "list":
                    raise ValueError("list property in vertex element")
                props.append((parts[2], parts[1]))
            elif line.startswith("property list") and current == "face":
                parts = line.split()
                face_list_types = (parts[2], parts[3])
            elif line == "end_header":
                break

        names = [p[0] for p in props]
        faces = None
        if fmt == "ascii":
            rows = np.atleast_2d(np.loadtxt(f, max_rows=n_vertex,
                                            dtype=np.float64))
            data = {n: rows[:, i] for i, n in enumerate(names)}
            if n_face:
                frows = np.atleast_2d(np.loadtxt(f, max_rows=n_face,
                                                 dtype=np.int64))
                faces = frows[:, 1:4].astype(np.int32)
        elif fmt == "binary_little_endian":
            dt = np.dtype([(n, _PLY_NP_TYPES[t]) for n, t in props])
            raw = np.frombuffer(f.read(dt.itemsize * n_vertex), dtype=dt,
                                count=n_vertex)
            data = {n: raw[n].astype(np.float64) for n in names}
            if n_face and face_list_types is not None:
                fdt = np.dtype([("n", _PLY_NP_TYPES[face_list_types[0]]),
                                ("idx", _PLY_NP_TYPES[face_list_types[1]],
                                 (3,))])
                raw_f = f.read(fdt.itemsize * n_face)
                if len(raw_f) >= fdt.itemsize * n_face:
                    rec = np.frombuffer(raw_f, dtype=fdt, count=n_face)
                    if (rec["n"] == 3).all():
                        faces = rec["idx"].astype(np.int32)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

    out = {"points": np.stack([data["x"], data["y"], data["z"]],
                              -1).astype(np.float32)}
    if all(k in data for k in ("red", "green", "blue")):
        cols = np.stack([data["red"], data["green"], data["blue"]], -1)
        if cols.size and cols.max() > 1.0:
            cols = cols / 255.0
        out["colors"] = cols.astype(np.float32)
    if all(k in data for k in ("nx", "ny", "nz")):
        out["normals"] = np.stack([data["nx"], data["ny"], data["nz"]],
                                  -1).astype(np.float32)
    if faces is not None:
        out["faces"] = faces
    return out


def write_ply(path: Path, points: np.ndarray,
              colors: Optional[np.ndarray] = None,
              normals: Optional[np.ndarray] = None,
              faces: Optional[np.ndarray] = None) -> None:
    """A binary little-endian PLY: float xyz, float normals, uchar colours
    (scaled by 255 when they lie in [0, 1]), uchar-counted int faces."""
    n = len(points)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if normals is not None:
        header += ["property float nx", "property float ny",
                   "property float nz"]
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    if faces is not None:
        header += [f"element face {len(faces)}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")

    rec = np.empty(n, dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    if normals is not None:
        rec["nx"], rec["ny"], rec["nz"] = (normals[:, 0], normals[:, 1],
                                           normals[:, 2])
    if colors is not None:
        scale_up = colors.size and colors.max() <= 1.0 + 1e-6
        cols = np.clip(colors * 255.0 if scale_up else colors, 0,
                       255).astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = (cols[:, 0], cols[:, 1],
                                                 cols[:, 2])
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())
        if faces is not None:
            frec = np.empty(len(faces), dtype=np.dtype(
                [("n", "u1"), ("idx", "<i4", (3,))]))
            frec["n"] = 3
            frec["idx"] = faces.astype("<i4")
            f.write(frec.tobytes())
