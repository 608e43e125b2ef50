"""Scene dataset: per-frame multi-channel loading, served in sequence
(counterpart of dnsplatter_tpu/data/dataset.py).

Frames carry rgb, sensor or mono depth, normals, confidence and a mask.
Channels are loaded lazily, resized to the rgb resolution, undistorted, and
served in order, never shuffled: the reference keeps the t-1, t, t+1 frame
ordering. Batches are numpy arrays (the Trainer uploads and caches them);
cameras are built on `device` (None: the card).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from dnsplatter_torch.data import io
from dnsplatter_torch.data.distortion import undistort_image
from dnsplatter_torch.ops.camera import Camera, euclidean_to_z_depth


@dataclasses.dataclass
class FrameSpec:
    """Everything needed to materialize one training frame."""

    image_path: Path
    c2w: np.ndarray  # (4, 4) OpenGL camera-to-world, after the dataparser
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    sensor_depth_path: Optional[Path] = None
    mono_depth_path: Optional[Path] = None
    normal_path: Optional[Path] = None
    confidence_path: Optional[Path] = None
    mask_path: Optional[Path] = None
    # nerfstudio order [k1, k2, k3, k4, p1, p2]; images are undistorted on
    # load (the rasterizer is pinhole-only)
    distortion: Optional[np.ndarray] = None
    camera_type: str = "perspective"  # or "fisheye"


@dataclasses.dataclass
class SceneDataset:
    """A scene source (`len`, `get(i) -> (Camera, batch)`) over parsed
    frames.

    PNG sensor depths are scaled by depth_unit_scale_factor *
    dataparser_scale; npy depths, metric already, by dataparser_scale only.
    """

    frames: List[FrameSpec]
    depth_unit_scale_factor: float = 1e-3
    dataparser_scale: float = 1.0
    normal_format: str = "omnidata"
    normal_frame: str = "camera"  # or "world": rotate by c2w when loading
    euclidean_depth: bool = False
    seed_points: Optional[np.ndarray] = None
    seed_colors: Optional[np.ndarray] = None
    seed_normals: Optional[np.ndarray] = None
    cache: bool = True
    # optional per-frame protocol labels (MuSHRoom "with" / "within" eval)
    protocols: Optional[List[str]] = None
    device: Optional[object] = None

    def __post_init__(self):
        self._cache: Dict[int, tuple] = {}

    def __len__(self) -> int:
        return len(self.frames)

    def camera(self, i: int) -> Camera:
        f = self.frames[i]
        return Camera.create(f.fx, f.fy, f.cx, f.cy, f.c2w, f.width, f.height,
                             device=self.device)

    def _fit(self, f: FrameSpec, arr: np.ndarray, nearest: bool
             ) -> np.ndarray:
        """`arr` (H', W', C) at the frame's resolution, undistorted."""
        if arr.shape[:2] != (f.height, f.width):
            arr = io.resize_image(arr, f.height, f.width, nearest=nearest)
        if f.distortion is None or not np.any(np.asarray(f.distortion)):
            return arr
        return undistort_image(arr, f.fx, f.fy, f.cx, f.cy,
                               np.asarray(f.distortion), f.camera_type,
                               nearest=nearest)

    def get(self, i: int):
        if self.cache and i in self._cache:
            return self._cache[i]
        f = self.frames[i]
        batch: Dict[str, np.ndarray] = {}
        batch["image"] = self._fit(f, io.read_image(f.image_path), False)
        if f.sensor_depth_path is not None:
            scale = self.dataparser_scale
            if Path(f.sensor_depth_path).suffix != ".npy":
                scale *= self.depth_unit_scale_factor
            d = io.read_depth(f.sensor_depth_path, scale)
            if d.shape[:2] != (f.height, f.width):
                d = io.resize_image(d, f.height, f.width, nearest=True)
            if self.euclidean_depth:
                d = euclidean_to_z_depth(torch.as_tensor(d), f.fx, f.fy,
                                         f.cx, f.cy).numpy()
            batch["sensor_depth"] = self._fit(f, d, True)
        if f.mono_depth_path is not None:
            batch["mono_depth"] = self._fit(
                f, io.read_depth(f.mono_depth_path, self.dataparser_scale),
                True)
        if f.normal_path is not None:
            c2w = f.c2w if self.normal_frame == "world" else None
            batch["normal"] = self._fit(
                f, io.read_normal(f.normal_path, self.normal_format, c2w),
                False)
        if f.confidence_path is not None:
            batch["confidence"] = self._fit(
                f, io.read_depth(f.confidence_path, 1.0), True)
        if f.mask_path is not None:
            m = self._fit(f, io.read_image(f.mask_path)[..., :1], True)
            batch["mask"] = (m > 0.5).astype(np.float32)
        out = (self.camera(i), batch)
        if self.cache:
            self._cache[i] = out
        return out

    def seed(self):
        """(points, colors[, normals]) for the Gaussian init, or None."""
        if self.seed_points is None:
            return None
        colors = (self.seed_colors if self.seed_colors is not None
                  else np.full_like(self.seed_points, 0.5))
        out = (self.seed_points, colors)
        if self.seed_normals is not None:
            out += (self.seed_normals,)
        return out
