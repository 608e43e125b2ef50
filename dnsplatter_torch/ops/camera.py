"""Pinhole camera and projection utilities (counterpart of
dnsplatter_tpu/ops/camera.py).

Conventions are the JAX package's: `c2w` is OpenGL/nerfstudio (+X right,
+Y up, -Z forward); rendering happens in OpenCV (+Y down, +Z forward);
pixel centers sit at integer + 0.5; depth maps are z-depth.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dnsplatter_torch import resolve_device

# Right-multiply a c2w by this to flip OpenGL <-> OpenCV camera axes.
GL_TO_CV = np.diag(np.array([1.0, -1.0, -1.0, 1.0], np.float32))


@dataclasses.dataclass(frozen=True)
class Camera:
    """A single pinhole camera: 0-d tensors fx, fy, cx, cy; (4, 4) OpenGL
    camera-to-world `c2w`; image size in pixels."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    c2w: torch.Tensor
    width: int
    height: int

    @staticmethod
    def create(fx, fy, cx, cy, c2w, width: int, height: int,
               device=None) -> "Camera":
        """`device=None` keeps a tensor `c2w` where it lies and puts
        anything else on the card."""
        if device is None and isinstance(c2w, torch.Tensor):
            device = c2w.device
        dev = resolve_device(device)
        c2w = torch.as_tensor(np.array(c2w, np.float32)
                              if not isinstance(c2w, torch.Tensor) else c2w,
                              dtype=torch.float32, device=dev)
        if c2w.shape == (3, 4):
            bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=dev)
            c2w = torch.cat([c2w, bottom], dim=0)

        def scalar(v):
            return torch.as_tensor(v, dtype=torch.float32, device=dev)

        return Camera(fx=scalar(fx), fy=scalar(fy), cx=scalar(cx),
                      cy=scalar(cy), c2w=c2w, width=int(width),
                      height=int(height))

    @property
    def device(self) -> torch.device:
        return self.c2w.device

    @property
    def K(self) -> torch.Tensor:
        """(3, 3) intrinsics matrix."""
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([
            torch.stack([self.fx, z, self.cx]),
            torch.stack([z, self.fy, self.cy]),
            torch.stack([z, z, o]),
        ])

    def viewmat(self) -> torch.Tensor:
        """(4, 4) OpenCV world-to-camera matrix (flip y/z of the OpenGL
        c2w, then invert the rigid transform analytically)."""
        c2w_cv = self.c2w @ torch.as_tensor(GL_TO_CV, device=self.device)
        rot = c2w_cv[:3, :3]
        t = c2w_cv[:3, 3]
        rot_inv = rot.T
        t_inv = -rot_inv @ t
        top = torch.cat([rot_inv, t_inv[:, None]], dim=1)
        bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=top.dtype,
                              device=self.device)
        return torch.cat([top, bottom], dim=0)

    def position(self) -> torch.Tensor:
        """(3,) camera origin in world coordinates."""
        return self.c2w[:3, 3]


def pixel_coords(width: int, height: int, pixel_offset: float = 0.5,
                 device=None) -> torch.Tensor:
    """(H, W, 2) pixel-center coordinates stored as (x, y)."""
    dev = resolve_device(device)
    xs = torch.arange(width, dtype=torch.float32, device=dev) + pixel_offset
    ys = torch.arange(height, dtype=torch.float32, device=dev) + pixel_offset
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xg, yg], dim=-1)


def backproject_depth(depth: torch.Tensor, fx, fy, cx, cy,
                      c2w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(H, W[, 1]) z-depth -> (H, W, 3) points; camera frame when `c2w`
    (OpenCV convention) is None."""
    if depth.ndim == 3:
        depth = depth[..., 0]
    h, w = depth.shape
    coords = pixel_coords(w, h, device=depth.device)
    x = (coords[..., 0] - cx) * depth / fx
    y = (coords[..., 1] - cy) * depth / fy
    pts = torch.stack([x, y, depth], dim=-1)
    if c2w is not None:
        pts = pts @ c2w[:3, :3].T + c2w[:3, 3]
    return pts


def look_at(eye, target, up=(0.0, 1.0, 0.0), device=None) -> torch.Tensor:
    """OpenGL-convention (4, 4) c2w looking from `eye` at `target`."""
    dev = resolve_device(device)
    eye = torch.as_tensor(np.asarray(eye, np.float32), device=dev)
    target = torch.as_tensor(np.asarray(target, np.float32), device=dev)
    up = torch.as_tensor(np.asarray(up, np.float32), device=dev)
    fwd = target - eye
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.norm(right)
    true_up = torch.linalg.cross(right, fwd)
    rot = torch.stack([right, true_up, -fwd], dim=-1)
    c2w = torch.cat([rot, eye[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=dev)
    return torch.cat([c2w, bottom], dim=0)
