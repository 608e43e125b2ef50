"""Normal-map utilities (counterpart of dnsplatter_tpu/ops/normals.py):
depth-gradient surface normals, per-Gaussian normals, frame changes."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from dnsplatter_torch.ops.camera import backproject_depth
from dnsplatter_torch.ops.quat import quat_rotate


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(eps)


def pcd_to_normal(xyz: torch.Tensor) -> torch.Tensor:
    """Central-difference cross-product normals of an (H, W, 3) point map;
    the one-pixel border is zero."""
    top = xyz[:-2, 1:-1, :]
    bottom = xyz[2:, 1:-1, :]
    left = xyz[1:-1, :-2, :]
    right = xyz[1:-1, 2:, :]
    n = _normalize(torch.linalg.cross(right - left, top - bottom, dim=-1))
    return F.pad(n, (0, 0, 1, 1, 1, 1))


def normal_from_depth_image(depth: torch.Tensor, fx, fy, cx, cy,
                            c2w: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """(H, W, 3) unit normals of a z-depth map (zero border); OpenCV camera
    frame when `c2w` is None."""
    return pcd_to_normal(backproject_depth(depth, fx, fy, cx, cy, c2w=c2w))


def surface_normal_output(depth: torch.Tensor, fx, fy, cx, cy
                          ) -> torch.Tensor:
    """Camera-frame depth normals flipped by diag(1, -1, -1) and mapped to
    [0, 1] (the model's `surface_normal` head)."""
    n = normal_from_depth_image(depth, fx, fy, cx, cy)
    n = n * torch.tensor([1.0, -1.0, -1.0], dtype=n.dtype, device=n.device)
    return (1.0 + n) * 0.5


def per_gaussian_normals(scales_log: torch.Tensor, quats: torch.Tensor,
                         means: torch.Tensor, cam_pos: torch.Tensor
                         ) -> torch.Tensor:
    """World normal of each Gaussian: its flattest axis (argmin of scale,
    ties to the lower index) rotated by its orientation, flipped to face
    the camera."""
    idx = torch.argmin(scales_log, dim=-1)
    onehot = F.one_hot(idx, 3).to(scales_log.dtype)
    normals = _normalize(quat_rotate(quats, onehot))
    viewdirs = _normalize(cam_pos - means.detach())
    dots = torch.sum(normals * viewdirs, dim=-1, keepdim=True)
    return torch.where(dots < 0.0, -normals, normals)


def world_to_camera_normals(normals: torch.Tensor, c2w: torch.Tensor
                            ) -> torch.Tensor:
    """World normals -> OpenGL camera frame: n @ c2w[:3, :3] (R^T n)."""
    r = c2w[:3, :3]
    return torch.stack(
        [normals[..., 0] * r[0, i] + normals[..., 1] * r[1, i]
         + normals[..., 2] * r[2, i] for i in range(3)],
        dim=-1,
    )
