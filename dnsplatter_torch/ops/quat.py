"""Quaternion utilities, wxyz throughout (counterpart of
dnsplatter_tpu/ops/quat.py)."""

from __future__ import annotations

import math

import numpy as np
import torch

from dnsplatter_torch import resolve_device


def quat_normalize(quat: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize (..., 4) quaternions to unit length."""
    return quat / torch.linalg.norm(quat, dim=-1, keepdim=True).clamp_min(eps)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternions -> (..., 3, 3) rotation matrices
    (normalized internally)."""
    quat = quat_normalize(quat)
    w, x, y, z = quat.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rot = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return rot.reshape(quat.shape[:-1] + (3, 3))


def quat_rotate(quat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors by (..., 4) wxyz quaternions:
    v' = v + w t + qv x t with t = 2 qv x v."""
    q = quat_normalize(quat)
    w = q[..., 0:1]
    qv = q[..., 1:4]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)


def random_quats(rng: np.random.Generator, n: int,
                 device=None) -> torch.Tensor:
    """(n, 4) uniformly distributed unit quaternions (Shoemake's method),
    drawn from a numpy Generator."""
    u, v, w = rng.uniform(size=(3, n)).astype(np.float32)
    u, v, w = (torch.as_tensor(a, device=resolve_device(device))
               for a in (u, v, w))
    a = torch.sqrt(1.0 - u)
    b = torch.sqrt(u)
    return torch.stack(
        [
            a * torch.sin(2.0 * math.pi * v),
            a * torch.cos(2.0 * math.pi * v),
            b * torch.sin(2.0 * math.pi * w),
            b * torch.cos(2.0 * math.pi * w),
        ],
        dim=-1,
    )
