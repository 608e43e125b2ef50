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


def rotmat_to_quat(mat: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """(..., 3, 3) rotation matrices -> (..., 4) wxyz quaternions with
    w >= 0: of the four candidates (one per largest pivot) the numerically
    safest is taken."""
    m00, m01, m02 = mat[..., 0, 0], mat[..., 0, 1], mat[..., 0, 2]
    m10, m11, m12 = mat[..., 1, 0], mat[..., 1, 1], mat[..., 1, 2]
    m20, m21, m22 = mat[..., 2, 0], mat[..., 2, 1], mat[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                      m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1.0 - m00 - m11 + m22], -1)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(eps)
    return q * torch.where(q[..., :1] < 0.0, -1.0, 1.0)


def rotate_vector_to_vector(v1: torch.Tensor, v2: torch.Tensor,
                            eps: float = 1e-8) -> torch.Tensor:
    """Minimal rotation matrices (N, 3, 3) carrying each v1 onto v2
    (Rodrigues); antiparallel pairs turn by pi about an axis orthogonal to
    v1."""
    a = v1 / torch.linalg.norm(v1, dim=-1, keepdim=True).clamp_min(eps)
    b = v2 / torch.linalg.norm(v2, dim=-1, keepdim=True).clamp_min(eps)
    v = torch.linalg.cross(a, b, dim=-1)
    c = torch.sum(a * b, dim=-1)
    s = torch.linalg.norm(v, dim=-1)
    zeros = torch.zeros_like(c)
    kmat = torch.stack(
        [zeros, -v[..., 2], v[..., 1],
         v[..., 2], zeros, -v[..., 0],
         -v[..., 1], v[..., 0], zeros], dim=-1,
    ).reshape(v.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=v1.dtype, device=v1.device).expand_as(kmat)
    factor = (1.0 - c) / (s * s).clamp_min(eps)
    rot = eye + kmat + (kmat @ kmat) * factor[..., None, None]
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=v1.dtype, device=v1.device)
    y_axis = torch.tensor([0.0, 1.0, 0.0], dtype=v1.dtype, device=v1.device)
    ortho = torch.where(a[..., :1].abs() < 0.9, x_axis, y_axis)
    axis = torch.linalg.cross(a, ortho, dim=-1)
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True).clamp_min(eps)
    flip = 2.0 * axis[..., :, None] * axis[..., None, :] - eye
    antiparallel = c < (-1.0 + 1e-6)
    return torch.where(antiparallel[..., None, None], flip, rot)
