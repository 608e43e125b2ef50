"""Camera pose optimizer, SO3xR3 (counterpart of
dnsplatter_tpu/models/camera_opt.py; nerfstudio's CameraOptimizer as the
reference uses it).

A per-camera 6-vector tangent [rho(3), phi(3)] maps to an SE(3) adjustment
right-multiplied onto the camera-to-world matrix.
"""

from __future__ import annotations

import dataclasses

import torch

from dnsplatter_torch.ops.camera import Camera


def so3_exp(phi: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Rodrigues exponential map: (..., 3) -> (..., 3, 3).

    R = I + a S + b S^2 with S = skew(phi) un-normalized, a = sin(t) / t and
    b = (1 - cos(t)) / t^2 switched to their Taylor series near zero. The
    square root sees 1 where t^2 is small, so neither the value nor the
    gradient is NaN at phi = 0, where the trainer starts every tangent."""
    x, y, z = phi.unbind(-1)
    zeros = torch.zeros_like(x)
    s_mat = torch.stack([zeros, -z, y, z, zeros, -x, -y, x, zeros],
                        dim=-1).reshape(phi.shape[:-1] + (3, 3))
    t2 = (phi * phi).sum(dim=-1)
    small = t2 < eps
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(t2_safe)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(theta)) / t2_safe)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand_as(s_mat)
    return (eye + a[..., None, None] * s_mat
            + b[..., None, None] * (s_mat @ s_mat))


def exp_map_so3xr3(tangent: torch.Tensor) -> torch.Tensor:
    """(..., 6) [rho, phi] -> (..., 4, 4) adjustment (decoupled
    translation, like nerfstudio's SO3xR3 mode)."""
    rho = tangent[..., :3]
    rot = so3_exp(tangent[..., 3:])
    top = torch.cat([rot, rho[..., :, None]], dim=-1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=tangent.dtype,
                          device=tangent.device).expand(
                              tangent.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def apply_adjustment(camera: Camera, tangent6: torch.Tensor) -> Camera:
    """Right-multiply the exp-map adjustment onto the OpenGL c2w."""
    return dataclasses.replace(camera,
                               c2w=camera.c2w @ exp_map_so3xr3(tangent6))
