"""EWA projection of 3D Gaussians to screen space (counterpart of
dnsplatter_tpu/ops/projection.py; gsplat's fused-projection semantics).

The camera covariance is expanded component by component exactly as the
JAX package does, so both round alike; batched 3x3 products would be fine
on the card, but the elementwise form keeps the two implementations
comparable at f32 tolerance.
"""

from __future__ import annotations

import dataclasses

import torch

from dnsplatter_torch.ops.quat import quat_normalize


@dataclasses.dataclass(frozen=True)
class Projected:
    """Screen-space Gaussians: means2d (N, 2), depths (N,) camera z,
    conics (N, 3) with sigma = 0.5(a dx^2 + c dy^2) + b dx dy, radii (N,)
    (0 = culled), radii_xy (N, 2) tight per-axis extents, compensations
    (N,) antialiasing opacity scale, valid (N,) bool."""

    means2d: torch.Tensor
    depths: torch.Tensor
    conics: torch.Tensor
    radii: torch.Tensor
    radii_xy: torch.Tensor
    compensations: torch.Tensor
    valid: torch.Tensor


def _camera_cov_components(quats, scales, rot_wc):
    """The 6 unique entries of W (R S)(R S)^T W^T as (N,) tensors."""
    q = quat_normalize(quats)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = (
        (1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)),
        (2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)),
        (2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)),
    )
    s = scales.unbind(-1)
    ww = [[rot_wc[i, k] for k in range(3)] for i in range(3)]
    b = [[(ww[i][0] * r[0][j] + ww[i][1] * r[1][j] + ww[i][2] * r[2][j])
          * s[j] for j in range(3)] for i in range(3)]

    def dot(i, l):
        return b[i][0] * b[l][0] + b[i][1] * b[l][1] + b[i][2] * b[l][2]

    return dot(0, 0), dot(0, 1), dot(0, 2), dot(1, 1), dot(1, 2), dot(2, 2)


def project_gaussians(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    viewmat: torch.Tensor,
    fx,
    fy,
    cx,
    cy,
    width: int,
    height: int,
    eps2d: float = 0.3,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    opacities: torch.Tensor | None = None,
) -> Projected:
    """Project N world Gaussians (linear scales) into one OpenCV camera.

    With post-sigmoid `opacities`, the screen radius shrinks losslessly
    from 3 sigma to the exact support of alpha >= 1/255 (see the JAX
    docstring): renders are identical, dim Gaussians touch fewer tiles.
    """
    rot_wc = viewmat[:3, :3]
    t_wc = viewmat[:3, 3]
    mean_c = means @ rot_wc.T + t_wc
    tz = mean_c[..., 2]

    c00, c01, c02, c11, c12, c22 = _camera_cov_components(
        quats, scales, rot_wc)

    tz_safe = torch.where(tz.abs() < 1e-8, torch.full_like(tz, 1e-8), tz)
    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    txz = torch.clamp(mean_c[..., 0] / tz_safe, -lim_x, lim_x) * tz_safe
    tyz = torch.clamp(mean_c[..., 1] / tz_safe, -lim_y, lim_y) * tz_safe

    rz = 1.0 / tz_safe
    rz2 = rz * rz
    j00 = fx * rz
    j02 = -fx * txz * rz2
    j11 = fy * rz
    j12 = -fy * tyz * rz2

    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22)
    b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22)

    det_orig = a * c - b * b
    a_b = a + eps2d
    c_b = c + eps2d
    det = a_b * c_b - b * b
    det_safe = torch.where(det <= 0.0, torch.full_like(det, 1e-12), det)
    compensations = torch.sqrt(torch.clamp_min(det_orig / det_safe, 0.0))

    conic = torch.stack([c_b / det_safe, -b / det_safe, a_b / det_safe],
                        dim=-1)

    # The screen extents only select tiles: they stay out of the graph
    # (their ceil has no gradient, and sqrt at 0 would make one up).
    with torch.no_grad():
        mid = 0.5 * (a_b + c_b)
        disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.01))
        vmax = mid + disc
        if opacities is not None:
            sigma_bound = torch.clamp_max(
                torch.log(torch.clamp_min(255.0 * opacities, 1e-12)), 4.5)
        else:
            sigma_bound = torch.full_like(vmax, 4.5)
        sb = torch.clamp_min(sigma_bound, 0.0)
        radius = torch.ceil(torch.sqrt(2.0 * sb * torch.clamp_min(vmax, 0.0)))
        rx = torch.ceil(torch.sqrt(2.0 * sb * torch.clamp_min(a_b, 0.0)))
        ry = torch.ceil(torch.sqrt(2.0 * sb * torch.clamp_min(c_b, 0.0)))

    mean2d = torch.stack([fx * mean_c[..., 0] * rz + cx,
                          fy * mean_c[..., 1] * rz + cy], dim=-1)

    inside_depth = (tz > near_plane) & (tz < far_plane)
    pos_det = det > 0.0
    on_image = ((mean2d[..., 0] + rx > 0) & (mean2d[..., 0] - rx < width)
                & (mean2d[..., 1] + ry > 0) & (mean2d[..., 1] - ry < height))
    valid = inside_depth & pos_det & (radius > radius_clip) & on_image
    zero = torch.zeros_like(radius)
    radii = torch.where(valid, radius, zero)
    radii_xy = torch.where(valid[:, None], torch.stack([rx, ry], -1), 0.0)

    return Projected(means2d=mean2d, depths=tz, conics=conic, radii=radii,
                     radii_xy=radii_xy, compensations=compensations,
                     valid=valid)
