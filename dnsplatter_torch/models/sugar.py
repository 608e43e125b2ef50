"""SuGaR-style density and SDF fields over the Gaussian mixture (counterpart
of dnsplatter_tpu/models/sugar.py).

Parity: dn_splatter/dn_model.py:954-1494:
  * volume-weighted point sampling inside Gaussians;
  * the 16 nearest Gaussian centres of each sample (a host KD-tree);
  * density = sum_j opacity_j * exp(-1/2 Mahalanobis^2) over those 16, with
    the >= 1 saturation trick;
  * sdf = sqrt(-2 log density); the ideal SDF from a rendered depth;
  * level-surface points: 21 samples over +-3 sigma along the camera rays
    through the backprojected depth, the first density crossing by linear
    interpolation, normals from the closest Gaussian or analytic
    (-grad density, by `torch.autograd.grad`).

The density runs on the device of the parameters in chunks of samples; the
neighbour search runs on the host with scipy's cKDTree built without
compacted nodes (the same neighbours, and much faster from queries that lie
off the surface).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dnsplatter_torch.mesh.tsdf import to_numpy
from dnsplatter_torch.models.gaussians import GaussianParams
from dnsplatter_torch.ops.quat import quat_to_rotmat

OPACITY_MIN_CLAMP = 1e-4


def inv_sqrt_cov3d(scales_log: torch.Tensor,
                   quats: torch.Tensor) -> torch.Tensor:
    """The square root of the inverse covariance: R diag(1/s)."""
    return quat_to_rotmat(quats) * (1.0 / torch.exp(scales_log))[..., None, :]


def sample_points_in_gaussians(
    generator: Optional[torch.Generator],
    params: GaussianParams,
    alive: torch.Tensor,
    num_samples: int,
    draws: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Volume-weighted multinomial sampling: (points (M, 3), Gaussian ids
    (M,)). The draws come from `generator` (on the parameters' device), or
    are given as `draws` = (ids (M,), standard normals (M, 3))."""
    dev = params.means.device
    scales = torch.exp(params.scales)
    if draws is None:
        vol = (torch.abs(scales[:, 0] * scales[:, 1] * scales[:, 2])
               * (alive > 0.5))
        idx = torch.multinomial(vol, num_samples, replacement=True,
                                generator=generator)
        noise = torch.randn((num_samples, 3), generator=generator,
                            device=dev)
    else:
        idx = torch.as_tensor(np.array(draws[0]), device=dev).long()
        noise = torch.as_tensor(np.array(draws[1], np.float32), device=dev)
    eps = noise * scales[idx]
    rots = quat_to_rotmat(params.quats[idx])
    pts = params.means[idx] + torch.einsum("nij,nj->ni", rots, eps)
    return pts, idx


def closest_gaussians_tree(params: GaussianParams, alive):
    """(cKDTree over the live centres, their ids) for repeated queries."""
    from scipy.spatial import cKDTree

    live_idx = np.where(to_numpy(alive) > 0.5)[0]
    means = to_numpy(params.means)[live_idx]
    return cKDTree(means, compact_nodes=False), live_idx


def get_closest_gaussians(samples, params: GaussianParams, alive,
                          k: int = 16, tree=None) -> np.ndarray:
    """(M, k) ids of the nearest live Gaussians (host cKDTree); `tree` is a
    `closest_gaussians_tree` to reuse."""
    tree, live_idx = tree or closest_gaussians_tree(params, alive)
    _, nn = tree.query(to_numpy(samples), k=k, workers=-1)
    return live_idx[nn]


def _density_chunk(samples, idx, means, inv_sqrt, opac):
    c = means[idx]  # (M, k, 3)
    isr = inv_sqrt[idx]  # (M, k, 3, 3)
    o = opac[idx]  # (M, k)
    shift = samples[:, None, :] - c
    man = torch.einsum("mkji,mkj->mki", isr, shift)  # R^T-side inverse scale
    m2 = torch.clamp(torch.sum(man * man, dim=-1), 0.0, 1e8)
    dens = torch.sum(o * torch.exp(-0.5 * m2), dim=-1)
    # saturation: densities >= 1 normalized to ~1
    return torch.where(dens >= 1.0, dens / (dens.detach() + 1e-5), dens)


def get_density(samples, params: GaussianParams, alive,
                closest: Optional[np.ndarray] = None, chunk: int = 1 << 17,
                clamp: bool = True) -> torch.Tensor:
    """Density at sample points (array or tensor), on the parameters'
    device."""
    dev = params.means.device
    samples = torch.as_tensor(samples, dtype=torch.float32, device=dev)
    if closest is None:
        closest = get_closest_gaussians(samples, params, alive)
    closest = torch.as_tensor(closest, device=dev).long()
    inv_sqrt = inv_sqrt_cov3d(params.scales, params.quats)
    opac = torch.sigmoid(params.opacities) * (alive > 0.5)
    m = samples.shape[0]
    dens = torch.cat([
        _density_chunk(samples[s:s + chunk], closest[s:s + chunk],
                       params.means, inv_sqrt, opac)
        for s in range(0, m, chunk)]) if m else samples.new_zeros(0)
    return torch.clamp(dens, min=OPACITY_MIN_CLAMP) if clamp else dens


def get_sdf(samples, params, alive, closest=None) -> torch.Tensor:
    """sdf = sqrt(-2 log density)."""
    return torch.sqrt(-2.0 * torch.log(get_density(samples, params, alive,
                                                   closest)))


def get_ideal_sdf(samples: torch.Tensor, depth: torch.Tensor, camera,
                  mask=None) -> torch.Tensor:
    """The ideal SDF of samples against a rendered depth map: each sample's
    pixel depth minus its own z."""
    gl_to_cv = torch.diag(torch.tensor([1.0, -1.0, -1.0, 1.0],
                                       device=camera.c2w.device))
    c2w_cv = camera.c2w @ gl_to_cv
    # the w2c rotation is R^T, so p_cam = R^T (p - t) = (p - t) @ R
    pts_cam = (samples - c2w_cv[:3, 3]) @ c2w_cv[:3, :3]
    z = pts_cam[:, 2]
    u = torch.clamp((pts_cam[:, 0] * camera.fx / z + camera.cx).int(), 0,
                    camera.width - 1).long()
    v = torch.clamp((pts_cam[:, 1] * camera.fy / z + camera.cy).int(), 0,
                    camera.height - 1).long()
    return depth[v, u, 0] - z


def compute_level_surface_points(
    params: GaussianParams,
    alive: torch.Tensor,
    camera,
    depth,
    rgb,
    surface_levels: Tuple[float, ...] = (0.1, 0.3, 0.5),
    n_points_in_range: int = 21,
    range_size: float = 3.0,
    knn_k: int = 16,
    return_normal: str = "closest_gaussian",
    subsample: int = 1,
) -> Dict[float, Dict[str, np.ndarray]]:
    """Level-surface intersections for each surface level: {level: {points,
    colors, normals}} of numpy arrays. The backprojection, the neighbour
    search and the crossing search run on the host; the densities on the
    parameters' device."""
    from dnsplatter_torch.ops.camera import backproject_depth

    dev = params.means.device
    depth = to_numpy(depth, np.float32)
    c2w_cv = to_numpy(camera.c2w) @ np.diag([1.0, -1.0, -1.0, 1.0])
    pts = backproject_depth(
        torch.as_tensor(depth[..., 0]), float(camera.fx), float(camera.fy),
        float(camera.cx), float(camera.cy),
        torch.as_tensor(c2w_cv, dtype=torch.float32)).numpy().reshape(-1, 3)
    cols = to_numpy(rgb).reshape(-1, 3)
    keep = depth.reshape(-1) > 0.0
    pts, cols = pts[keep][::subsample], cols[keep][::subsample]
    if len(pts) == 0:
        return {lv: dict(points=np.zeros((0, 3)), colors=np.zeros((0, 3)),
                         normals=np.zeros((0, 3))) for lv in surface_levels}

    closest = get_closest_gaussians(pts, params, alive, k=knn_k)

    # the std of the first-closest gaussian along the view direction
    cam_pos = to_numpy(camera.position())
    means = to_numpy(params.means)
    scales = np.exp(to_numpy(params.scales))
    quats = to_numpy(params.quats)
    first = closest[:, 0]
    viewdirs = cam_pos - means[first]
    viewdirs = viewdirs / np.maximum(
        np.linalg.norm(viewdirs, axis=-1, keepdims=True), 1e-12)
    rots = quat_to_rotmat(torch.as_tensor(quats[first])).numpy()
    local = np.einsum("nij,ni->nj", rots, viewdirs)  # R^T v
    stds = np.linalg.norm(scales[first] * local, axis=-1)

    t_lin = np.linspace(-range_size, range_size, n_points_in_range)
    t_range = t_lin[None, :] * stds[:, None]  # (P, S)
    ray_dir = pts - cam_pos
    ray_dir /= np.maximum(np.linalg.norm(ray_dir, axis=-1, keepdims=True),
                          1e-12)
    samples = pts[:, None, :] + t_range[..., None] * ray_dir[:, None, :]
    closest_rep = np.repeat(closest, n_points_in_range, axis=0)
    dens = get_density(samples.reshape(-1, 3), params, alive, closest_rep,
                       clamp=False).detach().cpu().numpy().reshape(
                           -1, n_points_in_range)

    out: Dict[float, Dict[str, np.ndarray]] = {}
    inv_sqrt = inv_sqrt_cov3d(params.scales, params.quats).detach()
    opac = (torch.sigmoid(params.opacities) * (alive > 0.5)).detach()
    for level in surface_levels:
        above = dens > level
        under0 = dens[:, 0] < level
        first_above = above.argmax(axis=1)
        valid = under0 & (first_above > 0)
        fa = first_above[valid]
        rows = np.where(valid)[0]
        v_hi = dens[rows, fa]
        v_lo = dens[rows, fa - 1]
        t_hi = t_range[rows, fa]
        t_lo = t_range[rows, fa - 1]
        t_int = (level - v_lo) / np.maximum(v_hi - v_lo, 1e-12) * (
            t_hi - t_lo) + t_lo
        p_int = pts[rows] + t_int[:, None] * ray_dir[rows]
        c_int = cols[rows]

        if return_normal == "closest_gaussian":
            nn = closest[rows, 0]
            rr = quat_to_rotmat(torch.as_tensor(quats[nn])).numpy()
            smallest = np.argmin(to_numpy(params.scales)[nn], axis=-1)
            normals = rr[np.arange(len(nn)), :, smallest]
        else:  # analytical: -grad density / |.|
            x = torch.as_tensor(p_int, dtype=torch.float32,
                                device=dev).requires_grad_(True)
            with torch.enable_grad():
                total = torch.sum(_density_chunk(
                    x, torch.as_tensor(closest[rows], device=dev).long(),
                    params.means.detach(), inv_sqrt, opac))
                (g,) = torch.autograd.grad(total, x)
            g = g.cpu().numpy()
            normals = -g / np.maximum(
                np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)
        out[level] = dict(points=p_int.astype(np.float32),
                          colors=c_int.astype(np.float32),
                          normals=normals.astype(np.float32))
    return out
