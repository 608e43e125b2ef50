"""TSDF fusion of RGB-D frames on a dense voxel grid (counterpart of
dnsplatter_tpu/mesh/tsdf.py).

Plays the role of both native TSDF backends the reference calls: vdbfusion's
VDBVolume (`gs-mesh tsdf`) and Open3D's ScalableTSDFVolume (`gs-mesh
o3dtsdf`). A dense grid on `device` (None: the card) is updated frame by
frame: projective TSDF with truncation, a running weighted average,
optional space carving and colour integration. Voxels stream through the
camera in chunks of `TSDFConfig.chunk`, which bounds the temporaries; the
volume's tensors are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from dnsplatter_torch import resolve_device

GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0])


@dataclasses.dataclass(frozen=True)
class TSDFConfig:
    voxel_size: float = 0.01  # Open3DTSDFFusion default
    sdf_trunc: float = 0.03
    space_carving: bool = False
    chunk: int = 1 << 18


class TSDFVolume(NamedTuple):
    origin: torch.Tensor  # (3,)
    dims: Tuple[int, int, int]
    voxel_size: float
    sdf_trunc: float
    tsdf: torch.Tensor  # (Nx*Ny*Nz,) in [-1, 1]
    weight: torch.Tensor
    color: torch.Tensor  # (Nx*Ny*Nz, 3)


def to_numpy(x, dtype=None) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def create_volume(bounds_min, bounds_max, cfg: TSDFConfig,
                  device=None) -> TSDFVolume:
    dev = resolve_device(device)
    bounds_min = to_numpy(bounds_min, np.float32)
    bounds_max = to_numpy(bounds_max, np.float32)
    dims = tuple(int(d) for d in np.ceil(
        (bounds_max - bounds_min) / cfg.voxel_size) + 1)
    n = dims[0] * dims[1] * dims[2]
    return TSDFVolume(
        origin=torch.as_tensor(bounds_min, device=dev), dims=dims,
        voxel_size=cfg.voxel_size, sdf_trunc=cfg.sdf_trunc,
        tsdf=torch.ones(n, device=dev),
        weight=torch.zeros(n, device=dev),
        color=torch.zeros((n, 3), device=dev))


def voxel_centers(vol: TSDFVolume, start: int = 0,
                  stop: int = None) -> torch.Tensor:
    """World centres of the flat voxel ids [start, stop)."""
    nx, ny, nz = vol.dims
    stop = nx * ny * nz if stop is None else stop
    ii = torch.arange(start, stop, device=vol.tsdf.device)
    grid = torch.stack([ii // (ny * nz), (ii // nz) % ny, ii % nz],
                       -1).float()
    return vol.origin + grid * vol.voxel_size


def project(pts: torch.Tensor, w2c: torch.Tensor, fx, fy, cx, cy,
            h: int, w: int):
    """OpenCV projection of world points: (z, nearest-pixel column, row,
    in-image mask); the pixel indices are clamped to the image."""
    pts_cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    z = pts_cam[:, 2]
    zs = torch.clamp(z, min=1e-8)
    u = pts_cam[:, 0] * fx / zs + cx
    v = pts_cam[:, 1] * fy / zs + cy
    ui = torch.clamp(torch.round(u - 0.5), 0, w - 1).long()
    vi = torch.clamp(torch.round(v - 0.5), 0, h - 1).long()
    in_img = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (z > 1e-6)
    return z, ui, vi, in_img


def world_to_camera(c2w_gl) -> Tuple[np.ndarray, np.ndarray]:
    """(OpenCV c2w float64, OpenCV w2c float32) of an OpenGL c2w."""
    c2w_cv = to_numpy(c2w_gl, np.float64) @ GL_TO_CV
    return c2w_cv, np.linalg.inv(c2w_cv).astype(np.float32)


def _integrate_chunk(vol: TSDFVolume, s: int, e: int, depth, rgb, w2c,
                     fx, fy, cx, cy, space_carving: bool) -> None:
    h, w = depth.shape[:2]
    z, ui, vi, in_img = project(voxel_centers(vol, s, e), w2c, fx, fy, cx,
                                cy, h, w)
    d = depth[vi, ui, 0]
    c = rgb[vi, ui]
    sdf = d - z
    trunc = vol.sdf_trunc
    update = in_img & (d > 1e-6) & (sdf >= -trunc)
    if not space_carving:
        # only the truncation band around the surface; with space carving
        # the free space in front of it is driven to +1 as well
        update = update & (sdf <= trunc)
    tsdf_obs = torch.clamp(sdf / trunc, -1.0, 1.0)
    w_new = update.float()
    tsdf, weight, color = vol.tsdf[s:e], vol.weight[s:e], vol.color[s:e]
    w_tot = weight + w_new
    den = torch.clamp(w_tot, min=1e-8)
    tsdf.copy_(torch.where(update, (tsdf * weight + tsdf_obs * w_new) / den,
                           tsdf))
    color.copy_(torch.where(
        update[:, None],
        (color * weight[:, None] + c * w_new[:, None]) / den[:, None],
        color))
    weight.copy_(torch.where(update, w_tot, weight))


@torch.no_grad()
def integrate(vol: TSDFVolume, depth, rgb, c2w_gl, fx: float, fy: float,
              cx: float, cy: float, cfg: TSDFConfig = TSDFConfig()
              ) -> TSDFVolume:
    """Fuse one frame ((H, W, 1) z-depth, (H, W, 3) rgb, OpenGL c2w; arrays
    or tensors) into the volume, in place; returns it."""
    dev = vol.tsdf.device
    _, w2c = world_to_camera(c2w_gl)
    depth_t = torch.as_tensor(depth, dtype=torch.float32, device=dev)
    rgb_t = torch.as_tensor(rgb, dtype=torch.float32, device=dev)
    w2c_t = torch.as_tensor(w2c, device=dev)
    n = vol.tsdf.shape[0]
    for s in range(0, n, cfg.chunk):
        _integrate_chunk(vol, s, min(s + cfg.chunk, n), depth_t, rgb_t,
                         w2c_t, float(fx), float(fy), float(cx), float(cy),
                         cfg.space_carving)
    return vol


def extract_mesh(vol: TSDFVolume, min_weight: float = 1.0):
    """Marching-tetrahedra isosurface of the fused TSDF at level 0, on the
    host.

    Only fully observed cubes are meshed (Open3D ScalableTSDFVolume
    semantics): unobserved voxels read +1, which would otherwise close a
    phantom shell at the back of every truncation band.

    Returns (vertices (V, 3), faces (F, 3), colors (V, 3) or None)."""
    from dnsplatter_torch.mesh.marching import (
        filter_faces_to_observed, marching_tetrahedra)

    nx, ny, nz = vol.dims
    field = to_numpy(vol.tsdf).reshape(nx, ny, nz)
    observed = to_numpy(vol.weight).reshape(nx, ny, nz) >= min_weight
    field = np.where(observed, field, 1.0)
    verts, faces = marching_tetrahedra(field, level=0.0)
    verts, faces, _ = filter_faces_to_observed(verts, faces, observed)
    cols = None
    if len(verts):
        cvol = to_numpy(vol.color).reshape(nx, ny, nz, 3)
        vi = np.clip(np.round(verts).astype(int), 0,
                     [nx - 1, ny - 1, nz - 1])
        cols = cvol[vi[:, 0], vi[:, 1], vi[:, 2]]
        verts = to_numpy(vol.origin) + verts * vol.voxel_size
    return verts, faces, cols


def scene_bounds_from_cameras(cameras, depth_max: float = 5.0,
                              margin: float = 0.5):
    """A conservative AABB: camera positions plus the depth reach."""
    pos = np.stack([to_numpy(c.position()) for c in cameras])
    return pos.min(0) - depth_max - margin, pos.max(0) + depth_max + margin
