"""Poisson surface reconstruction from oriented point clouds (counterpart of
dnsplatter_tpu/mesh/poisson.py).

Fills the screened-Poisson role Open3D plays in the reference's `gs-mesh
dn` / `gs-mesh gaussians` / `sugar-coarse` exporters: solve for an
indicator function chi whose gradient matches the smoothed oriented-normal
field, then extract its level set.

Dense-grid formulation (Kazhdan's equations on a regular grid instead of an
adaptive octree): splat normals into a vector field V on `device` (None:
the card), form div V and solve lap(chi) = div V, either spectrally (the
FFT diagonalizes the periodic Laplacian, `torch.fft`) or by conjugate
gradients on the Dirichlet Laplacian. The iso level is the mean of chi at
the input points; marching tetrahedra meshes the level set on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dnsplatter_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class PoissonConfig:
    resolution: int = 128
    padding: float = 0.1  # fraction of extent on each side
    smooth_sigma_vox: float = 1.5  # normal-splat smoothing
    screening: float = 0.0  # alpha: (lap - alpha) chi = div V  (0 = pure)
    # Solver: "fft" (spectral, exact, complex64: ~16 B a voxel), "cg"
    # (conjugate gradients on the Dirichlet Laplacian, float32: ~4 B a
    # voxel). "auto" = fft up to 192^3, cg above.
    solver: str = "auto"
    cg_tol: float = 1e-5
    cg_maxiter: int = 0  # 0 -> 3 * resolution


# CG iterations between two host reads of the stopping test; the iterations
# in between are masked once it holds, so the result is the one a test after
# every iteration gives.
CG_CHECK_EVERY = 16


def _splat_field(points01: torch.Tensor, normals: torch.Tensor,
                 res: int) -> torch.Tensor:
    """Trilinear splat of unit normals into a (res, res, res, 3) grid."""
    x = points01 * (res - 1)
    x0 = torch.floor(x).int()
    frac = x - x0
    grid = torch.zeros((res, res, res, 3), device=points01.device)
    for corner in range(8):
        off = torch.tensor([(corner >> 0) & 1, (corner >> 1) & 1,
                            (corner >> 2) & 1], dtype=torch.int32,
                           device=points01.device)
        idx = torch.clamp(x0 + off, 0, res - 1).long()
        w = torch.prod(torch.where(off == 1, frac, 1.0 - frac), dim=-1,
                       keepdim=True)
        grid.index_put_((idx[:, 0], idx[:, 1], idx[:, 2]), w * normals,
                        accumulate=True)
    return grid


def _solve_poisson(vfield: torch.Tensor, sigma_vox: float,
                   screening: float) -> torch.Tensor:
    """vfield: (R, R, R, 3) -> chi (R, R, R) with lap(chi) = div(V)."""
    r = vfield.shape[0]
    k = torch.fft.fftfreq(r, device=vfield.device) * 2.0 * math.pi
    kx = k[:, None, None]
    ky = k[None, :, None]
    kz = k[None, None, :]
    vx = torch.fft.fftn(vfield[..., 0])
    vy = torch.fft.fftn(vfield[..., 1])
    vz = torch.fft.fftn(vfield[..., 2])
    # spectral gaussian smoothing of the splatted field
    k2 = kx ** 2 + ky ** 2 + kz ** 2
    smooth = torch.exp(-0.5 * (sigma_vox ** 2) * k2)
    vx, vy, vz = vx * smooth, vy * smooth, vz * smooth
    # div V in frequency space: i k . V
    div = 1j * (kx * vx + ky * vy + kz * vz)
    denom = -(k2 + screening)
    denom = torch.where(torch.abs(denom) < 1e-12, 1.0, denom)
    chi_hat = torch.where(k2 < 1e-12, 0.0, div / denom)
    return torch.fft.ifftn(chi_hat).real


def _laplacian(x: torch.Tensor) -> torch.Tensor:
    """6-point Laplacian with Dirichlet-0 boundaries (unit spacing)."""
    p = F.pad(x, (1, 1, 1, 1, 1, 1))
    return (p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1]
            + p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1]
            + p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:] - 6.0 * x)


def _cg_rhs(vfield: torch.Tensor, sigma_vox: float) -> torch.Tensor:
    """div(smooth(V)), the CG right-hand side."""
    # separable smoothing: repeated [1,2,1]/4 passes approximate a gaussian
    # with sigma^2 = reps/2 per axis
    reps = max(int(round(2.0 * sigma_vox * sigma_vox)), 0)

    def blur_axis(x, axis):
        n = x.shape[axis]
        xp = torch.cat([x.narrow(axis, 0, 1), x, x.narrow(axis, n - 1, 1)],
                       dim=axis)
        return (xp.narrow(axis, 0, n) + 2.0 * xp.narrow(axis, 1, n)
                + xp.narrow(axis, 2, n)) * 0.25

    v = vfield
    for _ in range(reps):
        for ax in range(3):
            v = blur_axis(v, ax)

    # div V by central differences (unit voxel spacing)
    def cdiff(x, axis):
        n = x.shape[axis]
        pad = [0, 0] * 3
        pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = 1
        p = F.pad(x, pad)
        return 0.5 * (p.narrow(axis, 2, n) - p.narrow(axis, 0, n))

    return (cdiff(v[..., 0], 0) + cdiff(v[..., 1], 1)
            + cdiff(v[..., 2], 2))


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def _solve_poisson_cg(vfield: torch.Tensor, sigma_vox: float,
                      screening: float, tol: float = 1e-5,
                      maxiter: int = 600) -> torch.Tensor:
    """Conjugate-gradient solve of (lap - screening) chi = div V with
    Dirichlet-0 boundaries (the domain is padded, so the indicator's far
    field is a constant the iso-level choice absorbs).

    float32 throughout (a quarter of the FFT path's complex64 footprint).
    The splat smoothing is a separable binomial approximation of the
    spectral gaussian; -(lap - screening) is SPD. The iteration is
    `jax.scipy.sparse.linalg.cg`'s: x0 = 0, stop once r.r <= tol^2 b.b or
    after `maxiter` iterations. The test is read on the host every
    CG_CHECK_EVERY iterations; an iteration after it holds changes
    nothing."""
    b = -_cg_rhs(vfield, sigma_vox)

    def matvec(x):
        return -(_laplacian(x) - screening * x)

    atol2 = (tol * tol) * _vdot(b, b)
    x = torch.zeros_like(b)
    r = b - matvec(x)
    p = r
    gamma = _vdot(r, r)
    k = 0
    while k < maxiter:
        if k % CG_CHECK_EVERY == 0 and not bool(gamma > atol2):
            break
        live = gamma > atol2
        ap = matvec(p)
        alpha = torch.where(live, gamma / _vdot(p, ap), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        gamma_new = _vdot(r, r)
        beta = gamma_new / gamma
        p = torch.where(live, r + beta * p, p)
        gamma = torch.where(live, gamma_new, gamma)
        k += 1
    return x


@torch.no_grad()
def cg_residual(vfield: torch.Tensor, chi: torch.Tensor, sigma_vox: float,
                screening: float) -> float:
    """Relative residual ||(lap - screening) chi - div(smooth V)|| /
    ||div(smooth V)|| of a CG solution."""
    b = _cg_rhs(vfield, sigma_vox)
    r = (_laplacian(chi) - screening * chi) - b
    return float(torch.linalg.norm(r.ravel())
                 / torch.clamp(torch.linalg.norm(b.ravel()), min=1e-12))


def poisson_field(points: np.ndarray, normals: np.ndarray,
                  cfg: PoissonConfig = PoissonConfig(), device=None):
    """The solved indicator: (chi (R, R, R) on `device`, the padded box's
    lower corner, its span, the points in [0, 1]^3)."""
    dev = resolve_device(device)
    pts = np.asarray(points, np.float32)
    nrm = np.asarray(normals, np.float32)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-8)
    lo = pts.min(0)
    hi = pts.max(0)
    extent = np.maximum(hi - lo, 1e-6)
    lo_p = lo - cfg.padding * extent
    hi_p = hi + cfg.padding * extent
    span = hi_p - lo_p
    p01 = (pts - lo_p) / span

    r = cfg.resolution
    vfield = _splat_field(torch.as_tensor(p01, device=dev),
                          torch.as_tensor(nrm, device=dev), r)
    # anisotropic voxel sizes: the gradient in voxel units
    vfield = vfield * torch.as_tensor(r / span, dtype=torch.float32,
                                      device=dev)
    solver = cfg.solver
    if solver == "auto":
        solver = "fft" if r <= 192 else "cg"
    if solver == "cg":
        chi = _solve_poisson_cg(vfield, cfg.smooth_sigma_vox, cfg.screening,
                                cfg.cg_tol, cfg.cg_maxiter or 3 * r)
    else:
        chi = _solve_poisson(vfield, cfg.smooth_sigma_vox, cfg.screening)
    return chi, lo_p, span, p01


@torch.no_grad()
def poisson_reconstruct(points: np.ndarray, normals: np.ndarray,
                        cfg: PoissonConfig = PoissonConfig(), device=None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Oriented point cloud -> (vertices (V, 3), faces (F, 3))."""
    from dnsplatter_torch.mesh.marching import marching_tetrahedra

    chi, lo_p, span, p01 = poisson_field(points, normals, cfg, device)
    r = cfg.resolution
    # iso level: mean chi at the sample points
    chi_np = chi.cpu().numpy()
    ip = np.clip((p01 * (r - 1)).astype(int), 0, r - 1)
    iso = float(chi_np[ip[:, 0], ip[:, 1], ip[:, 2]].mean())
    # inside = chi > iso; marching expects inside = field < level
    verts, faces = marching_tetrahedra(iso - chi_np, 0.0)
    verts_w = lo_p + verts / (r - 1) * span
    return verts_w.astype(np.float32), faces


def _compact(verts, faces, keep_v):
    keep_f = keep_v[faces].all(1)
    f = faces[keep_f]
    used = np.zeros(len(verts), bool)
    used[f] = True
    remap = np.cumsum(used) - 1
    return verts[used], remap[f].astype(np.int32)


def trim_mesh_to_points(verts: np.ndarray, faces: np.ndarray,
                        points: np.ndarray, max_dist: float
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Drop faces farther than `max_dist` from any input point (the
    reference's density-quantile vertex cull in spirit)."""
    from scipy.spatial import cKDTree

    d, _ = cKDTree(points, compact_nodes=False).query(verts, k=1,
                                                       workers=-1)
    return _compact(verts, faces, d < max_dist)


def density_quantile_cull(verts: np.ndarray, faces: np.ndarray,
                          points: np.ndarray, quantile: float = 0.1,
                          k: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Drop the lowest-support vertices: the reference's Poisson
    density-quantile vertex cull (Open3D returns per-vertex densities; here
    support = -(distance to the k-th nearest input point), the same
    ordering)."""
    from scipy.spatial import cKDTree

    if len(verts) == 0 or len(points) < k:
        return verts, faces
    d, _ = cKDTree(points, compact_nodes=False).query(verts, k=k,
                                                       workers=-1)
    support = -d[:, -1]
    return _compact(verts, faces, support > np.quantile(support, quantile))
