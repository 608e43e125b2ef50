"""Gaussian parameter state (counterpart of
dnsplatter_tpu/models/gaussians.py): fixed-capacity tensors plus an
`alive` mask kept beside them, and their initialisation from a seed point
cloud. Random draws come from a numpy Generator or are passed in, so a test
can hand the same draws to both packages."""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from dnsplatter_torch import resolve_device
from dnsplatter_torch.ops.quat import (
    quat_to_rotmat,
    random_quats,
    rotate_vector_to_vector,
    rotmat_to_quat,
)
from dnsplatter_torch.ops.sh import num_sh_bases, rgb_to_sh


@dataclasses.dataclass(frozen=True)
class GaussianParams:
    """Gaussian state, leading dim = capacity C."""

    means: torch.Tensor  # (C, 3)
    scales: torch.Tensor  # (C, 3) log-scales
    quats: torch.Tensor  # (C, 4) wxyz
    features_dc: torch.Tensor  # (C, 3) SH degree-0 coefficients
    features_rest: torch.Tensor  # (C, B-1, 3) higher SH coefficients
    opacities: torch.Tensor  # (C,) logits
    normals: torch.Tensor  # (C, 3) trainable normal parameter

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def sh_bases(self) -> int:
        return self.features_rest.shape[1] + 1

    @property
    def sh_degree(self) -> int:
        """Degree implied by the stored bases: B = (deg+1)^2."""
        return int(round(self.sh_bases ** 0.5)) - 1


FIELDS = tuple(f.name for f in dataclasses.fields(GaussianParams))


def params_from_numpy(arrays: Mapping[str, np.ndarray],
                      device=None) -> GaussianParams:
    """The JAX package's parameters, as numpy arrays keyed by field name,
    as the port's float32 parameters on `device` (None: the card)."""
    dev = resolve_device(device)
    missing = [f for f in FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"missing Gaussian fields: {missing}")
    return GaussianParams(**{
        f: torch.as_tensor(np.asarray(arrays[f], np.float32), device=dev)
        for f in FIELDS
    })


def params_to_numpy(params: GaussianParams) -> dict:
    """The inverse of `params_from_numpy`: numpy arrays keyed by field."""
    return {f: getattr(params, f).detach().cpu().numpy() for f in FIELDS}


def knn_mean_dist(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean distance to the k nearest neighbours, on the host (scipy
    cKDTree). Runs once at init."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    # k + 1: the closest hit is the point itself
    dists, _ = tree.query(points, k=k + 1, workers=-1)
    return dists[:, 1:].mean(axis=1)


def init_from_points(
    rng: np.random.Generator,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    sh_degree: int = 3,
    capacity: Optional[int] = None,
    init_opacity: float = 0.1,
    device=None,
    quats: Optional[np.ndarray] = None,
) -> Tuple[GaussianParams, torch.Tensor, int]:
    """GaussianParams from a seed point cloud (the JAX package's init):
    log-scales from the mean 3-NN distance, orientation from `normals`
    (flattest axis onto the normal, that axis shrunk tenfold) or random,
    SH DC from `colors`, opacity logit(0.1). Dead slots: identity quats,
    log-scale -10, opacity logit -15.

    Random quaternions are drawn from `rng` unless `quats` (N, 4) is
    given. Returns (params, alive (C,) float, n_alive)."""
    dev = resolve_device(device)
    n = int(points.shape[0])
    if capacity is None:
        capacity = max(4096, int(np.ceil(2 * n / 4096) * 4096))
    if capacity < n:
        raise ValueError(f"capacity {capacity} < seed points {n}")
    b = num_sh_bases(sh_degree)

    dists = np.maximum(knn_mean_dist(points, k=3), 1e-7)
    scales_np = np.log(dists)[:, None].repeat(3, axis=1)

    if normals is not None:
        nrm = normals / np.maximum(
            np.linalg.norm(normals, axis=-1, keepdims=True), 1e-12)
        z = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3)
        rots = rotate_vector_to_vector(
            z, torch.as_tensor(nrm.astype(np.float32)))
        quats_n = rotmat_to_quat(rots).numpy()
        scales_np[:, 2] = scales_np[:, 2] - np.log(10.0)
        normals_init = nrm.astype(np.float32)
    else:
        if quats is None:
            quats = random_quats(rng, n, device="cpu").numpy()
        quats_n = np.asarray(quats, np.float32)
        rot = quat_to_rotmat(torch.as_tensor(quats_n))
        normals_init = rot[..., :, 2].numpy()

    if colors is None:
        colors = np.random.default_rng(0).uniform(size=(n, 3))
    dc = rgb_to_sh(torch.as_tensor(np.asarray(colors, np.float32))).numpy()

    def pad(x, fill=0.0):
        x = np.asarray(x, np.float32)
        out = np.full((capacity,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return torch.as_tensor(out, device=dev)

    quats_pad = np.zeros((capacity, 4), np.float32)
    quats_pad[:, 0] = 1.0
    quats_pad[:n] = quats_n

    params = GaussianParams(
        means=pad(points),
        scales=pad(scales_np, fill=-10.0),
        quats=torch.as_tensor(quats_pad, device=dev),
        features_dc=pad(dc),
        features_rest=torch.zeros((capacity, b - 1, 3), device=dev),
        opacities=pad(
            np.full((n,), float(np.log(init_opacity / (1 - init_opacity)))),
            fill=-15.0),
        normals=pad(normals_init),
    )
    alive = torch.zeros(capacity, device=dev)
    alive[:n] = 1.0
    return params, alive, n


def pad_rows(x: torch.Tensor, pad: int, fill: float = 0.0) -> torch.Tensor:
    """`x` with `pad` rows of `fill` appended along dim 0."""
    tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, tail], dim=0)


def grow_capacity(params: GaussianParams, alive: torch.Tensor,
                  new_capacity: int) -> Tuple[GaussianParams, torch.Tensor]:
    """Re-pad the state to a larger capacity with `init_from_points`'
    dead-slot fills (identity quats, log-scale -10, opacity logit -15)."""
    c = params.capacity
    if new_capacity <= c:
        return params, alive
    pad = new_capacity - c
    quats_tail = torch.zeros((pad, 4), device=alive.device)
    quats_tail[:, 0] = 1.0
    params = GaussianParams(
        means=pad_rows(params.means, pad),
        scales=pad_rows(params.scales, pad, -10.0),
        quats=torch.cat([params.quats, quats_tail], dim=0),
        features_dc=pad_rows(params.features_dc, pad),
        features_rest=pad_rows(params.features_rest, pad),
        opacities=pad_rows(params.opacities, pad, -15.0),
        normals=pad_rows(params.normals, pad),
    )
    return params, pad_rows(alive, pad)


def init_random(
    rng: np.random.Generator,
    num_points: int = 500_000,
    extent: float = 5.0,
    sh_degree: int = 3,
    capacity: Optional[int] = None,
    device=None,
) -> Tuple[GaussianParams, torch.Tensor, int]:
    """Random fallback init: points uniform in [-extent, extent]^3 with
    uniform colours."""
    pts = rng.uniform(-extent, extent, (num_points, 3)).astype(np.float32)
    cols = rng.uniform(size=(num_points, 3)).astype(np.float32)
    return init_from_points(rng, pts, cols, sh_degree=sh_degree,
                            capacity=capacity, device=device)
