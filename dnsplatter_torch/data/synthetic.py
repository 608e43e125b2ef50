"""Synthetic Gaussian-mixture scenes (counterpart of
dnsplatter_tpu/data/synthetic.py): ground truth from any viewpoint with no
files. Random draws come from a numpy Generator, so a test can hand the
same draws to both packages."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from dnsplatter_torch import resolve_device
from dnsplatter_torch.models.gaussians import GaussianParams
from dnsplatter_torch.ops.camera import Camera, look_at
from dnsplatter_torch.ops.quat import random_quats
from dnsplatter_torch.ops.rasterize import RasterizeConfig
from dnsplatter_torch.ops.render import render
from dnsplatter_torch.ops.sh import num_sh_bases, rgb_to_sh, sh_to_rgb


def make_gt_gaussians(rng: np.random.Generator, n: int = 800,
                      extent: float = 1.0, sh_degree: int = 3,
                      scale_shift: float = 0.0, device=None
                      ) -> Tuple[GaussianParams, torch.Tensor]:
    """A colourful random Gaussian-mixture 'room', the JAX package's
    distributions. `scale_shift` offsets the log-scales: pass
    -ln(N/N0)/3 to keep an N-point cloud's overdraw at the default N0's."""
    dev = resolve_device(device)

    def uniform(lo, hi, shape):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32),
                               device=dev)

    means = uniform(-extent, extent, (n, 3))
    scales = uniform(-4.2 + scale_shift, -2.8 + scale_shift, (n, 3))
    quats = random_quats(rng, n, device=dev)
    colors = uniform(0.05, 0.95, (n, 3))
    opac = uniform(1.0, 3.0, (n,))  # logits
    b = num_sh_bases(sh_degree)
    params = GaussianParams(
        means=means,
        scales=scales,
        quats=quats,
        features_dc=rgb_to_sh(colors),
        features_rest=torch.zeros((n, b - 1, 3), device=dev),
        opacities=opac,
        normals=torch.zeros((n, 3), device=dev),
    )
    return params, torch.ones(n, device=dev)


def ring_cameras(num: int, radius: float = 3.0, height: float = 0.8,
                 width: int = 96, img_height: int = 72, focal: float = 80.0,
                 device=None) -> List[Camera]:
    """`num` cameras on a ring, all looking at the origin."""
    dev = resolve_device(device)
    cams = []
    for i in range(num):
        ang = 2.0 * np.pi * i / num
        eye = (radius * np.cos(ang), height, radius * np.sin(ang))
        c2w = look_at(eye, (0.0, 0.0, 0.0), device=dev)
        cams.append(Camera.create(focal, focal, width / 2, img_height / 2,
                                  c2w, width, img_height, device=dev))
    return cams


@dataclasses.dataclass
class SyntheticScene:
    """Scene source: __len__ + get(i) -> (Camera, batch of numpy arrays)."""

    cameras: List[Camera]
    batches: List[Dict[str, np.ndarray]]
    gt_params: GaussianParams
    gt_alive: torch.Tensor

    def __len__(self) -> int:
        return len(self.cameras)

    def get(self, i: int):
        return self.cameras[i], self.batches[i]

    def seed_points(self, rng: np.random.Generator, noise: float = 0.02,
                    subsample: int = 1, draws: np.ndarray = None):
        """Noisy seed point cloud from the ground-truth means (a stand-in
        for SfM points): (points, colours), float32. The standard-normal
        `draws` come from `rng` unless given."""
        pts = self.gt_params.means.cpu().numpy()[::subsample]
        cols = np.clip(
            sh_to_rgb(self.gt_params.features_dc).cpu().numpy()[::subsample],
            0, 1)
        if draws is None:
            draws = rng.standard_normal(pts.shape).astype(np.float32)
        pts = pts + np.asarray(draws, np.float32) * noise
        return pts.astype(np.float32), cols.astype(np.float32)


def render_batches(params: GaussianParams, alive: torch.Tensor,
                   cams: List[Camera], cfg_of, sh_degree: int = 0
                   ) -> List[Dict[str, np.ndarray]]:
    """Ground-truth batches (image, sensor_depth, normal in [0, 1]) of
    `params` from each camera; `cfg_of(cam)` gives its RasterizeConfig."""
    batches = []
    with torch.no_grad():
        for cam in cams:
            out, _ = render(params, alive, cam, cfg_of(cam),
                            sh_degree_to_use=sh_degree,
                            background=torch.zeros(3, device=cam.device))
            n = out.normal
            n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-8)
            batches.append({
                "image": out.rgb.cpu().numpy(),
                "sensor_depth": out.depth.cpu().numpy(),
                "normal": ((n + 1.0) * 0.5).cpu().numpy(),
            })
    return batches


def make_synthetic_scene(seed: int = 0, n_gaussians: int = 800,
                         n_cameras: int = 6, width: int = 96,
                         height: int = 72, pair_capacity: int = 1 << 16,
                         device=None) -> SyntheticScene:
    """A `make_gt_gaussians` mixture seen by `ring_cameras`, with
    ground-truth batches rendered at SH degree 0."""
    dev = resolve_device(device)
    gt, alive = make_gt_gaussians(np.random.default_rng(seed), n_gaussians,
                                  device=dev)
    cams = ring_cameras(n_cameras, width=width, img_height=height,
                        device=dev)
    cfg = RasterizeConfig(width=width, height=height, tile_size=16,
                          chunk=32, tile_block=4, pair_capacity=pair_capacity)
    batches = render_batches(gt, alive, cams, lambda cam: cfg)
    return SyntheticScene(cameras=cams, batches=batches, gt_params=gt,
                          gt_alive=alive)
