"""g_neusfacto baseline: NeuS-style SDF field with RGB + D + N supervision
(counterpart of dnsplatter_tpu/baselines/neusfacto.py).

An SDF hash field rendered with NeuS's logistic-CDF weighting, trained with
RGB, sensor depth (freespace and near-surface SDF terms) and mono-normal
losses; normals are the SDF's gradient. The JAX package takes each point's
gradient with `vmap(value_and_grad)`; here one `torch.autograd.grad` over
all points gives the same, because each SDF value depends on its own point
only. Under autograd the gradient keeps its graph, so the eikonal, normal
and colour terms reach the hash tables and the MLPs through it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from dnsplatter_torch.baselines import fields as F
from dnsplatter_torch.baselines.nerfacto import (Adam, camera_rays,
                                                 pixel_draws)

N_RAYS = 512  # rays a train step (the JAX step's constant)


@dataclasses.dataclass(frozen=True)
class NeuSConfig:
    near: float = 0.05
    far: float = 8.0
    n_samples: int = 96
    hash: F.HashGridConfig = F.HashGridConfig(n_levels=10)
    hidden: int = 64
    geo_feat: int = 15
    scene_scale: float = 4.0
    depth_lambda: float = 0.1
    normal_lambda: float = 0.05
    freespace_trunc: float = 0.05  # SensorDepthLoss truncation


class NeuSParams(nn.Module):
    """`tables`, `sdf_mlp`, `color_mlp` and the 0-d `inv_s` (log of the
    sharpness): the JAX NamedTuple's fields."""

    def __init__(self, cfg: NeuSConfig,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        in_dim = cfg.hash.n_levels * cfg.hash.features_per_level
        if generator is None:
            tables = torch.zeros((cfg.hash.n_levels,
                                  1 << cfg.hash.log2_table_size,
                                  cfg.hash.features_per_level))
        else:
            tables = F.init_hash_grid(generator, cfg.hash)
        self.tables = nn.Parameter(tables.to(device))
        self.sdf_mlp = F.init_mlp(generator,
                                  (in_dim + 3, cfg.hidden, 1 + cfg.geo_feat),
                                  device)
        self.color_mlp = F.init_mlp(generator,
                                    (cfg.geo_feat + 9 + 3, cfg.hidden, 3),
                                    device)
        self.inv_s = nn.Parameter(torch.tensor(2.3, device=device))


def init_params(generator: torch.Generator, cfg: NeuSConfig,
                device=None) -> NeuSParams:
    return NeuSParams(cfg, generator, device)


def _field_h(params: NeuSParams, cfg: NeuSConfig,
             pts: torch.Tensor) -> torch.Tensor:
    """(..., 1 + geo_feat) raw field head: [sdf residual, geo features]."""
    x01 = F.jclip(pts / (2 * cfg.scene_scale) + 0.5, 0.0, 1.0)
    enc = F.hash_encode(params.tables, x01, cfg.hash)
    return params.sdf_mlp(torch.cat([enc, pts], -1))


def sdf_fn(params: NeuSParams, cfg: NeuSConfig,
           pts: torch.Tensor) -> torch.Tensor:
    h = _field_h(params, cfg, pts)
    # geometric init bias: sphere-ish SDF at start
    return h[..., 0] + (torch.linalg.norm(pts, dim=-1) - 1.0)


def sdf_geo_and_grad(params: NeuSParams, cfg: NeuSConfig, pts: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sdf (...), geo features (..., geo_feat), d sdf / d pts (..., 3)) from
    one field evaluation. Where autograd is on, the gradient keeps its
    graph (second derivatives reach the parameters)."""
    train = torch.is_grad_enabled()
    with torch.enable_grad():
        p = pts.detach().requires_grad_(True)
        h = _field_h(params, cfg, p)
        sdf = h[..., 0] + (torch.linalg.norm(p, dim=-1) - 1.0)
        (grad,) = torch.autograd.grad(sdf, p, torch.ones_like(sdf),
                                      create_graph=train)
    if not train:
        sdf, h = sdf.detach(), h.detach()
    return sdf, h[..., 1:], grad


def render_rays(params: NeuSParams, cfg: NeuSConfig, origins: torch.Tensor,
                dirs: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                jitter: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """origins (R, 3), unit dirs (R, 3); `jitter` (R, n_samples) uniforms in
    [0, 1), drawn from `generator` when not given."""
    if jitter is None:
        jitter = torch.rand((origins.shape[0], cfg.n_samples),
                            generator=generator, device=generator.device)
    return render_samples(params, cfg, origins, dirs,
                          sample_distances(cfg, jitter))


def sample_distances(cfg: NeuSConfig, jitter: torch.Tensor) -> torch.Tensor:
    """(R, n_samples) distances: the uniform grid, each sample jittered
    within its bin by `jitter` in [0, 1)."""
    ts = torch.linspace(cfg.near, cfg.far, cfg.n_samples,
                        device=jitter.device).expand(jitter.shape)
    return ts + jitter * ((cfg.far - cfg.near) / cfg.n_samples)


def render_samples(params: NeuSParams, cfg: NeuSConfig,
                   origins: torch.Tensor, dirs: torch.Tensor,
                   ts: torch.Tensor) -> Dict[str, torch.Tensor]:
    """NeuS rendering of the SDF field at sample distances `ts` (R, S)."""
    pts = origins[:, None] + ts[..., None] * dirs[:, None]
    sdf, geo, grad = sdf_geo_and_grad(params, cfg, pts)

    # NeuS alpha from the logistic CDF of the SDF along the ray
    inv_s = torch.exp(params.inv_s)
    cdf = torch.sigmoid(sdf * inv_s)
    alpha = F.jclip((cdf[..., :-1] - cdf[..., 1:])
                    / F.jmax(cdf[..., :-1], 1e-6), 0.0, 1.0)
    alpha = torch.cat([alpha, torch.zeros_like(alpha[..., :1])], -1)
    trans = torch.cumprod(1.0 - alpha + 1e-7, -1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    w = alpha * trans

    # rsqrt(|g|^2 + eps): the norm's gradient is NaN at exactly 0
    normal = grad * torch.rsqrt(torch.sum(grad * grad, -1, keepdim=True)
                                + 1e-12)
    denc = F.sh_dir_encode(dirs)[:, None, :].expand(pts.shape[:-1] + (9,))
    rgb = params.color_mlp(torch.cat([geo, denc, normal], -1), torch.sigmoid)

    acc = torch.sum(w, -1, keepdim=True)
    out_rgb = torch.sum(w[..., None] * rgb, dim=1)
    depth = torch.sum(w * ts, -1, keepdim=True) / F.jmax(acc, 1e-8)
    out_normal = torch.sum(w[..., None] * normal, dim=1)
    eik = torch.mean((torch.linalg.norm(grad, dim=-1) - 1.0) ** 2)
    return {"rgb": out_rgb, "depth": depth, "normal": out_normal,
            "accumulation": acc, "eikonal": eik, "sdf": sdf, "ts": ts, "w": w}


def sensor_depth_loss(out: Dict[str, torch.Tensor],
                      depth_gt_rays: torch.Tensor,
                      trunc: float) -> torch.Tensor:
    """Freespace + SDF supervision along rays (the reference's
    SensorDepthLoss); `depth_gt_rays` (R, 1)."""
    ts, sdf, d = out["ts"], out["sdf"], depth_gt_rays
    valid = (d[:, 0] > 0.1)[:, None]
    # freespace: samples well before the surface should have sdf > 0
    free = (ts < d - trunc) & valid
    l_free = torch.sum(torch.where(free, torch.relu(-sdf), 0.0)) / torch.clamp(
        free.sum().float(), min=1.0)
    # near-surface: sdf should match the depth difference
    near = (torch.abs(ts - d) <= trunc) & valid
    l_sdf = torch.sum(torch.where(near, torch.abs(sdf - (d - ts)), 0.0)) / (
        torch.clamp(near.sum().float(), min=1.0))
    return l_free + l_sdf


def train_loss(params: NeuSParams, cfg: NeuSConfig, camera,
               image: torch.Tensor, depth_gt: Optional[torch.Tensor],
               normal_gt: Optional[torch.Tensor],
               draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The step's loss on the rays of `draws["px"]` with the sample jitter
    `draws["jitter"]` (or the sample distances `draws["ts"]`): colour MSE,
    0.1 x eikonal, and the sensor-depth and mono-normal terms where their
    targets are given."""
    px = draws["px"]
    o, d = camera_rays(camera, px)
    gt = image[px[:, 1], px[:, 0]]
    if "ts" in draws:
        out = render_samples(params, cfg, o, d, draws["ts"])
    else:
        out = render_rays(params, cfg, o, d, jitter=draws["jitter"])
    loss = torch.mean((out["rgb"] - gt) ** 2) + 0.1 * out["eikonal"]
    if depth_gt is not None:
        dr = depth_gt[px[:, 1], px[:, 0]]
        loss = loss + cfg.depth_lambda * sensor_depth_loss(
            out, dr, cfg.freespace_trunc)
    if normal_gt is not None:
        ngt = 2.0 * normal_gt[px[:, 1], px[:, 0]] - 1.0
        loss = loss + cfg.normal_lambda * torch.mean(
            torch.abs(out["normal"] - ngt))
    return loss


def make_train_step(cfg: NeuSConfig, lr: float = 5e-3):
    """(step, Adam init): `step(params, opt, camera, image, depth_gt,
    normal_gt, generator=None, draws=None)` takes one Adam step and returns
    the loss (detached)."""

    def step(params, opt, camera, image, depth_gt, normal_gt, generator=None,
             draws=None):
        if draws is None:
            draws = {"px": pixel_draws(N_RAYS, camera.width, camera.height,
                                       generator),
                     "jitter": torch.rand((N_RAYS, cfg.n_samples),
                                          generator=generator,
                                          device=generator.device)}
        opt.zero_grad()
        loss = train_loss(params, cfg, camera, image, depth_gt, normal_gt,
                          draws)
        loss.backward()
        opt.step()
        return loss.detach()

    return step, functools.partial(Adam, lr=lr)
