"""Depth/normal regularization strategies: DN-Splatter and AGS-Mesh
(counterpart of dnsplatter_tpu/models/regularization.py).

  * DN: loss = depth + normal + scale. Depth masked by gt > depth_tolerance,
    EdgeAwareLogL1 by default, then scaled by (1 + depth_lambda) (the
    reference's `depth_loss += depth_lambda * depth_loss`). The pearson
    type combines global pearson + depth_lambda * local pearson. Normal:
    L1 + TV smoothness. Scale: mean(min exp(scale)).
  * AGS-Mesh, staged: depth always (lambda * loss), gt zeroed by the
    confidence mask from step 7000; the normal loss switches on after 7000,
    masked by dilated Laplacian edges of the gt normal before 15000 and by
    angular confidence <= 0.1 rad from then on; plus pred-normal L1 and the
    scale loss.

`step` is a Python int here (the port runs eagerly), so the gates are plain
branches; the value and gradient equal the JAX package's where-select.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from dnsplatter_torch.models import losses as L

_LAPLACIAN = ((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0))


def _conv2d_same(img: torch.Tensor, kernel) -> torch.Tensor:
    """(H, W, C) image, (kh, kw) kernel (nested sequence), zero 'SAME'
    padding per channel (cross-correlation), as shifted sums."""
    kh, kw = len(kernel), len(kernel[0])
    h, w = img.shape[0], img.shape[1]
    x = F.pad(img, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    out = torch.zeros_like(img)
    for i in range(kh):
        for j in range(kw):
            if kernel[i][j] != 0.0:
                out = out + kernel[i][j] * x[i:i + h, j:j + w]
    return out


def find_edges(im: torch.Tensor, threshold: float = 0.01,
               dilation_itr: int = 1) -> torch.Tensor:
    """Dilated Laplacian edge mask of an (H, W, C) map: the Laplacian of
    1 / (im + 1e-6) thresholded, then dilated by a 3x3 ones kernel.
    Returns (H, W, C) bool."""
    lap = _conv2d_same(1.0 / (im + 1e-6), _LAPLACIAN)
    edges = (lap > threshold).to(im.dtype)
    ones = ((1.0,) * 3,) * 3
    for _ in range(dilation_itr):
        edges = _conv2d_same(edges, ones)
    return edges > 0.0


def dilate_edge(edge: torch.Tensor, dilation_size: int = 1) -> torch.Tensor:
    """Binary dilation with a (2d+1)^2 ones kernel."""
    k = 2 * dilation_size + 1
    return torch.clamp(_conv2d_same(edge, ((1.0,) * k,) * k), 0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class RegularizationConfig:
    depth_tolerance: float = 0.1
    depth_loss_type: str = "edge_aware_log_l1"
    depth_lambda: float = 0.2
    normal_lambda: float = 0.1
    normal_mask_steps: int = 15000  # AGS angular-confidence gate
    depth_mask_steps: int = 7000  # AGS confidence-filter gate
    use_normal_loss: bool = True
    use_normal_tv_loss: bool = True
    use_normal_cosine_loss: bool = False


def _depth_loss_core(cfg: RegularizationConfig, pred_depth, gt_depth, gt_img,
                     mask, pearson_corners, generator) -> torch.Tensor:
    t = cfg.depth_loss_type
    if t == "edge_aware_log_l1":
        return L.edge_aware_log_l1_loss(pred_depth, gt_depth, gt_img, mask)
    if t == "mse":
        return L.mse_loss(pred_depth, gt_depth, mask)
    if t == "l1":
        return L.l1_loss(pred_depth, gt_depth, mask)
    if t == "log_l1":
        return L.log_l1_loss(pred_depth, gt_depth, mask)
    if t == "huber_l1":
        return L.huber_l1_loss(pred_depth, gt_depth, mask)
    if t == "pearson":
        glob = L.pearson_depth_loss(pred_depth, gt_depth)
        loc = L.local_pearson_depth_loss(pred_depth, gt_depth,
                                         corners=pearson_corners,
                                         generator=generator)
        return glob + cfg.depth_lambda * loc
    raise ValueError(f"unknown depth loss {t}")


def dn_regularization_loss(
    cfg: RegularizationConfig,
    pred_depth: torch.Tensor,
    gt_depth: Optional[torch.Tensor],
    pred_normal: Optional[torch.Tensor],
    gt_normal: Optional[torch.Tensor],
    scales: torch.Tensor,
    gt_img: torch.Tensor,
    alive: Optional[torch.Tensor] = None,
    pearson_corners=None,
    generator: Optional[torch.Generator] = None,
    use_depth: bool = True,
) -> torch.Tensor:
    """The DN-Splatter strategy. `pearson_corners` / `generator` feed the
    local pearson boxes of depth_loss_type "pearson"."""
    loss = torch.zeros((), device=scales.device)
    if use_depth and gt_depth is not None:
        valid = gt_depth > cfg.depth_tolerance
        dl = _depth_loss_core(cfg, pred_depth, gt_depth, gt_img, valid,
                              pearson_corners, generator)
        loss = loss + (dl + cfg.depth_lambda * dl)
    if (cfg.use_normal_loss and pred_normal is not None
            and gt_normal is not None):
        nl = L.normal_l1_loss(pred_normal, gt_normal)
        if cfg.use_normal_tv_loss:
            nl = nl + L.normal_tv_loss(pred_normal)
        if cfg.use_normal_cosine_loss:
            nl = nl + L.normal_cosine_loss(2.0 * pred_normal - 1.0,
                                           2.0 * gt_normal - 1.0)
        loss = loss + nl
    return loss + L.scale_flatten_loss(scales, alive)


def ags_regularization_loss(
    cfg: RegularizationConfig,
    step: int,
    pred_depth: torch.Tensor,
    gt_depth: Optional[torch.Tensor],
    confidence: Optional[torch.Tensor],
    surf_normal: Optional[torch.Tensor],
    gt_normal: Optional[torch.Tensor],
    pred_normal: Optional[torch.Tensor],
    scales: torch.Tensor,
    gt_img: torch.Tensor,
    alive: Optional[torch.Tensor] = None,
    pearson_corners=None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The AGS-Mesh strategy; normal maps in [-1, 1] vector space."""
    step = int(step)
    loss = torch.zeros((), device=scales.device)
    if gt_depth is not None:
        gt_eff = gt_depth
        if step >= cfg.depth_mask_steps:
            if confidence is None:
                confidence = torch.ones_like(gt_depth)
            gt_eff = torch.where(confidence > 0, gt_depth, 0.0)
        mask = gt_eff > cfg.depth_tolerance
        dl = _depth_loss_core(cfg, pred_depth, gt_eff, gt_img, mask,
                              pearson_corners, generator)
        loss = loss + cfg.depth_lambda * dl

    if surf_normal is not None and gt_normal is not None:
        lam = cfg.normal_lambda if step > cfg.depth_mask_steps else 0.0
        diff = torch.abs(surf_normal - gt_normal)
        if step < cfg.normal_mask_steps:  # exclude dilated edges
            nl = L.masked_mean(diff, ~find_edges(gt_normal))
        else:  # angular-confidence mask
            ang = L.mean_angular_error_map(surf_normal, gt_normal)
            nl = L.masked_mean(diff, (ang <= 0.1)[..., None])
        nl = nl * lam
        if pred_normal is not None:
            nl = nl + L.l1_loss(pred_normal, gt_normal) * lam
        loss = loss + nl

    return loss + L.scale_flatten_loss(scales, alive)
