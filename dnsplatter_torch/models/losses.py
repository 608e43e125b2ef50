"""Loss library (counterpart of dnsplatter_tpu/models/losses.py), the same
mask-based formulations: `x[mask].mean()` is a masked mean, so shapes do
not depend on the data.

Losses:
  depth:  mse, l1, log_l1, huber_l1, tv, edge_aware_log_l1, edge_aware_tv,
          pearson, local_pearson, adaptive (confidence-gated)
  rgb:    l1 + dssim (the splatfacto main loss), per-pixel dssim_l1
  normal: l1, tv smoothness, cosine, adaptive (angular-confidence gated)

Blurs and box filters are weighted sums of shifted slices in plain
float32: no cuDNN convolution, which would run in TF32 by default on the
card. Where the JAX package clamps a differentiable value with
`jnp.maximum`, this uses `torch.maximum`, whose gradient also splits
evenly at a tie (`clamp_min` would pass it whole); reductions that can tie
(`min` over the three scales at init) use `amin` / `amax` for the same
reason.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dnsplatter_torch.ops import rasterize_cuda


def _const(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor],
                eps: float = 1e-10) -> torch.Tensor:
    """Mean of x over the elements where mask is true (broadcast over
    channels); a plain mean without a mask."""
    if mask is None:
        return torch.mean(x)
    mask = torch.broadcast_to(mask, x.shape).to(x.dtype)
    return torch.sum(x * mask) / torch.clamp_min(torch.sum(mask), eps)


def image_gradient_weights(rgb: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """exp(-|grad rgb|) edge weights in x and y of an (H, W, 3) image:
    ((H, W-1, 1), (H-1, W, 1))."""
    grad_x = torch.mean(torch.abs(rgb[:, :-1, :] - rgb[:, 1:, :]), -1,
                        keepdim=True)
    grad_y = torch.mean(torch.abs(rgb[:-1, :, :] - rgb[1:, :, :]), -1,
                        keepdim=True)
    return torch.exp(-grad_x), torch.exp(-grad_y)


# ---------------------------------------------------------------------------
# depth losses
# ---------------------------------------------------------------------------


def mse_loss(pred, gt, mask=None):
    return masked_mean((pred - gt) ** 2, mask)


def l1_loss(pred, gt, mask=None):
    return masked_mean(torch.abs(pred - gt), mask)


def log_l1_loss(pred, gt, mask=None):
    """log(1 + |pred - gt|)."""
    return masked_mean(torch.log1p(torch.abs(pred - gt)), mask)


def edge_aware_log_l1_loss(pred, gt, rgb, mask=None):
    """Image-gradient-weighted LogL1 (the DN-Splatter default depth loss):
    per-pixel log-L1 weighted by exp(-|grad I|) along x and y, masked, each
    term mean-reduced. pred/gt (H, W, 1), rgb (H, W, 3), mask (H, W, 1)."""
    logl1 = torch.log1p(torch.abs(pred - gt))
    lambda_x, lambda_y = image_gradient_weights(rgb)
    loss_x = lambda_x * logl1[:, :-1, :]
    loss_y = lambda_y * logl1[:-1, :, :]
    mask_x = mask[:, :-1, :] if mask is not None else None
    mask_y = mask[:-1, :, :] if mask is not None else None
    return masked_mean(loss_x, mask_x) + masked_mean(loss_y, mask_y)


def huber_l1_loss(pred, gt, mask=None, tresh: float = 0.2):
    """Huber with the data-dependent knee d = tresh * max|err| over valid
    gt (default mask: gt != 0); mean over the masked elements."""
    if mask is None:
        mask = gt != 0
    l1 = torch.abs(pred - gt)
    d = tresh * torch.amax(torch.where(torch.broadcast_to(mask, l1.shape),
                                       l1, 0.0))
    loss = torch.where(l1 < d, ((pred - gt) ** 2 + d * d) / (2.0 * d + 1e-12),
                       l1)
    return masked_mean(loss, mask)


def tv_loss(pred):
    """Total variation of an (H, W, C) map."""
    h_diff = pred[:, :-1, :] - pred[:, 1:, :]
    w_diff = pred[:-1, :, :] - pred[1:, :, :]
    return torch.mean(torch.abs(h_diff)) + torch.mean(torch.abs(w_diff))


def edge_aware_tv_loss(depth, rgb):
    """TV on depth, downweighted at image edges."""
    grad_x = torch.abs(depth[:, :-1, :] - depth[:, 1:, :])
    grad_y = torch.abs(depth[:-1, :, :] - depth[1:, :, :])
    lambda_x, lambda_y = image_gradient_weights(rgb)
    return torch.mean(grad_x * lambda_x) + torch.mean(grad_y * lambda_y)


def pearson_depth_loss(pred, gt):
    """1 - Pearson correlation (scale/shift-invariant depth loss);
    population standard deviations."""
    src = pred - torch.mean(pred)
    tgt = gt - torch.mean(gt)
    src = src / (torch.std(src, unbiased=False) + 1e-6)
    tgt = tgt / (torch.std(tgt, unbiased=False) + 1e-6)
    return 1.0 - torch.mean(src * tgt)


def local_pearson_boxes(h: int, w: int, box_p: int = 128,
                        p_corr: float = 0.5) -> Tuple[int, int]:
    """(box size, number of boxes) `local_pearson_depth_loss` uses on an
    (h, w) map: the box shrinks to a small image."""
    box_p = min(box_p, h, w)
    return box_p, max(1, int(p_corr * (h // box_p) * (w // box_p)))


def local_pearson_depth_loss(pred, gt, corners=None,
                             generator: Optional[torch.Generator] = None,
                             box_p: int = 128, p_corr: float = 0.5):
    """Pearson loss averaged over random square patches (SparseGS-style).
    `corners` = (x0, y0) integer sequences, x0 along H in
    [0, max(1, H - box)) and y0 along W, one per box (see
    `local_pearson_boxes`); without them they are drawn from `generator`.
    pred/gt: (H, W) or (H, W, 1)."""
    if pred.ndim == 3:
        pred = pred[..., 0]
    if gt.ndim == 3:
        gt = gt[..., 0]
    h, w = pred.shape
    box_p, n_corr = local_pearson_boxes(h, w, box_p, p_corr)
    if corners is None:
        x0 = torch.randint(0, max(1, h - box_p), (n_corr,),
                           generator=generator, device="cpu")
        y0 = torch.randint(0, max(1, w - box_p), (n_corr,),
                           generator=generator, device="cpu")
    else:
        x0, y0 = corners
    x0 = np.asarray(x0).reshape(-1)
    y0 = np.asarray(y0).reshape(-1)
    if x0.shape[0] != n_corr or y0.shape[0] != n_corr:
        raise ValueError(f"local_pearson_depth_loss needs {n_corr} corners")
    return torch.mean(torch.stack([
        pearson_depth_loss(pred[x:x + box_p, y:y + box_p],
                           gt[x:x + box_p, y:y + box_p])
        for x, y in zip(x0.tolist(), y0.tolist())]))


def adaptive_depth_loss(pred, gt, rgb, mask, confidence, step: int,
                        gate_step: int = 7000):
    """AGS-Mesh confidence-gated EdgeAwareLogL1: plain before `gate_step`;
    from it on gt is zeroed where the confidence rejects it and the
    validity mask becomes gt > 0.1."""
    if int(step) >= gate_step:
        gt = torch.where(confidence > 0, gt, 0.0)
        mask = gt > 0.1
    return edge_aware_log_l1_loss(pred, gt, rgb, mask)


# ---------------------------------------------------------------------------
# rgb losses (splatfacto main loss)
# ---------------------------------------------------------------------------


def _gaussian_window(kernel_size: int, sigma: float,
                     device=None) -> torch.Tensor:
    x = (torch.arange(kernel_size, dtype=torch.float32, device=device)
         - (kernel_size - 1) / 2.0)
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _blur(t: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable VALID blur of (..., H, W) as weighted sums of shifted
    slices: plain float32 arithmetic, so no cuDNN convolution (which would
    run in TF32 by default on the card) decides the metric's precision."""
    k = win.shape[0]
    h, w = t.shape[-2], t.shape[-1]
    rows = sum(win[i] * t[..., i:i + h - k + 1, :] for i in range(k))
    return sum(win[i] * rows[..., i:i + w - k + 1] for i in range(k))


def ssim_map_plain(img1: torch.Tensor, img2: torch.Tensor,
                   kernel_size: int = 11, sigma: float = 1.5,
                   data_range: float = 1.0) -> torch.Tensor:
    """Per-pixel gaussian-windowed SSIM of two (H, W, C) images, planar
    (C, H - kernel_size + 1, W - kernel_size + 1)."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    win = _gaussian_window(kernel_size, sigma, device=img1.device)
    x = img1.permute(2, 0, 1)
    y = img2.permute(2, 0, 1)
    mu_x = _blur(x, win)
    mu_y = _blur(y, win)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    # variances clamp at 0 against f32 cancellation, as in the JAX package
    zero = _const(x, 0.0)
    sigma_x = torch.maximum(_blur(x * x, win) - mu_xx, zero)
    sigma_y = torch.maximum(_blur(y * y, win) - mu_yy, zero)
    sigma_xy = _blur(x * y, win) - mu_xy
    num = (2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2)
    return num / den


def ssim_plain(img1: torch.Tensor, img2: torch.Tensor, kernel_size: int = 11,
               sigma: float = 1.5, data_range: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of `ssim` (any device): the mean of
    `ssim_map_plain`."""
    return torch.mean(ssim_map_plain(img1, img2, kernel_size, sigma,
                                     data_range))


def ssim(img1: torch.Tensor, img2: torch.Tensor, kernel_size: int = 11,
         sigma: float = 1.5, data_range: float = 1.0) -> torch.Tensor:
    """Mean gaussian-windowed SSIM of two (H, W, C) images in [0, 1]
    (torchmetrics defaults, as the JAX package).

    On the card the kernel pair of csrc/ssim.cu computes it, differentiable
    in img1 (`rasterize_cuda.ssim`: the same per-pixel SSIM bit for bit, its
    mean summed in float64; it raises for images it cannot take); CPU
    tensors run `ssim_plain`, differentiable in both.
    """
    if not rasterize_cuda._route(img1, "ssim"):
        return ssim_plain(img1, img2, kernel_size, sigma, data_range)
    return rasterize_cuda.ssim(
        img1, img2, _gaussian_window(kernel_size, sigma, device=img1.device),
        (0.01 * data_range) ** 2, (0.03 * data_range) ** 2)


def rgb_main_loss(pred, gt, ssim_lambda: float = 0.2):
    """Splatfacto's main photometric loss:
    (1 - lambda) * L1 + lambda * (1 - SSIM)."""
    l1 = torch.mean(torch.abs(gt - pred))
    return (1.0 - ssim_lambda) * l1 + ssim_lambda * (1.0 - ssim(pred, gt))


def _boxfilter(t: torch.Tensor, k: int) -> torch.Tensor:
    """VALID k x k mean filter of an (H, W, C) map, as shifted sums."""
    h, w = t.shape[0] - k + 1, t.shape[1] - k + 1
    rows = sum(t[i:i + h] for i in range(k))
    return sum(rows[:, j:j + w] for j in range(k)) / float(k * k)


def dssim_l1_per_pixel(pred, gt, kernel_size: int = 3, alpha: float = 0.85):
    """Per-pixel DSSIM + L1 (monodepth-style) of (H, W, C) images, with
    reflect padding and box windows. Returns (H, W, 1)."""
    pad = (kernel_size - 1) // 2

    def reflect(t):
        t = F.pad(t.permute(2, 0, 1)[None], (pad, pad, pad, pad),
                  mode="reflect")
        return t[0].permute(1, 2, 0)

    x = reflect(pred)
    y = reflect(gt)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_x = _boxfilter(x, kernel_size)
    mu_y = _boxfilter(y, kernel_size)
    zero = _const(x, 0.0)
    sigma_x = torch.maximum(_boxfilter(x * x, kernel_size) - mu_x ** 2, zero)
    sigma_y = torch.maximum(_boxfilter(y * y, kernel_size) - mu_y ** 2, zero)
    sigma_xy = _boxfilter(x * y, kernel_size) - mu_x * mu_y
    ssim_n = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    ssim_d = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    dssim = torch.clamp((1.0 - ssim_n / ssim_d) / 2.0, 0.0, 1.0)
    dssim = torch.mean(dssim, dim=-1, keepdim=True)
    l1 = torch.mean(torch.abs(pred - gt), dim=-1, keepdim=True)
    return alpha * dssim + (1.0 - alpha) * l1


# ---------------------------------------------------------------------------
# normal losses
# ---------------------------------------------------------------------------


def normal_l1_loss(pred, gt, mask=None):
    return masked_mean(torch.abs(pred - gt), mask)


def normal_tv_loss(pred):
    """Smoothness prior on the predicted normal map."""
    return tv_loss(pred)


def normal_cosine_loss(pred, gt, mask=None):
    """1 - cos(pred, gt) for normal maps in [-1, 1] vector space."""
    cos = torch.sum(pred * gt, dim=-1, keepdim=True)
    return masked_mean(1.0 - cos, mask)


def mean_angular_error_map(pred: torch.Tensor, gt: torch.Tensor
                           ) -> torch.Tensor:
    """Per-pixel angular error (radians) between (H, W, 3) normal maps in
    [-1, 1]."""
    dots = torch.clamp(torch.sum(pred * gt, dim=-1), -1.0, 1.0)
    return torch.arccos(dots)


def adaptive_normal_loss(pred, gt, step: int, gate_step: int = 15000,
                         thresh: float = 0.1):
    """AGS-Mesh adaptive normal loss: plain L1 before `gate_step`, then L1
    restricted to pixels whose angular error is <= thresh (maps in
    [-1, 1])."""
    if int(step) >= gate_step:
        with torch.no_grad():
            conf = (mean_angular_error_map(pred, gt) <= thresh)[..., None]
        return masked_mean(torch.abs(pred - gt), conf)
    return l1_loss(pred, gt)


# ---------------------------------------------------------------------------
# gaussian-state regularizers
# ---------------------------------------------------------------------------


def scale_flatten_loss(scales_log, alive_mask=None):
    """mean(min_i exp(scale_i)): drives Gaussians flat."""
    min_scale = torch.amin(torch.exp(scales_log), dim=-1)
    return masked_mean(min_scale, alive_mask)


def physgauss_scale_reg(scales_log, alive_mask=None,
                        max_gauss_ratio: float = 10.0):
    """Splatfacto's optional anisotropy penalty:
    0.1 * mean(max(smax / smin, ratio) - ratio)."""
    s = torch.exp(scales_log)
    ratio = torch.amax(s, dim=-1) / torch.maximum(torch.amin(s, dim=-1),
                                                  _const(s, 1e-12))
    pen = torch.maximum(ratio, _const(s, max_gauss_ratio)) - max_gauss_ratio
    return 0.1 * masked_mean(pen, alive_mask)


def sparse_opacity_loss(opacities_logit, alive_mask=None):
    """Neural-Volumes sparsity prior pushing opacities to {0, 1}:
    mean(-(log o + log(1 - o))) on sigmoided opacities."""
    o = torch.clamp(torch.sigmoid(opacities_logit), 1e-6, 1.0 - 1e-6)
    return masked_mean(-(torch.log(o) + torch.log(1.0 - o)), alive_mask)
