"""Image losses the metrics need (counterpart of the SSIM part of
dnsplatter_tpu/models/losses.py). The training losses come with the
training slice."""

from __future__ import annotations

import torch


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


def ssim(img1: torch.Tensor, img2: torch.Tensor, kernel_size: int = 11,
         sigma: float = 1.5, data_range: float = 1.0) -> torch.Tensor:
    """Mean gaussian-windowed SSIM of two (H, W, C) images in [0, 1]
    (torchmetrics defaults, as the JAX package)."""
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
    sigma_x = torch.clamp_min(_blur(x * x, win) - mu_xx, 0.0)
    sigma_y = torch.clamp_min(_blur(y * y, win) - mu_yy, 0.0)
    sigma_xy = _blur(x * y, win) - mu_xy
    num = (2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2)
    return torch.mean(num / den)
