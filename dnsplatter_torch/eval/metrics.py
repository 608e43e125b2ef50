"""Metric suite (counterpart of dnsplatter_tpu/eval/metrics.py): PSNR, SSIM
(kernel 11), depth and normal metrics with the reference's definitions.

LPIPS (the VGG network and its offline npz weights) is not ported yet
(ROADMAP.md queue A item 7): `rgb_metrics` uses an `lpips_fn` when one is
passed and otherwise reports `lpips: NaN`, and the evaluator labels that
with `lpips_kind: "not_ported"`.
"""

from __future__ import annotations

from typing import Dict

import torch

from dnsplatter_torch.models.losses import ssim as ssim_fn

LPIPS_NOT_PORTED = "not_ported"


def psnr(pred: torch.Tensor, gt: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-12))


def rgb_metrics(pred: torch.Tensor, gt: torch.Tensor,
                lpips_fn=None) -> Dict[str, float]:
    """(H, W, 3) images in [0, 1]."""
    return {
        "psnr": float(psnr(pred, gt)),
        "ssim": float(ssim_fn(pred, gt, kernel_size=11)),
        "mse": float(torch.mean((pred - gt) ** 2)),
        "lpips": float(lpips_fn(pred, gt)) if lpips_fn else float("nan"),
    }


def depth_metrics(pred: torch.Tensor, gt: torch.Tensor,
                  mask_thresh: float = 0.1) -> Dict[str, float]:
    """(H, W, 1) depths; gt <= `mask_thresh` is masked out."""
    pred = pred.reshape(-1)
    gt = gt.reshape(-1)
    mask = gt > mask_thresh
    w = mask.to(torch.float32)
    n = torch.clamp_min(w.sum(), 1.0)

    def wmean(x):
        return torch.sum(x * w) / n

    pred_c = torch.where(mask, pred, 1.0)
    gt_c = torch.where(mask, gt, 1.0)
    thresh = torch.maximum(pred_c / gt_c, gt_c / pred_c)
    pred_log = torch.log(torch.clamp_min(pred_c, 1e-6))
    return {
        "abs_rel": float(wmean(torch.abs(pred_c - gt_c) / gt_c)),
        "sq_rel": float(wmean((pred_c - gt_c) ** 2 / gt_c)),
        "rmse": float(torch.sqrt(wmean((pred_c - gt_c) ** 2))),
        "rmse_log": float(torch.sqrt(wmean((pred_log - torch.log(gt_c))
                                           ** 2))),
        "a1": float(wmean((thresh < 1.25).to(torch.float32))),
        "a2": float(wmean((thresh < 1.25 ** 2).to(torch.float32))),
        "a3": float(wmean((thresh < 1.25 ** 3).to(torch.float32))),
    }


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median with the mean of the two middle values for an even count."""
    s = torch.sort(x.reshape(-1)).values
    m = s.shape[0] // 2
    return s[m] if s.shape[0] % 2 else 0.5 * (s[m - 1] + s[m])


def normal_metrics(pred: torch.Tensor, gt: torch.Tensor) -> Dict[str, float]:
    """(H, W, 3) normal maps in the [0, 1] encoding, as the reference
    computes them: mae is the arccos of the clamped dot of the encoded
    vectors; rmse/mean/median are statistics of (gt - pred)."""
    dots = torch.clamp(torch.sum(pred * gt, dim=-1), -1.0, 1.0)
    diff = gt - pred
    return {
        "mae": float(torch.mean(torch.arccos(dots))),
        "rmse": float(torch.sqrt(torch.mean(diff ** 2))),
        "mean_err": float(torch.mean(torch.abs(diff))),
        "median_err": float(_median(torch.abs(diff))),
    }
