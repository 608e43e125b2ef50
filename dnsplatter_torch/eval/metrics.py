"""Metric suite (counterpart of dnsplatter_tpu/eval/metrics.py): PSNR, SSIM
(kernel 11), LPIPS, depth and normal metrics with the reference's
definitions, and point-cloud accuracy / completeness.

LPIPS is a VGG16 feature distance, run as an `nn.Module` on the device of
the images it is given. `default_lpips` takes, in this order:
  1. an .npz of the official VGG16-LPIPS weights (conv{i}_w in HWIO,
     conv{i}_b, lin{j}; the file the JAX package's
     scripts/export_lpips_weights.py writes), found through
     `lpips_weight_search_paths`: $DNSPLATTER_LPIPS_WEIGHTS,
     <repo>/weights/lpips_vgg.npz, ~/.cache/dnsplatter_torch/lpips_vgg.npz;
  2. else a deterministic randomly initialized VGG16 (fixed seed, the same
     numpy draws as the JAX package's). Random-convnet features rank image
     similarity much like trained LPIPS, so it serves relative comparisons,
     but its values are not comparable to published LPIPS tables: the
     evaluator reports which one ran as `lpips_kind`.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from dnsplatter_torch.models.losses import ssim as ssim_fn
from dnsplatter_torch.utils import profiling


def psnr(pred: torch.Tensor, gt: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-12))


def _read(x: torch.Tensor) -> float:
    """A metric's value, read back (`sync.eval`)."""
    return profiling.host_read("eval", float, x)


def rgb_metrics(pred: torch.Tensor, gt: torch.Tensor,
                lpips_fn=None) -> Dict[str, float]:
    """(H, W, 3) images in [0, 1]; LPIPS by `lpips_fn`, else by
    `default_lpips()`."""
    if lpips_fn is None:
        lpips_fn = default_lpips()
    return {
        "psnr": _read(psnr(pred, gt)),
        "ssim": _read(ssim_fn(pred, gt, kernel_size=11)),
        "mse": _read(torch.mean((pred - gt) ** 2)),
        "lpips": _read(lpips_fn(pred, gt)),
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
        "abs_rel": _read(wmean(torch.abs(pred_c - gt_c) / gt_c)),
        "sq_rel": _read(wmean((pred_c - gt_c) ** 2 / gt_c)),
        "rmse": _read(torch.sqrt(wmean((pred_c - gt_c) ** 2))),
        "rmse_log": _read(torch.sqrt(wmean((pred_log - torch.log(gt_c))
                                           ** 2))),
        "a1": _read(wmean((thresh < 1.25).to(torch.float32))),
        "a2": _read(wmean((thresh < 1.25 ** 2).to(torch.float32))),
        "a3": _read(wmean((thresh < 1.25 ** 3).to(torch.float32))),
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


def pd_metrics(pred_points: np.ndarray, gt_points: np.ndarray,
               comp_thresh: float = 0.05) -> Dict[str, float]:
    """Point-cloud accuracy, the 90th percentile of the pred -> gt nearest
    distance, and completeness, the share of gt points with a pred point
    within `comp_thresh`; scipy KD-trees on the host (uncompacted nodes,
    as in eval/icp.py: the same neighbours, found much faster between
    surface-like clouds)."""
    from scipy.spatial import cKDTree

    d_pred_gt, _ = cKDTree(gt_points, compact_nodes=False).query(
        pred_points, k=1, workers=-1)
    d_gt_pred, _ = cKDTree(pred_points, compact_nodes=False).query(
        gt_points, k=1, workers=-1)
    return {"accuracy": float(np.percentile(d_pred_gt, 90)),
            "completeness": float((d_gt_pred < comp_thresh).mean())}


# --------------------------------------------------------------------------
# LPIPS: VGG16 feature distance
# --------------------------------------------------------------------------

_VGG_LAYERS = [2, 2, 3, 3, 3]  # convolutions a block (VGG16)
_VGG_CHANNELS = [64, 128, 256, 512, 512]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def random_vgg_lpips_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """A deterministic He-initialized VGG16 (conv{i}_w HWIO, conv{i}_b) with
    uniform linear heads lin{j}: the JAX package's draws, in its order."""
    rng = np.random.default_rng(seed)
    params = {}
    in_ch = 3
    i = 0
    for block, n_convs in enumerate(_VGG_LAYERS):
        out_ch = _VGG_CHANNELS[block]
        for _ in range(n_convs):
            params[f"conv{i}_w"] = rng.normal(
                0.0, np.sqrt(2.0 / (9 * in_ch)),
                (3, 3, in_ch, out_ch)).astype(np.float32)
            params[f"conv{i}_b"] = np.zeros((out_ch,), np.float32)
            in_ch = out_ch
            i += 1
        params[f"lin{block}"] = np.full((out_ch,), 1.0 / out_ch, np.float32)
    return params


class LPIPS(torch.nn.Module):
    """LPIPS(pred, gt) of two (H, W, 3) images in [0, 1], a 0-d tensor. The
    weights follow the images to their device."""

    def __init__(self, params: Dict[str, np.ndarray]):
        super().__init__()
        n_convs = sum(_VGG_LAYERS)
        # HWIO -> OIHW
        self.weights = torch.nn.ParameterList(
            torch.nn.Parameter(torch.as_tensor(
                np.asarray(params[f"conv{i}_w"], np.float32)).permute(
                    3, 2, 0, 1).contiguous(), requires_grad=False)
            for i in range(n_convs))
        self.biases = torch.nn.ParameterList(
            torch.nn.Parameter(torch.as_tensor(
                np.asarray(params[f"conv{i}_b"], np.float32)),
                requires_grad=False) for i in range(n_convs))
        self.lins = torch.nn.ParameterList(
            torch.nn.Parameter(torch.as_tensor(
                np.asarray(params[f"lin{j}"], np.float32)),
                requires_grad=False) for j in range(len(_VGG_LAYERS)))
        self.register_buffer("shift", torch.as_tensor(_SHIFT))
        self.register_buffer("scale", torch.as_tensor(_SCALE))

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The five block outputs, (1, C, H', W'), of an (H, W, 3) image in
        [-1, 1] (the LPIPS convention)."""
        h = ((x - self.shift) / self.scale).permute(2, 0, 1)[None]
        feats = []
        i = 0
        for block, n_convs in enumerate(_VGG_LAYERS):
            for _ in range(n_convs):
                h = F.relu(F.conv2d(h, self.weights[i], self.biases[i],
                                    padding=1))
                i += 1
            feats.append(h)
            if block < len(_VGG_LAYERS) - 1:
                h = F.max_pool2d(h, 2)  # floor mode: VALID
        return feats

    def forward(self, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        if self.shift.device != pred.device:
            self.to(pred.device)
        with torch.no_grad():
            total = pred.new_zeros(())
            for fa, fb, lin in zip(self.features(pred * 2.0 - 1.0),
                                   self.features(gt * 2.0 - 1.0), self.lins):
                na = fa / torch.linalg.norm(fa, dim=1,
                                            keepdim=True).clamp_min(1e-10)
                nb = fb / torch.linalg.norm(fb, dim=1,
                                            keepdim=True).clamp_min(1e-10)
                d = torch.sum((na - nb) ** 2 * lin[:, None, None], dim=1)
                total = total + d.mean()
        return total


def _lpips_from_params(params: Dict[str, np.ndarray]) -> LPIPS:
    return LPIPS(params)


def lpips_weight_search_paths() -> List[Path]:
    paths = []
    env = os.environ.get("DNSPLATTER_LPIPS_WEIGHTS")
    if env:
        paths.append(Path(env))
    paths.append(Path(__file__).resolve().parents[2] / "weights"
                 / "lpips_vgg.npz")
    paths.append(Path.home() / ".cache" / "dnsplatter_torch"
                 / "lpips_vgg.npz")
    return paths


@functools.lru_cache(maxsize=1)
def _default():
    """(LPIPS module, kind), built once a process."""
    for p in lpips_weight_search_paths():
        if p.exists():
            return lpips_from_npz(p), "vgg16-lpips"
    return (_lpips_from_params(random_vgg_lpips_params()),
            "random-vgg(relative-only)")


def default_lpips() -> LPIPS:
    """The official-weight LPIPS when an npz is found, else the
    deterministic random VGG; which one, `default_lpips_kind()` says."""
    return _default()[0]


def default_lpips_kind() -> str:
    return _default()[1]


def lpips_from_npz(path: Path) -> LPIPS:
    """LPIPS of an .npz of VGG16 weights, conv{i}_w in HWIO as the JAX
    package stores them, conv{i}_b and lin{j} (C,)."""
    with np.load(path) as z:
        return _lpips_from_params({k: z[k] for k in z.files})
