"""Offline evaluation over saved render trees (counterpart of
dnsplatter_tpu/eval/offline.py): PSNR / SSIM / LPIPS / MSE over pred and gt
rgb folders, depth metrics over saved .npy depths or against Faro scanner
depth pngs, and the MuSHRoom with / within protocol aggregation (each
metric averaged per protocol and jointly). Metrics run on `device` (None:
the card).

    python -m dnsplatter_torch.eval.offline --renders DIR
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from dnsplatter_torch import resolve_device
from dnsplatter_torch.data import io
from dnsplatter_torch.eval import metrics as M


def rgb_eval(pred_dir: Path, gt_dir: Path, lpips_fn=None,
             device=None) -> Dict[str, float]:
    dev = resolve_device(device)
    rows: List[Dict[str, float]] = []
    for f in sorted(Path(pred_dir).glob("*.png")):
        g = Path(gt_dir) / f.name
        if g.exists():
            rows.append(M.rgb_metrics(
                torch.as_tensor(io.read_image(f), device=dev),
                torch.as_tensor(io.read_image(g), device=dev), lpips_fn))
    return _aggregate(rows)


def depth_eval(pred_dir: Path, gt_dir: Path, device=None
               ) -> Dict[str, float]:
    dev = resolve_device(device)
    rows = []
    for f in sorted(Path(pred_dir).glob("*.npy")):
        g = Path(gt_dir) / f.name
        if g.exists():
            rows.append(M.depth_metrics(
                torch.as_tensor(np.load(f), device=dev),
                torch.as_tensor(np.load(g), device=dev)))
    return _aggregate(rows)


def depth_eval_faro(pred_dir: Path, faro_dir: Path, depth_unit: float = 1e-3,
                    device=None) -> Dict[str, float]:
    """Rendered .npy depths against the Faro scanner's reference pngs."""
    dev = resolve_device(device)
    rows = []
    for f in sorted(Path(pred_dir).glob("*.npy")):
        g = Path(faro_dir) / f"{f.stem}.png"
        if g.exists():
            rows.append(M.depth_metrics(
                torch.as_tensor(np.load(f), device=dev),
                torch.as_tensor(io.read_depth(g, depth_unit), device=dev)))
    return _aggregate(rows)


def _aggregate(rows: List[Dict[str, float]]) -> Dict[str, float]:
    if not rows:
        return {"num_images": 0}
    out: Dict[str, float] = {}
    for k in rows[0]:
        vals = np.array([r[k] for r in rows], np.float64)
        out[k] = float(np.nanmean(vals))
        out[f"{k}_std"] = float(np.nanstd(vals))
    out["num_images"] = len(rows)
    return out


def aggregate_protocols(per_image: List[Dict[str, float]],
                        protocol_labels: List[str]) -> Dict[str, float]:
    """Each metric's mean and std per protocol label ('<label>_<metric>')
    and over all frames."""
    out: Dict[str, float] = {}
    for lab in sorted(set(protocol_labels)):
        rows = [r for r, l in zip(per_image, protocol_labels) if l == lab]
        for k, v in _aggregate(rows).items():
            out[f"{lab}_{k}"] = v
    out.update(_aggregate(per_image))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Offline metrics over saved render trees")
    p.add_argument("--renders", type=Path, required=True,
                   help="dir with pred/ and gt/ subtrees")
    p.add_argument("--lpips-weights", type=Path, default=None)
    p.add_argument("--faro-depths", type=Path, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    lpips_fn = None
    result = {}
    if args.lpips_weights:
        lpips_fn = M.lpips_from_npz(args.lpips_weights)
    else:
        # which LPIPS this is: without weights, the random VGG, good for
        # relative comparisons only
        result["lpips_kind"] = M.default_lpips_kind()
    r = args.renders
    if (r / "pred/rgb").exists():
        result["rgb"] = rgb_eval(r / "pred/rgb", r / "gt/rgb", lpips_fn,
                                 device=args.device)
    if (r / "pred/depth").exists() and (r / "gt/depth").exists():
        result["depth"] = depth_eval(r / "pred/depth", r / "gt/depth",
                                     device=args.device)
    if args.faro_depths:
        result["faro_depth"] = depth_eval_faro(r / "pred/depth",
                                               args.faro_depths,
                                               device=args.device)
    print(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
