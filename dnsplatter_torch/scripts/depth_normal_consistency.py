"""Depth <-> normal consistency masks, the AGS-Mesh confidence input
(counterpart of dnsplatter_tpu/scripts/depth_normal_consistency.py).

Sensor depth is smoothed, turned into normals by the depth-gradient cross
product, oriented toward the camera and compared with a monocular normal
map; the mask is 255 where the two disagree by more than a threshold
angle, 0 elsewhere. The per-pixel work runs on `device` (None: the card).

    python -m dnsplatter_torch.scripts.depth_normal_consistency \
        --data CAPTURE --fx FX --fy FY --cx CX --cy CY
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from dnsplatter_torch import resolve_device
from dnsplatter_torch.ops.normals import normal_from_depth_image


def consistency_mask(sensor_depth: np.ndarray, mono_normal01: np.ndarray,
                     fx: float, fy: float, cx: float, cy: float,
                     angle_thresh_deg: float = 20.0, smooth: int = 3,
                     device=None) -> np.ndarray:
    """(H, W) uint8 mask, 255 where a metric (H, W[, 1]) depth and an
    (H, W, 3) normal map in [0, 1] (OpenCV camera frame) disagree."""
    dev = resolve_device(device)
    d0 = np.asarray(sensor_depth)
    d0 = torch.as_tensor(d0[..., 0] if d0.ndim == 3 else d0,
                         dtype=torch.float32, device=dev)
    d = d0
    if smooth > 1:
        k = torch.full((1, 1, smooth, smooth), 1.0 / (smooth * smooth),
                       device=dev)
        d = F.conv2d(d[None, None], k, padding="same")[0, 0]
    n_depth = normal_from_depth_image(d, fx, fy, cx, cy)
    # face the camera: it looks down +z in the OpenCV frame
    n_depth = n_depth * torch.where(n_depth[..., 2:3] > 0, -1.0, 1.0)
    n_mono = 2.0 * torch.as_tensor(np.asarray(mono_normal01),
                                   dtype=torch.float32, device=dev) - 1.0
    n_mono = n_mono / torch.linalg.norm(n_mono, dim=-1,
                                        keepdim=True).clamp_min(1e-8)
    dots = torch.clamp(torch.sum(n_depth * n_mono, dim=-1), -1.0, 1.0)
    ang = torch.rad2deg(torch.arccos(dots))
    valid = (d0 > 0) & (torch.linalg.norm(n_depth, dim=-1) > 0.5)
    bad = (ang > angle_thresh_deg) & valid
    return (bad.to(torch.uint8) * 255).cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--depth-dir", type=Path, default=None)
    p.add_argument("--normal-dir", type=Path, default=None)
    p.add_argument("--output-dir", type=Path, default=None)
    p.add_argument("--fx", type=float, required=True)
    p.add_argument("--fy", type=float, required=True)
    p.add_argument("--cx", type=float, required=True)
    p.add_argument("--cy", type=float, required=True)
    p.add_argument("--depth-unit", type=float, default=1e-3)
    p.add_argument("--angle-thresh", type=float, default=20.0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    from dnsplatter_torch.data import io

    depth_dir = args.depth_dir or args.data / "depth"
    normal_dir = args.normal_dir or args.data / "normals_from_pretrain"
    out_dir = args.output_dir or args.data / "depth_normals_mask"
    out_dir.mkdir(parents=True, exist_ok=True)
    depths = sorted(depth_dir.glob("*"))
    for dp, npth in zip(depths, sorted(normal_dir.glob("*"))):
        mask = consistency_mask(io.read_depth(dp, args.depth_unit),
                                io.read_normal(npth, format="omnidata"),
                                args.fx, args.fy, args.cx, args.cy,
                                args.angle_thresh, device=args.device)
        io.write_image(out_dir / f"{dp.stem}.png", mask[..., None] / 255.0)
    print(f"wrote {len(depths)} masks to {out_dir}")


if __name__ == "__main__":
    main()
