"""Normal-map priors from sensor depths (counterpart of
dnsplatter_tpu/scripts/normals_from_depth.py): backproject each depth,
take cross-product normals, orient them toward the camera, and save them in
the omnidata png convention the dataparsers read. The per-pixel work runs
on `device` (None: the card).

    python -m dnsplatter_torch.scripts.normals_from_depth \
        --data CAPTURE --fx FX --fy FY --cx CX --cy CY
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from dnsplatter_torch import resolve_device
from dnsplatter_torch.ops.normals import normal_from_depth_image


def normal_image_from_depth(depth: np.ndarray, fx: float, fy: float,
                            cx: float, cy: float, device=None) -> np.ndarray:
    """(H, W, 3) normals in [0, 1], omnidata convention, of an (H, W[, 1])
    z-depth."""
    d = depth[..., 0] if depth.ndim == 3 else depth
    n = normal_from_depth_image(
        torch.as_tensor(d, dtype=torch.float32, device=resolve_device(device)),
        fx, fy, cx, cy).cpu().numpy()
    # face the camera (it looks down +z in the OpenCV frame), then apply the
    # omnidata OpenGL flip that io.read_normal undoes
    n = n * np.where(n[..., 2:3] > 0, -1.0, 1.0)
    n = n * np.array([1.0, -1.0, -1.0])
    return (n + 1.0) * 0.5


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--depth-dir", type=Path, default=None)
    p.add_argument("--output-dir", type=Path, default=None)
    p.add_argument("--fx", type=float, required=True)
    p.add_argument("--fy", type=float, required=True)
    p.add_argument("--cx", type=float, required=True)
    p.add_argument("--cy", type=float, required=True)
    p.add_argument("--depth-unit", type=float, default=1e-3)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    from dnsplatter_torch.data import io

    depth_dir = args.depth_dir or args.data / "depth"
    out_dir = args.output_dir or args.data / "normals_from_pretrain"
    out_dir.mkdir(parents=True, exist_ok=True)
    count = 0
    for f in sorted(depth_dir.glob("*")):
        if f.suffix not in (".png", ".npy"):
            continue
        img = normal_image_from_depth(io.read_depth(f, args.depth_unit),
                                      args.fx, args.fy, args.cx, args.cy,
                                      device=args.device)
        io.write_image(out_dir / f"{f.stem}.png", img)
        count += 1
    print(f"wrote {count} normal maps to {out_dir}")


if __name__ == "__main__":
    main()
