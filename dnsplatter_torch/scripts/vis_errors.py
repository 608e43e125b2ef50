"""Error heat maps between rendered and ground-truth images (counterpart of
dnsplatter_tpu/scripts/vis_errors.py): per-pixel |error| of the rgb, normal
and depth renders of an `evaluate` / `cli render` tree, in inferno scaled
to the 99th percentile.

    python -m dnsplatter_torch.scripts.vis_errors --renders RENDERS
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from dnsplatter_torch.utils.colormaps import apply_colormap


def error_heatmap(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    err = np.abs(pred - gt).mean(-1) if pred.ndim == 3 else np.abs(pred - gt)
    hi = max(np.percentile(err, 99), 1e-8)
    return apply_colormap(np.clip(err / hi, 0, 1), "inferno")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--renders", type=Path, required=True,
                   help="evaluate() output dir with pred/ and gt/ trees")
    p.add_argument("--output-dir", type=Path, default=None)
    args = p.parse_args(argv)

    from dnsplatter_torch.data import io

    out_dir = args.output_dir or args.renders / "errors"
    out_dir.mkdir(parents=True, exist_ok=True)
    written = 0
    for kind in ("rgb", "normal"):
        pred_dir = args.renders / "pred" / kind
        gt_dir = args.renders / "gt" / kind
        if not pred_dir.exists() or not gt_dir.exists():
            continue
        for f in sorted(pred_dir.glob("*.png")):
            g = gt_dir / f.name
            if not g.exists():
                continue
            io.write_image(out_dir / f"{kind}_{f.name}",
                           error_heatmap(io.read_image(f), io.read_image(g)))
            written += 1
    pred_dir = args.renders / "pred" / "depth"
    gt_dir = args.renders / "gt" / "depth"
    if pred_dir.exists() and gt_dir.exists():
        for f in sorted(pred_dir.glob("*.npy")):
            g = gt_dir / f.name
            if not g.exists():
                continue
            io.write_image(out_dir / f"depth_{f.stem}.png",
                           error_heatmap(np.load(f)[..., 0],
                                         np.load(g)[..., 0]))
            written += 1
    print(f"error maps in {out_dir}")
    return written


if __name__ == "__main__":
    main()
