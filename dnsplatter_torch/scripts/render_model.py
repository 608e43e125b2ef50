"""Render a trained model over a dataset split to disk (counterpart of
dnsplatter_tpu/scripts/render_model.py, and `cli render`): pred / gt trees
of rgb, depth (raw npy) and normals from `evaluate(..., save_renders=True)`,
plus colormapped depths, on `--device` (default: the card).

    python -m dnsplatter_torch.cli render --checkpoint RUN/ckpt_030000.npz \
        --dataparser mushroom --data DIR --output-dir RENDERS \
        --pair-capacity 6000000

`--pair-capacity` sizes the renders' pair lists as in `cli eval`: a frame of
a million Gaussians at 1024x576 lists about 5.9M pairs, beyond the default
2^21, and an overflowing list drops whole Gaussians.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from dnsplatter_torch.utils.colormaps import apply_colormap


def colormap_depth(depth: np.ndarray, near=None, far=None) -> np.ndarray:
    """Viridis of the depth between its 2nd and 98th percentiles of the
    positive values (or `near` / `far`)."""
    d = depth[..., 0] if depth.ndim == 3 else depth
    pos = d[d > 0]
    lo = near if near is not None else (np.percentile(pos, 2) if pos.size
                                        else 0)
    hi = far if far is not None else (np.percentile(pos, 98) if pos.size
                                      else 1)
    return apply_colormap(np.clip((d - lo) / max(hi - lo, 1e-8), 0, 1),
                          "viridis")


def main(argv=None):
    from dnsplatter_torch import cli
    from dnsplatter_torch.configs import model_config_for_method
    from dnsplatter_torch.data import io
    from dnsplatter_torch.eval.evaluator import evaluate
    from dnsplatter_torch.train.trainer import load_checkpoint_arrays

    p = argparse.ArgumentParser(prog="render")
    p.add_argument("--checkpoint", type=Path, required=True)
    p.add_argument("--dataparser", default="normal-nerfstudio")
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--method", default="dn-splatter")
    p.add_argument("--pair-capacity", type=int, default=1 << 21,
                   help="intersection-list capacity for the renders")
    cli._add_device_arg(p)
    parser_cls = cli._add_parser_args(p, argv)
    args = p.parse_args(argv)

    params, alive, _ = load_checkpoint_arrays(args.checkpoint,
                                              device=args.device)
    data = cli._load_dataset(args, parser_cls, args.split)
    metrics = evaluate(params, alive, data,
                       model_cfg=model_config_for_method(args.method),
                       pair_capacity=args.pair_capacity,
                       output_dir=args.output_dir, save_renders=True,
                       device=args.device)
    vis_dir = args.output_dir / "pred/depth_colormaps"
    vis_dir.mkdir(parents=True, exist_ok=True)
    for f in sorted((args.output_dir / "pred/depth").glob("*.npy")):
        io.write_image(vis_dir / f"{f.stem}.png", colormap_depth(np.load(f)))
    print(f"renders written to {args.output_dir}")
    return metrics


if __name__ == "__main__":
    main()
