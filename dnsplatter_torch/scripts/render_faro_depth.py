"""Depth maps of a reference (e.g. Faro scanner) mesh along a capture's
cameras, as 16-bit PNGs for `eval/offline.py depth_eval_faro` (counterpart
of dnsplatter_tpu/scripts/render_faro_depth.py), rendered by the port's
z-buffer renderer on `--device` (default: the card); 0 where no surface is
hit.

    python -m dnsplatter_torch.scripts.render_faro_depth --mesh MESH.ply \
        --data DIR --dataparser mushroom
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from dnsplatter_torch.scripts.render_gt_normals import dataset_args, read_mesh


def main(argv=None) -> int:
    from dnsplatter_torch import cli
    from dnsplatter_torch.data import io
    from dnsplatter_torch.eval.mesh_render import render_mesh_depth

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mesh", type=Path, required=True,
                   help="reference mesh .ply")
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, default=None)
    p.add_argument("--depth-unit", type=float, default=1e-3)
    parser_cls = dataset_args(p, argv)
    args = p.parse_args(argv)

    verts, faces = read_mesh(args.mesh)
    data = cli._load_dataset(args, parser_cls, args.split)
    out_dir = args.output_dir or args.data / "reference_depth"
    out_dir.mkdir(parents=True, exist_ok=True)
    for i in range(len(data)):
        depth = render_mesh_depth(verts, faces, data.camera(i),
                                  device=args.device)
        depth = np.where(np.isfinite(depth), depth, 0.0)
        io.write_depth_png(out_dir / f"{i:05d}.png", depth[..., None],
                           unit=args.depth_unit)
    print(f"wrote {len(data)} reference depths to {out_dir}")
    return len(data)


if __name__ == "__main__":
    main()
