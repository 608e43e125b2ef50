"""Ground-truth normal maps of a mesh along a capture's cameras
(counterpart of dnsplatter_tpu/scripts/render_gt_normals.py): the port's
z-buffer renderer (eval/mesh_render.py, on `--device`, default the card)
interpolates area-weighted vertex normals; maps are written in the [0, 1]
encoding ((n + 1) / 2), in the OpenCV camera frame facing the viewer by
default (`--frame world` keeps the mesh frame), named by each frame's image
stem, zero where no surface is hit.

    python -m dnsplatter_torch.scripts.render_gt_normals --mesh MESH.ply \
        --data DIR --dataparser mushroom
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def dataset_args(p: argparse.ArgumentParser, argv):
    """--dataparser / --split / --device and the parser's own flags, as the
    CLI's commands take them; returns the parser's config class."""
    from dnsplatter_torch import cli

    p.add_argument("--dataparser", default="mushroom")
    p.add_argument("--split", default="train")
    cli._add_device_arg(p)
    return cli._add_parser_args(p, argv)


def read_mesh(path: Path):
    from dnsplatter_torch.data import io

    mesh = io.read_ply(path)
    if mesh.get("faces") is None:
        raise SystemExit(f"{path} has no faces (point cloud?)")
    return np.asarray(mesh["points"], np.float64), mesh["faces"]


def main(argv=None) -> int:
    from dnsplatter_torch import cli
    from dnsplatter_torch.data import io
    from dnsplatter_torch.eval.mesh_render import (
        render_mesh_attributes,
        vertex_normals,
    )

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mesh", type=Path, required=True)
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, default=None)
    p.add_argument("--frame", choices=("camera", "world"), default="camera")
    p.add_argument("--icp-json", type=Path, default=None,
                   help="apply inv(gt_transformation) to the mesh first "
                        "(the Faro script's alignment step)")
    parser_cls = dataset_args(p, argv)
    args = p.parse_args(argv)

    verts, faces = read_mesh(args.mesh)
    if args.icp_json is not None:
        from dnsplatter_torch.eval.icp import load_icp_json

        t = np.linalg.inv(load_icp_json(args.icp_json))
        verts = verts @ t[:3, :3].T + t[:3, 3]
    vn = vertex_normals(verts, faces)
    data = cli._load_dataset(args, parser_cls, args.split)
    out_dir = args.output_dir or args.data / "reference_normal"
    out_dir.mkdir(parents=True, exist_ok=True)
    for i in range(len(data)):
        cam = data.camera(i)
        depth, nmap = render_mesh_attributes(verts, faces, vn, cam,
                                             device=args.device)
        hit = np.isfinite(depth)
        nmap = nmap / np.maximum(np.linalg.norm(nmap, axis=-1,
                                                keepdims=True), 1e-9)
        if args.frame == "camera":
            # world -> OpenCV camera frame, facing the viewer (+z looks away)
            c2w_cv = (cam.c2w.cpu().numpy().astype(np.float64)
                      @ np.diag([1.0, -1.0, -1.0, 1.0]))
            nmap = nmap @ c2w_cv[:3, :3]
            nmap = nmap * np.where(nmap[..., 2:3] > 0, -1.0, 1.0)
        enc = np.where(hit[..., None], (nmap + 1.0) * 0.5, 0.0)
        io.write_image(out_dir / f"{Path(data.frames[i].image_path).stem}.png",
                       enc)
    print(f"wrote {len(data)} normal maps to {out_dir}")
    return len(data)


if __name__ == "__main__":
    main()
