"""Export known poses (transforms.json) to a COLMAP sparse model and
triangulate an SfM point cloud against it (counterpart of
dnsplatter_tpu/scripts/poses_to_colmap_sfm.py).

Writes a manual sparse model (cameras.txt, images.txt, an empty
points3D.txt) from the nerfstudio poses, then runs the external colmap
binary's feature_extractor + exhaustive_matcher + point_triangulator with
the known poses fixed, giving a seed cloud for datasets that ship poses
but no reconstruction.

Conventions: nerfstudio stores OpenGL c2w, optionally pre-rotated by the
"applied_transform" that maps the COLMAP world to nerfstudio's (+z up);
`assume_colmap_world_coordinate_convention` undoes that (swap y/z, flip)
as the reference does.

    python -m dnsplatter_torch.scripts.poses_to_colmap_sfm \
        --transforms DIR/transforms.json [--run-colmap]
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np

from dnsplatter_torch.data.colmap_utils import rotmat_to_qvec


def write_sparse_model(
    transforms_path: Path,
    sparse_dir: Path | None = None,
    assume_colmap_world_coordinate_convention: bool = True,
    camera_model: str | None = None,
) -> Path:
    """Write cameras.txt/images.txt/points3D.txt from transforms.json."""
    data = json.loads(Path(transforms_path).read_text())
    base = Path(transforms_path).parent
    sparse_dir = sparse_dir or base / "sparse" / "0"
    sparse_dir.mkdir(parents=True, exist_ok=True)
    (sparse_dir / "points3D.txt").write_text("")
    camera_model = camera_model or data.get("camera_model", "OPENCV")

    cam_lines = ["# Camera list with one line of data per camera:",
                 "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]"]
    per_frame_cams = "fl_x" not in data
    if not per_frame_cams:
        cam_lines.append("# Number of cameras: 1")
        cam_lines.append(
            f"1 {camera_model} {data['w']} {data['h']} {data['fl_x']} "
            f"{data['fl_y']} {data['cx']} {data['cy']} 0 0 0 0"
        )
    else:
        cam_lines.append(f"# Number of cameras: {len(data['frames'])}")
        for i, fr in enumerate(data["frames"]):
            cam_lines.append(
                f"{i + 1} {camera_model} {fr['w']} {fr['h']} {fr['fl_x']} "
                f"{fr['fl_y']} {fr['cx']} {fr['cy']} 0 0 0 0"
            )
    (sparse_dir / "cameras.txt").write_text("\n".join(cam_lines) + "\n")

    img_lines = []
    for i, fr in enumerate(data["frames"]):
        c2w = np.array(fr["transform_matrix"], np.float64)
        if c2w.shape == (3, 4):
            c2w = np.concatenate([c2w, [[0, 0, 0, 1]]], 0)
        if assume_colmap_world_coordinate_convention:
            c2w = c2w.copy()
            c2w[2, :] *= -1
            c2w = c2w[np.array([0, 2, 1, 3]), :]
        c2w[0:3, 1:3] *= -1  # OpenGL -> OpenCV camera axes
        w2c = np.linalg.inv(c2w)
        qvec = rotmat_to_qvec(w2c[:3, :3])
        t = w2c[:3, 3]
        cam_id = i + 1 if per_frame_cams else 1
        name = Path(fr["file_path"]).name
        img_lines.append(
            f"{i + 1} " + " ".join(f"{v:.17g}" for v in qvec) + " "
            + " ".join(f"{v:.17g}" for v in t) + f" {cam_id} {name}"
        )
        img_lines.append("")  # empty POINTS2D line
    (sparse_dir / "images.txt").write_text("\n".join(img_lines) + "\n")
    return sparse_dir


def run_colmap_triangulation(base_dir: Path, sparse_dir: Path,
                             image_path: str = "images",
                             camera_model: str = "OPENCV") -> None:
    """feature_extractor + exhaustive_matcher + point_triangulator with
    the known-pose sparse model fixed."""
    if shutil.which("colmap") is None:
        raise SystemExit(
            "colmap binary not found — the sparse model was written; run "
            "the triangulation on a machine with colmap installed."
        )
    db = base_dir / "database.db"
    subprocess.run(
        ["colmap", "feature_extractor", "--database_path", str(db),
         "--image_path", str(base_dir / image_path),
         "--ImageReader.single_camera", "0",
         "--ImageReader.camera_model", camera_model,
         "--SiftExtraction.use_gpu", "0"],
        check=True,
    )
    subprocess.run(
        ["colmap", "exhaustive_matcher", "--database_path", str(db),
         "--SiftMatching.use_gpu", "0"],
        check=True,
    )
    subprocess.run(
        ["colmap", "point_triangulator", "--database_path", str(db),
         "--image_path", str(base_dir / image_path),
         "--input_path", str(sparse_dir),
         "--output_path", str(sparse_dir)],
        check=True,
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--transforms", type=Path, required=True)
    p.add_argument("--run-colmap", action="store_true")
    p.add_argument("--no-colmap-world-convention", action="store_true")
    args = p.parse_args(argv)
    sparse = write_sparse_model(
        args.transforms,
        assume_colmap_world_coordinate_convention=(
            not args.no_colmap_world_convention
        ),
    )
    print(f"sparse model at {sparse}")
    if args.run_colmap:
        run_colmap_triangulation(args.transforms.parent, sparse)


if __name__ == "__main__":
    main()
