"""COLMAP SfM over an image folder, a wrapper of the `colmap` binary
(counterpart of dnsplatter_tpu/scripts/convert_colmap.py): feature
extraction, matching and mapping. Known-pose export and triangulation live
in scripts/poses_to_colmap_sfm.py.

    python -m dnsplatter_torch.scripts.convert_colmap --image-dir IMAGES \
        --output-dir OUT [--matcher exhaustive]
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
from pathlib import Path

def run_colmap(image_dir: Path, out_dir: Path, matcher: str = "sequential",
               camera_model: str = "OPENCV") -> Path:
    """feature_extractor -> matcher -> mapper."""
    if shutil.which("colmap") is None:
        raise SystemExit("colmap binary not found on PATH")
    out_dir.mkdir(parents=True, exist_ok=True)
    db = out_dir / "database.db"
    sparse = out_dir / "sparse"
    sparse.mkdir(exist_ok=True)
    subprocess.run(
        ["colmap", "feature_extractor", "--database_path", str(db),
         "--image_path", str(image_dir),
         "--ImageReader.camera_model", camera_model,
         "--ImageReader.single_camera", "1"],
        check=True,
    )
    subprocess.run(
        ["colmap", f"{matcher}_matcher", "--database_path", str(db)],
        check=True,
    )
    subprocess.run(
        ["colmap", "mapper", "--database_path", str(db),
         "--image_path", str(image_dir), "--output_path", str(sparse)],
        check=True,
    )
    return sparse / "0"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image-dir", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--matcher", default="sequential",
                   choices=["sequential", "exhaustive"])
    args = p.parse_args(argv)
    model = run_colmap(args.image_dir, args.output_dir, args.matcher)
    print(f"COLMAP model at {model}")


if __name__ == "__main__":
    main()
