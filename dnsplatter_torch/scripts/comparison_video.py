"""Side-by-side comparison videos from render trees, an ffmpeg wrapper
(counterpart of dnsplatter_tpu/scripts/comparison_video.py): stitch two
folders of PNG frames (pred and gt, or two methods' renders) into one
side-by-side video.

    python -m dnsplatter_torch.scripts.comparison_video --left A --right B \
        --out comparison.mp4
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
from pathlib import Path


def make_video(left_dir: Path, right_dir: Path, out: Path,
               fps: int = 15) -> None:
    if shutil.which("ffmpeg") is None:
        raise SystemExit("ffmpeg not found on PATH")
    subprocess.run(
        ["ffmpeg", "-y",
         "-framerate", str(fps), "-pattern_type", "glob",
         "-i", str(left_dir / "*.png"),
         "-framerate", str(fps), "-pattern_type", "glob",
         "-i", str(right_dir / "*.png"),
         "-filter_complex", "hstack=inputs=2",
         "-pix_fmt", "yuv420p", str(out)],
        check=True,
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--left", type=Path, required=True)
    p.add_argument("--right", type=Path, required=True)
    p.add_argument("--out", type=Path, default=Path("comparison.mp4"))
    p.add_argument("--fps", type=int, default=15)
    args = p.parse_args(argv)
    make_video(args.left, args.right, args.out, args.fps)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
