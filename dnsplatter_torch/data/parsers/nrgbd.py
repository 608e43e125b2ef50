"""Neural-RGBD dataparser (counterpart of
dnsplatter_tpu/data/parsers/nrgbd.py).

Layout: <data>/<sequence>/{images/*.png, depth/*.png or
depth_with_noise/*.png, trainval_poses.txt, gt_poses.txt}. Poses are 4x4
blocks of four lines, already OpenGL, aligned so the first frame matches the
gt trajectory; fixed focal 554.256; every 15th valid frame loaded, every
10th of those held out; depth in millimetres; seed cloud backprojected.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from dnsplatter_torch.data.dataset import FrameSpec, SceneDataset
from dnsplatter_torch.data.parsers import register
from dnsplatter_torch.data.parsers.replica import backproject_seed_cloud
from dnsplatter_torch.data.poses import (auto_orient_and_center_poses,
                                         auto_scale)

NRGBD_FOCAL = 554.2562584220408


def _load_pose_file(path: Path):
    """(poses (N, 4, 4), valid (N,)): a block holding 'nan' is invalid and
    stands as the identity."""
    lines = path.read_text().strip().splitlines()
    poses, valid = [], []
    for i in range(0, len(lines), 4):
        block = lines[i:i + 4]
        if any("nan" in ln for ln in block):
            poses.append(np.eye(4))
            valid.append(False)
        else:
            poses.append(np.array([[float(x) for x in ln.split()]
                                   for ln in block]))
            valid.append(True)
    return np.stack(poses), np.array(valid)


@dataclasses.dataclass(frozen=True)
class NRGBDParserConfig:
    data: Path = Path(".")
    sequence: str = "whiteroom"
    depth_name: str = "depth"  # or "depth_with_noise"
    load_every: int = 15
    skip_every_for_val_split: int = 10
    auto_scale_poses: bool = True
    orientation_method: str = "up"
    center_method: str = "none"
    num_seed_points: int = 200_000
    seed: int = 0


@register("nrgbd")
def parse(cfg: NRGBDParserConfig, split: str = "train",
          device=None) -> SceneDataset:
    from PIL import Image

    seq_dir = Path(cfg.data) / cfg.sequence
    color_paths = sorted((seq_dir / "images").glob("*.png"))
    depth_paths = sorted((seq_dir / cfg.depth_name).glob("*.png"))
    poses, valid = _load_pose_file(seq_dir / "trainval_poses.txt")
    if (seq_dir / "gt_poses.txt").exists():
        gt_poses, _ = _load_pose_file(seq_dir / "gt_poses.txt")
        align = gt_poses[0] @ np.linalg.inv(poses[0])
        poses = np.einsum("ij,njk->nik", align, poses)
    poses, _ = auto_orient_and_center_poses(poses, cfg.orientation_method,
                                            cfg.center_method)
    scale = 1.0
    if cfg.auto_scale_poses:
        poses, scale = auto_scale(poses)

    w, h = Image.open(color_paths[0]).size
    indices = [i for i in range(len(color_paths))
               if valid[i]][::cfg.load_every]
    eval_idx = indices[::cfg.skip_every_for_val_split]
    indices = ([i for i in indices if i not in eval_idx]
               if split == "train" else eval_idx)

    frames = [FrameSpec(
        image_path=color_paths[i], c2w=poses[i], fx=NRGBD_FOCAL,
        fy=NRGBD_FOCAL, cx=w * 0.5, cy=h * 0.5, width=w, height=h,
        sensor_depth_path=depth_paths[i]) for i in indices]
    ds = SceneDataset(frames=frames, depth_unit_scale_factor=1e-3,
                      dataparser_scale=scale, device=device)
    if frames:
        ds.seed_points, ds.seed_colors = backproject_seed_cloud(
            ds, cfg.num_seed_points, cfg.seed)
    return ds
