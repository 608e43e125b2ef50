"""COLMAP dataparser for arbitrary captures (counterpart of
dnsplatter_tpu/data/parsers/coolermap.py).

Layout: <data>/images and a COLMAP model at <data>/colmap/sparse/0.
Interval eval split, aligned mono depths from mono_depth/*_aligned.npy,
optional normals from normals_from_pretrain/, seed cloud from the model's
points3D.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from dnsplatter_torch.data import colmap_utils as cu
from dnsplatter_torch.data.dataset import FrameSpec, SceneDataset
from dnsplatter_torch.data.parsers import register
from dnsplatter_torch.data.poses import (apply_transform_to_points,
                                         auto_orient_and_center_poses,
                                         auto_scale)


@dataclasses.dataclass(frozen=True)
class CoolerMapParserConfig:
    data: Path = Path(".")
    images_path: Path = Path("images")
    colmap_path: Path = Path("colmap/sparse/0")
    eval_mode: str = "interval"
    eval_interval: int = 8
    load_every: int = 1
    auto_scale_poses: bool = True
    orientation_method: str = "up"
    center_method: str = "poses"
    load_3D_points: bool = True
    load_depths: bool = True
    load_normals: bool = True


@register("coolermap")
def parse(cfg: CoolerMapParserConfig, split: str = "train",
          device=None) -> SceneDataset:
    data_dir = Path(cfg.data)
    cams, imgs, xyz, rgb = cu.read_model(data_dir / cfg.colmap_path)
    items = sorted(imgs.values(), key=lambda im: im.name)
    poses, transform = auto_orient_and_center_poses(
        np.stack([cu.image_c2w_opengl(im) for im in items]),
        cfg.orientation_method, cfg.center_method)
    scale = 1.0
    if cfg.auto_scale_poses:
        poses, scale = auto_scale(poses)

    depth_dir = data_dir / "mono_depth"
    depth_paths = (sorted(depth_dir.glob("*_aligned.npy"))
                   if depth_dir.exists() else [])
    normal_dir = data_dir / "normals_from_pretrain"
    normal_paths = sorted(normal_dir.glob("*")) if normal_dir.exists() else []

    frames = []
    for i, im in enumerate(items):
        cam = cams[im.camera_id]
        fx, fy, cx, cy = cu.camera_intrinsics(cam)
        dist, cam_type = cu.camera_distortion(cam)
        frames.append(FrameSpec(
            image_path=data_dir / cfg.images_path / im.name, c2w=poses[i],
            fx=fx, fy=fy, cx=cx, cy=cy, width=cam.width, height=cam.height,
            mono_depth_path=(depth_paths[i] if cfg.load_depths
                             and i < len(depth_paths) else None),
            normal_path=(normal_paths[i] if cfg.load_normals
                         and i < len(normal_paths) else None),
            distortion=dist, camera_type=cam_type))

    idx = list(range(len(frames)))[::cfg.load_every]
    if cfg.eval_mode == "interval":
        eval_idx = set(idx[::cfg.eval_interval])
        idx = [i for i in idx if (i not in eval_idx) == (split == "train")]
    ds = SceneDataset(frames=[frames[i] for i in idx],
                      depth_unit_scale_factor=1.0,  # aligned npy: metric
                      dataparser_scale=scale, device=device)
    if cfg.load_3D_points and xyz is not None:
        ds.seed_points = apply_transform_to_points(xyz, transform, scale)
        ds.seed_colors = rgb
    return ds
