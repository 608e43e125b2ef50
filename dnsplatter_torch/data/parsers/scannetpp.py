"""ScanNet++ dataparser (counterpart of
dnsplatter_tpu/data/parsers/scannetpp.py).

Modes:
  dslr    COLMAP model at <seq>/dslr/colmap, undistorted images, split
          from <seq>/dslr/train_test_lists.json
  iphone  COLMAP model at <seq>/iphone/colmap, RGB-D with depth pngs at
          <seq>/iphone/depth, every 10th frame held out

The dslr seed cloud is the model's points3D; the iphone one is fused from
the RGB-D frames (written once to <seq>/iphone/iphone_pointcloud.ply, with
a transforms.json beside it). Aligned mono depths come from
<capture>/mono_depth/*_aligned.npy when present.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from dnsplatter_torch.data import colmap_utils as cu
from dnsplatter_torch.data import io
from dnsplatter_torch.data import pointcloud_utils as pu
from dnsplatter_torch.data.dataset import FrameSpec, SceneDataset
from dnsplatter_torch.data.parsers import register
from dnsplatter_torch.data.poses import (apply_transform_to_points,
                                         auto_orient_and_center_poses,
                                         auto_scale)


@dataclasses.dataclass(frozen=True)
class ScannetppParserConfig:
    data: Path = Path(".")
    sequence: str = ""
    mode: str = "iphone"  # or "dslr"
    images_dir: str = ""  # default: rgb (iphone) / undistorted_images (dslr)
    skip_every_for_val_split: int = 10
    load_every: int = 1
    auto_scale_poses: bool = True
    orientation_method: str = "up"
    center_method: str = "poses"
    load_depths: bool = True
    load_normals: bool = True
    # iphone seed cloud fused from the RGB-D frames instead of the sparse
    # COLMAP points
    iphone_tsdf_seed: bool = True
    seed_cloud_tsdf: bool = False  # True = TSDF fuse; False = backproject
    num_init_points: int = 1_000_000


def _write_transforms_json(seq_dir: Path, images_dir: Path, items, cams,
                           test_names=None) -> None:
    """The canonical transforms.json (and transforms_test.json) of the
    COLMAP model, which the RGB-D seed fusion reads."""
    depth_dir = seq_dir / "depth"
    frames, test_frames = [], []
    for im in items:
        cam = cams[im.camera_id]
        fx, fy, cx, cy = cu.camera_intrinsics(cam)
        stem = Path(im.name).stem
        fr = {"file_path": f"{images_dir.name}/{Path(im.name).name}",
              "transform_matrix": cu.image_c2w_opengl(im).tolist(),
              "fl_x": fx, "fl_y": fy, "cx": cx, "cy": cy,
              "w": cam.width, "h": cam.height}
        if (depth_dir / f"{stem}.png").exists():
            fr["depth_file_path"] = f"depth/{stem}.png"
        if test_names and Path(im.name).name in test_names:
            test_frames.append(fr)
        else:
            frames.append(fr)
    (seq_dir / "transforms.json").write_text(
        json.dumps({"frames": frames}, indent=1))
    if test_frames:
        (seq_dir / "transforms_test.json").write_text(
            json.dumps({"frames": test_frames}, indent=1))


@register("scannetpp")
def parse(cfg: ScannetppParserConfig, split: str = "train",
          device=None) -> SceneDataset:
    seq_dir = Path(cfg.data) / cfg.sequence / cfg.mode
    colmap_dir = seq_dir / "colmap"
    if not colmap_dir.exists():
        colmap_dir = seq_dir / "colmap" / "sparse" / "0"
    cams, imgs, xyz, rgb = cu.read_model(colmap_dir)

    images_dir = seq_dir / (cfg.images_dir or (
        "rgb" if cfg.mode == "iphone" else "undistorted_images"))
    if not images_dir.exists():
        for cand in ("images", "resized_images", "rgb"):
            if (seq_dir / cand).exists():
                images_dir = seq_dir / cand
                break

    items = sorted(imgs.values(), key=lambda im: im.name)
    poses, transform = auto_orient_and_center_poses(
        np.stack([cu.image_c2w_opengl(im) for im in items]),
        cfg.orientation_method, cfg.center_method)
    scale = 1.0
    if cfg.auto_scale_poses:
        poses, scale = auto_scale(poses)

    def existing(path: Path):
        return path if path.exists() else None

    depth_dir = seq_dir / "depth"
    mono_dir = seq_dir / "mono_depth"
    normal_dir = seq_dir / "normals_from_pretrain"
    frames = []
    for i, im in enumerate(items):
        cam = cams[im.camera_id]
        fx, fy, cx, cy = cu.camera_intrinsics(cam)
        dist, cam_type = cu.camera_distortion(cam)
        stem = Path(im.name).stem
        frames.append(FrameSpec(
            image_path=images_dir / Path(im.name).name, c2w=poses[i],
            fx=fx, fy=fy, cx=cx, cy=cy, width=cam.width, height=cam.height,
            sensor_depth_path=(existing(depth_dir / f"{stem}.png")
                               if cfg.load_depths and cfg.mode == "iphone"
                               else None),
            mono_depth_path=(existing(mono_dir / f"{stem}_aligned.npy")
                             if cfg.load_depths else None),
            normal_path=(existing(normal_dir / f"{stem}.png")
                         if cfg.load_normals else None),
            distortion=dist, camera_type=cam_type))

    n = len(frames)
    if cfg.mode == "dslr":
        split_file = seq_dir / "train_test_lists.json"
        test_set = (set(json.loads(split_file.read_text())["test"])
                    if split_file.exists() else set())
        idx = [i for i in range(n)
               if (Path(items[i].name).name in test_set) == (split != "train")]
    else:
        eval_idx = set(range(0, n, cfg.skip_every_for_val_split))
        idx = [i for i in range(n) if (i in eval_idx) == (split != "train")]
    if split == "train" and cfg.load_every > 1:
        idx = idx[::cfg.load_every]

    ds = SceneDataset(frames=[frames[i] for i in idx],
                      depth_unit_scale_factor=1e-3, dataparser_scale=scale,
                      device=device)
    if xyz is not None and (cfg.mode == "dslr" or not cfg.iphone_tsdf_seed):
        ds.seed_points = apply_transform_to_points(xyz, transform, scale)
        ds.seed_colors = rgb
    elif split == "train" and cfg.mode == "iphone":
        ply = seq_dir / "iphone_pointcloud.ply"
        try:
            if not ply.exists():
                if not (seq_dir / "transforms.json").exists():
                    _write_transforms_json(seq_dir, images_dir, items, cams)
                pu.generate_iphone_pointcloud(
                    seq_dir, ply, num_points=cfg.num_init_points,
                    use_tsdf=cfg.seed_cloud_tsdf, device=device)
            cloud = io.read_ply(ply)
            ds.seed_points = apply_transform_to_points(cloud["points"],
                                                       transform, scale)
            ds.seed_colors = cloud.get("colors")
            if "normals" in cloud:
                ds.seed_normals = cloud["normals"] @ transform[:3, :3].T
        except FileNotFoundError:
            # no RGB-D frame on disk: the sparse COLMAP points instead
            if xyz is not None:
                ds.seed_points = apply_transform_to_points(xyz, transform,
                                                           scale)
                ds.seed_colors = rgb
    return ds
