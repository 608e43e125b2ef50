"""Replica RGB-D dataparser (counterpart of
dnsplatter_tpu/data/parsers/replica.py).

Layout: <data>/cam_params.json, <data>/<sequence>/traj.txt (a flattened
4x4 OpenCV c2w a line), <data>/<sequence>/results/frame*.jpg and
depth*.png. Depth unit 1/6553.5; every 25th frame loaded, every 5th of
those held out; the seed cloud is sampled from <data>/<sequence>_mesh.ply
when present, else backprojected from the RGB-D frames.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from dnsplatter_torch.data import io
from dnsplatter_torch.data.dataset import FrameSpec, SceneDataset
from dnsplatter_torch.data.parsers import register
from dnsplatter_torch.data.poses import (apply_transform_to_points,
                                         auto_orient_and_center_poses,
                                         auto_scale)
from dnsplatter_torch.ops.camera import GL_TO_CV, backproject_depth


@dataclasses.dataclass(frozen=True)
class ReplicaParserConfig:
    data: Path = Path(".")
    sequence: str = "office0"
    load_every: int = 25
    skip_every_for_val_split: int = 5
    auto_scale_poses: bool = True
    orientation_method: str = "up"
    center_method: str = "poses"
    num_seed_points: int = 200_000
    load_normals: bool = True
    seed: int = 0


@register("replica")
def parse(cfg: ReplicaParserConfig, split: str = "train",
          device=None) -> SceneDataset:
    data_dir = Path(cfg.data)
    seq_dir = data_dir / cfg.sequence
    cam = json.loads((data_dir / "cam_params.json").read_text())["camera"]

    color_paths = sorted((seq_dir / "results").glob("frame*.jpg"))
    depth_paths = sorted((seq_dir / "results").glob("depth*.png"))
    lines = (seq_dir / "traj.txt").read_text().strip().splitlines()
    poses = np.array([list(map(float, ln.split()))
                      for ln in lines[:len(color_paths)]]).reshape(-1, 4, 4)
    poses[:, 0:3, 1:3] *= -1  # OpenCV -> OpenGL camera axes
    poses, transform = auto_orient_and_center_poses(
        poses, cfg.orientation_method, cfg.center_method)
    scale = 1.0
    if cfg.auto_scale_poses:
        poses, scale = auto_scale(poses)

    # priors by frame stem, not by listing position: priors made only for
    # the loaded (every-Nth) frames would otherwise land on other frames
    normal_dir = seq_dir / "normals_from_pretrain"
    normal_by_stem = ({q.stem: q for q in normal_dir.glob("*.png")}
                      if normal_dir.exists() else {})

    indices = list(range(len(color_paths)))[::cfg.load_every]
    eval_idx = indices[::cfg.skip_every_for_val_split]
    if split == "train":
        indices = [i for i in indices if i not in eval_idx]
    else:
        indices = eval_idx

    frames = [FrameSpec(
        image_path=color_paths[i], c2w=poses[i], fx=cam["fx"], fy=cam["fy"],
        cx=cam["cx"], cy=cam["cy"], width=cam["w"], height=cam["h"],
        sensor_depth_path=depth_paths[i],
        normal_path=normal_by_stem.get(color_paths[i].stem))
        for i in indices]
    ds = SceneDataset(frames=frames, depth_unit_scale_factor=1.0 / 6553.5,
                      dataparser_scale=scale, normal_format="omnidata",
                      device=device)

    mesh_path = data_dir / f"{cfg.sequence}_mesh.ply"
    if mesh_path.exists():
        cloud = io.read_ply(mesh_path)
        pts = cloud["points"]
        sel = np.random.default_rng(cfg.seed).choice(
            len(pts), min(cfg.num_seed_points, len(pts)), replace=False)
        ds.seed_points = apply_transform_to_points(pts[sel], transform, scale)
        if "colors" in cloud:
            ds.seed_colors = cloud["colors"][sel]
    elif frames:
        ds.seed_points, ds.seed_colors = backproject_seed_cloud(
            ds, cfg.num_seed_points, cfg.seed)
    return ds


def backproject_seed_cloud(ds: SceneDataset, num_points: int, seed: int = 0):
    """(points, colors), float32: an equal share of each frame's pixels
    with depth, backprojected on the dataset's device, drawn at random."""
    rng = np.random.default_rng(seed)
    per_frame = max(1, num_points // max(len(ds), 1))
    pts_all, col_all = [], []
    for i in range(len(ds)):
        cam, batch = ds.get(i)
        if "sensor_depth" not in batch:
            continue
        depth = batch["sensor_depth"][..., 0]
        c2w_cv = cam.c2w @ torch.as_tensor(GL_TO_CV, device=cam.device)
        pts = backproject_depth(
            torch.as_tensor(depth, device=cam.device), cam.fx, cam.fy,
            cam.cx, cam.cy, c2w_cv).reshape(-1, 3).cpu().numpy()
        idx = np.where(depth.reshape(-1) > 1e-6)[0]
        sel = rng.choice(idx, min(per_frame, len(idx)), replace=False)
        pts_all.append(pts[sel])
        col_all.append(batch["image"].reshape(-1, 3)[sel])
    return (np.concatenate(pts_all).astype(np.float32),
            np.concatenate(col_all).astype(np.float32))
