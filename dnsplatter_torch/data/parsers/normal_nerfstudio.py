"""Generic nerfstudio `transforms.json` dataparser with priors (counterpart
of dnsplatter_tpu/data/parsers/normal_nerfstudio.py).

Per-frame or global intrinsics and distortion, OpenGL c2w poses, auto
orientation ('up'), centering and auto scale, fraction / interval /
filename / all eval splits, `mono_depth/*_aligned.npy` priors,
`normals_from_pretrain/` normal maps, optional confidence maps, and a seed
cloud from the .ply the json names or one found beside it.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import List, Optional

import numpy as np

from dnsplatter_torch.data import io
from dnsplatter_torch.data.dataset import FrameSpec, SceneDataset
from dnsplatter_torch.data.parsers import register
from dnsplatter_torch.data.poses import (apply_transform_to_points,
                                         auto_orient_and_center_poses,
                                         auto_scale)


@dataclasses.dataclass(frozen=True)
class NerfstudioParserConfig:
    data: Path = Path(".")
    eval_mode: str = "fraction"  # fraction | interval | filename | all
    train_split_fraction: float = 0.9
    eval_interval: int = 8
    orientation_method: str = "up"
    center_method: str = "poses"
    auto_scale_poses: bool = True
    scale_factor: float = 1.0
    depth_unit_scale_factor: float = 1e-3
    load_3D_points: bool = True
    load_depths: bool = True
    load_normals: bool = True
    load_confidence: bool = False
    normal_format: str = "omnidata"
    downscale_factor: Optional[int] = None


def _natkey(name: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


def _natsort(paths: List[Path]) -> List[Path]:
    return sorted(paths, key=lambda p: _natkey(p.name))


def _split_indices(n: int, cfg: NerfstudioParserConfig, split: str,
                   filenames=None, meta=None) -> np.ndarray:
    if cfg.eval_mode == "all" or n <= 1:
        return np.arange(n)
    if cfg.eval_mode == "filename" and meta is not None:
        # frames the json lists under 'train_filenames'
        train_names = set(meta.get("train_filenames", []))
        if train_names:
            is_train = np.array([str(f) in train_names for f in filenames])
            return np.where(is_train if split == "train" else ~is_train)[0]
    if cfg.eval_mode == "interval":
        eval_idx = np.arange(0, n, cfg.eval_interval)
    else:  # fraction: nerfstudio's equispaced selection
        n_train = int(np.ceil(n * cfg.train_split_fraction))
        train_idx = np.unique(
            np.linspace(0, n - 1, n_train).round().astype(int))
        eval_idx = np.setdiff1d(np.arange(n), train_idx)
        return train_idx if split == "train" else eval_idx
    train_idx = np.setdiff1d(np.arange(n), eval_idx)
    return train_idx if split == "train" else eval_idx


@register("normal-nerfstudio")
def parse(cfg: NerfstudioParserConfig, split: str = "train",
          device=None) -> SceneDataset:
    data_dir = Path(cfg.data)
    meta = json.loads((data_dir / "transforms.json").read_text())
    # natural order, as the prior folders below: a plain sort puts frame_10
    # before frame_2 and would hand every frame another frame's priors
    frames_meta = sorted(meta["frames"],
                         key=lambda fr: _natkey(Path(fr["file_path"]).name))

    poses, keep = [], []
    for fr in frames_meta:
        if not (data_dir / fr["file_path"]).exists():
            # nerfstudio also takes the bare name beside the json
            alt = data_dir / Path(fr["file_path"]).name
            if not alt.exists():
                continue
            fr["file_path"] = alt.name
        keep.append(fr)
        m = np.array(fr["transform_matrix"], np.float64)
        if m.shape == (3, 4):
            m = np.concatenate([m, [[0, 0, 0, 1]]], 0)
        poses.append(m)
    frames_meta = keep
    poses, transform = auto_orient_and_center_poses(
        np.stack(poses),
        method=meta.get("orientation_override", cfg.orientation_method),
        center_method=cfg.center_method)
    if cfg.auto_scale_poses:
        poses, scale = auto_scale(poses, cfg.scale_factor)
    else:
        poses[:, :3, 3] *= cfg.scale_factor
        scale = cfg.scale_factor

    normal_paths = _natsort(list((data_dir / "normals_from_pretrain")
                                 .glob("*")))
    depth_paths = (
        _natsort(list((data_dir / "mono_depth").glob("*_aligned.npy")))
        or _natsort(list((data_dir / "mono_depth").glob("*.npy"))))
    conf_paths = _natsort(list((data_dir / "confidence").glob("*")))

    def stem_map(paths: List[Path]):
        # exact stems first, then '<stem>_suffix' files (frame_1_aligned.npy
        # -> frame_1) where no exact one exists. A sorted prefix probe would
        # be wrong: digits sort before '_', so frame_10_aligned falls
        # between frame_1 and frame_1_aligned.
        m = {}
        for q in paths:
            m.setdefault(q.stem, q)
        for q in paths:
            if "_" in q.stem:
                m.setdefault(q.stem.rsplit("_", 1)[0], q)
        return m

    stems = {id(ps): stem_map(ps)
             for ps in (normal_paths, depth_paths, conf_paths)}

    def prior_for(i: int, paths: List[Path]) -> Optional[Path]:
        # the frame's stem, else the natural-order position (the
        # reference's rule)
        hit = stems[id(paths)].get(Path(frames_meta[i]["file_path"]).stem)
        if hit is not None:
            return hit
        return paths[i] if i < len(paths) else None

    cam_model = str(meta.get("camera_model", "OPENCV"))
    cam_type = "fisheye" if "FISHEYE" in cam_model else "perspective"
    d = cfg.downscale_factor or 1
    specs: List[FrameSpec] = []
    for i, fr in enumerate(frames_meta):
        get = lambda k: fr.get(k, meta.get(k))  # noqa: E731
        dist = np.array([float(fr.get(k, meta.get(k, 0.0)) or 0.0)
                         for k in ("k1", "k2", "k3", "k4", "p1", "p2")])
        specs.append(FrameSpec(
            image_path=data_dir / fr["file_path"], c2w=poses[i],
            fx=get("fl_x") / d, fy=get("fl_y") / d, cx=get("cx") / d,
            cy=get("cy") / d, width=int(get("w")) // d,
            height=int(get("h")) // d,
            sensor_depth_path=(data_dir / fr["depth_file_path"]
                               if "depth_file_path" in fr and cfg.load_depths
                               else None),
            mono_depth_path=(prior_for(i, depth_paths) if cfg.load_depths
                             else None),
            normal_path=(prior_for(i, normal_paths) if cfg.load_normals
                         else None),
            distortion=dist if np.any(dist) else None,
            camera_type=cam_type,
            confidence_path=(prior_for(i, conf_paths) if cfg.load_confidence
                             else None),
            mask_path=(data_dir / fr["mask_path"] if "mask_path" in fr
                       else None)))

    idx = _split_indices(len(specs), cfg, split,
                         filenames=[fr["file_path"] for fr in frames_meta],
                         meta=meta)
    specs = [specs[i] for i in idx]

    seed_pts = seed_cols = seed_nrm = None
    if cfg.load_3D_points:
        ply_path = None
        if "ply_file_path" in meta:
            ply_path = data_dir / meta["ply_file_path"]
        else:
            cands = list(data_dir.glob("*.ply"))
            if (data_dir / "sparse_pc").exists():
                cands += list((data_dir / "sparse_pc").glob("*.ply"))
            if cands:
                ply_path = cands[0]
        if ply_path is not None and ply_path.exists():
            cloud = io.read_ply(ply_path)
            seed_pts = apply_transform_to_points(cloud["points"], transform,
                                                 scale)
            seed_cols = cloud.get("colors")
            if "normals" in cloud:
                seed_nrm = cloud["normals"] @ transform[:3, :3].T

    return SceneDataset(
        frames=specs, depth_unit_scale_factor=cfg.depth_unit_scale_factor,
        dataparser_scale=scale, normal_format=cfg.normal_format,
        seed_points=seed_pts, seed_colors=seed_cols, seed_normals=seed_nrm,
        device=device)
