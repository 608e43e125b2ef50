"""MuSHRoom dataparser (counterpart of
dnsplatter_tpu/data/parsers/mushroom.py).

Layout: <room>/<mode>/{long_capture, short_capture}/ with
transformations.json (transformations_colmap.json where the Faro reference
depths are used), images/, depth/, optional normals and depth_normals_mask;
the seed cloud is <room>/<mode>_pointcloud.ply.

What a capture lacks is made and written beside it: normals from the sensor
depth (normals_from_depth/), depth-normal consistency masks
(depth_normals_mask/), and the seed cloud from the long capture's RGB-D
frames, resampled to `num_init_points`.

Eval protocols:
  within  train on the long capture, evaluate on its test.txt frames
  with    train on the long capture, evaluate on the short capture
  all     both eval sets, each frame labelled with its protocol
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np

from dnsplatter_torch.data import io
from dnsplatter_torch.data import pointcloud_utils as pu
from dnsplatter_torch.data.dataset import FrameSpec, SceneDataset
from dnsplatter_torch.data.parsers import register
from dnsplatter_torch.data.poses import (apply_transform_to_points,
                                         auto_orient_and_center_poses,
                                         auto_scale)
from dnsplatter_torch.scripts.depth_normal_consistency import consistency_mask
from dnsplatter_torch.scripts.normals_from_depth import normal_image_from_depth


@dataclasses.dataclass(frozen=True)
class MushroomParserConfig:
    data: Path = Path(".")
    mode: str = "iphone"  # or "kinect"
    eval_mode: str = "with"  # with | within | all
    load_depths: bool = True
    load_normals: bool = True
    load_depth_confidence_masks: bool = False
    use_faro_scanner_depths: bool = False
    auto_scale_poses: bool = True
    orientation_method: str = "up"
    center_method: str = "poses"
    load_3D_points: bool = True
    depth_unit_scale_factor: float = 1e-3
    max_image_dim: int = 1600  # frames above it are downscaled
    # seed cloud: rebuilt from the capture when missing, resampled to
    # exactly num_init_points
    num_init_points: int = 1_000_000
    regenerate_seed_cloud: bool = True
    seed_cloud_tsdf: bool = False  # TSDF-fuse instead of backprojection
    # normals from the sensor depth where no normals_from_pretrain/ exists
    auto_generate_normals: bool = True


def _load_capture(capture_dir: Path, cfg: MushroomParserConfig):
    """(FrameSpecs, poses (N, 4, 4)) of one capture's json."""
    name = ("transformations_colmap.json" if cfg.use_faro_scanner_depths
            else "transformations.json")
    meta_path = capture_dir / name
    if not meta_path.exists():
        meta_path = capture_dir / "transformations.json"
    meta = json.loads(meta_path.read_text())

    specs, poses = [], []
    for fr in sorted(meta["frames"], key=lambda fr: fr["file_path"]):
        img = capture_dir / fr["file_path"]
        if not img.exists():
            continue
        stem = Path(fr["file_path"]).stem
        m = np.array(fr["transform_matrix"], np.float64)
        if m.shape == (3, 4):
            m = np.concatenate([m, [[0, 0, 0, 1]]], 0)
        poses.append(m)
        get = lambda k: fr.get(k, meta.get(k))  # noqa: E731
        w, h = int(get("w")), int(get("h"))
        d = max(1, int(np.ceil(max(w, h) / cfg.max_image_dim)))
        depth = None
        if cfg.load_depths:
            if "depth_file_path" in fr:
                depth = capture_dir / fr["depth_file_path"]
            elif (capture_dir / "depth" / f"{stem}.png").exists():
                depth = capture_dir / "depth" / f"{stem}.png"
        normal = None
        if cfg.load_normals:
            normal = next((capture_dir / sub / f"{stem}.png" for sub in
                           ("normals_from_pretrain", "normals_from_depth")
                           if (capture_dir / sub / f"{stem}.png").exists()),
                          None)
        conf = None
        if cfg.load_depth_confidence_masks:
            # ours are png; the reference ships jpg
            conf = next((capture_dir / "depth_normals_mask" / (stem + ext)
                         for ext in (".png", ".jpg")
                         if (capture_dir / "depth_normals_mask"
                             / (stem + ext)).exists()), None)
        specs.append(FrameSpec(
            image_path=img, c2w=m,  # replaced after the global orientation
            fx=get("fl_x") / d, fy=get("fl_y") / d, cx=get("cx") / d,
            cy=get("cy") / d, width=w // d, height=h // d,
            sensor_depth_path=depth, normal_path=normal,
            confidence_path=conf))
    return specs, np.stack(poses) if poses else np.zeros((0, 4, 4))


def _depth_intrinsics(sp: FrameSpec, depth: np.ndarray):
    """The frame's intrinsics at the resolution of its depth map."""
    sy = depth.shape[0] / sp.height
    sx = depth.shape[1] / sp.width
    return sp.fx * sx, sp.fy * sy, sp.cx * sx, sp.cy * sy


def _ensure_confidence_masks(capture_dir: Path, specs, cfg, device) -> None:
    """Depth-normal consistency masks where the capture has no png ones
    (a legacy lossy jpg is not used while a png exists)."""
    out_dir = capture_dir / "depth_normals_mask"
    if (out_dir.exists() and any(out_dir.glob("*.png"))) or not specs:
        return
    out_dir.mkdir(parents=True, exist_ok=True)
    for sp in specs:
        if sp.sensor_depth_path is None or sp.normal_path is None:
            continue
        depth = io.read_depth(sp.sensor_depth_path,
                              cfg.depth_unit_scale_factor)
        normal = io.read_normal(sp.normal_path, "omnidata")
        if normal.shape[:2] != depth.shape[:2]:
            normal = io.resize_image(normal, depth.shape[0], depth.shape[1])
        mask = consistency_mask(depth, normal, *_depth_intrinsics(sp, depth),
                                device=device)
        # png, not jpeg: the mask gates the depth loss where confidence > 0,
        # and lossy "bad" pixels decoding to 250-254 would let gt through
        out = out_dir / f"{sp.image_path.stem}.png"
        io.write_image(out, mask[..., None] / 255.0)
        sp.confidence_path = out


def _ensure_normals(capture_dir: Path, specs, cfg, device) -> None:
    """Normal maps from the sensor depth when no frame has a normal map."""
    if (not cfg.auto_generate_normals or not specs
            or any(sp.normal_path is not None for sp in specs)
            or not any(sp.sensor_depth_path is not None for sp in specs)):
        return
    out_dir = capture_dir / "normals_from_depth"
    out_dir.mkdir(parents=True, exist_ok=True)
    for sp in specs:
        if sp.sensor_depth_path is None:
            continue
        out = out_dir / f"{sp.image_path.stem}.png"
        if not out.exists():
            depth = io.read_depth(sp.sensor_depth_path,
                                  cfg.depth_unit_scale_factor)
            io.write_image(out, normal_image_from_depth(
                depth, *_depth_intrinsics(sp, depth), device=device))
        sp.normal_path = out


def _ensure_seed_cloud(cfg: MushroomParserConfig, device) -> Optional[Path]:
    """The room's seed cloud: <mode>_pointcloud.ply, else any .ply in the
    room, else one rebuilt from the long capture."""
    ply = Path(cfg.data) / f"{cfg.mode}_pointcloud.ply"
    if ply.exists():
        return ply
    cands = list(Path(cfg.data).glob("*.ply"))
    if cands:
        return cands[0]
    if not cfg.regenerate_seed_cloud:
        return None
    long_dir = Path(cfg.data) / cfg.mode / "long_capture"
    try:
        if cfg.mode == "kinect" and (long_dir / "PointCloud").exists():
            return pu.generate_kinect_pointcloud(
                long_dir, ply, num_points=cfg.num_init_points)
        return pu.generate_iphone_pointcloud(
            long_dir, ply, num_points=cfg.num_init_points,
            use_tsdf=cfg.seed_cloud_tsdf,
            depth_scale=cfg.depth_unit_scale_factor, device=device)
    except FileNotFoundError:
        return None


@register("mushroom")
def parse(cfg: MushroomParserConfig, split: str = "train",
          device=None) -> SceneDataset:
    base = Path(cfg.data) / cfg.mode
    long_specs, long_poses = _load_capture(base / "long_capture", cfg)
    short_specs, short_poses = _load_capture(base / "short_capture", cfg)
    for capture, specs in (("long_capture", long_specs),
                           ("short_capture", short_specs)):
        if cfg.load_normals:
            _ensure_normals(base / capture, specs, cfg, device)
        if cfg.load_depth_confidence_masks:
            _ensure_confidence_masks(base / capture, specs, cfg, device)

    all_poses, transform = auto_orient_and_center_poses(
        np.concatenate([long_poses, short_poses]), cfg.orientation_method,
        cfg.center_method)
    scale = 1.0
    if cfg.auto_scale_poses:
        all_poses, scale = auto_scale(all_poses)
    specs = long_specs + short_specs
    for s, p in zip(specs, all_poses):
        s.c2w = p

    n_long = len(long_specs)
    test_txt = base / "long_capture" / "test.txt"
    test_names = set()
    if test_txt.exists():
        test_names = {ln.strip() for ln in test_txt.read_text().splitlines()
                      if ln.strip()}
    is_test = [sp.image_path.stem in test_names for sp in long_specs]
    i_train = [i for i in range(n_long) if not is_test[i]]
    i_within = [i for i in range(n_long) if is_test[i]]
    i_with = list(range(n_long, len(specs)))
    i_eval = {"within": i_within, "with": i_with}.get(cfg.eval_mode,
                                                      i_within + i_with)
    idx = i_train if split == "train" else i_eval
    protocols = None
    if split != "train":
        protocols = ["within" if i < n_long else "with" for i in idx]

    ds = SceneDataset(frames=[specs[i] for i in idx],
                      depth_unit_scale_factor=cfg.depth_unit_scale_factor,
                      dataparser_scale=scale, normal_format="omnidata",
                      protocols=protocols, device=device)
    if cfg.load_3D_points:
        ply = _ensure_seed_cloud(cfg, device)
        if ply and ply.exists():
            cloud = io.read_ply(ply)
            pts, cols, nrms = (cloud["points"], cloud.get("colors"),
                               cloud.get("normals"))
            if len(pts) != cfg.num_init_points:
                pts, cols, nrms = pu.resample_to_num_points(
                    pts, cols, nrms, cfg.num_init_points)
            ds.seed_points = apply_transform_to_points(pts, transform, scale)
            ds.seed_colors = cols
            if nrms is not None:
                ds.seed_normals = nrms @ transform[:3, :3].T
    return ds
