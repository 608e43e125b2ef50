"""SDFStudio-format dataparser, DTU and SDFStudio scenes (counterpart of
dnsplatter_tpu/data/parsers/gsdf.py).

Layout: <data>/meta_data.json whose frames carry rgb_path, a 4x4 OpenCV
camtoworld, 4x4 intrinsics, and optional sensor or mono depth, mono normal
and foreground mask paths.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from dnsplatter_torch.data.dataset import FrameSpec, SceneDataset
from dnsplatter_torch.data.parsers import register
from dnsplatter_torch.data.poses import (auto_orient_and_center_poses,
                                         auto_scale)


@dataclasses.dataclass(frozen=True)
class GSDFParserConfig:
    data: Path = Path(".")
    skip_every_for_val_split: int = 8
    auto_scale_poses: bool = False
    auto_orient: bool = False
    depth_unit_scale_factor: float = 1.0


@register("gsdf")
def parse(cfg: GSDFParserConfig, split: str = "train",
          device=None) -> SceneDataset:
    data_dir = Path(cfg.data)
    meta = json.loads((data_dir / "meta_data.json").read_text())
    h, w = int(meta["height"]), int(meta["width"])

    poses = []
    for fr in meta["frames"]:
        m = np.array(fr["camtoworld"], np.float64).reshape(4, 4)
        m[:3, 1:3] *= -1  # OpenCV -> OpenGL
        poses.append(m)
    poses = np.stack(poses)
    if cfg.auto_orient:
        poses, _ = auto_orient_and_center_poses(poses)
    scale = 1.0
    if cfg.auto_scale_poses:
        poses, scale = auto_scale(poses)

    frames = []
    for i, fr in enumerate(meta["frames"]):
        k = np.array(fr["intrinsics"], np.float64).reshape(4, 4)
        depth = fr.get("sensor_depth_path") or fr.get("mono_depth_path")
        normal = fr.get("mono_normal_path") or fr.get("normal_from_depth_path")
        frames.append(FrameSpec(
            image_path=data_dir / fr["rgb_path"], c2w=poses[i],
            fx=k[0, 0], fy=k[1, 1], cx=k[0, 2], cy=k[1, 2], width=w, height=h,
            sensor_depth_path=data_dir / depth if depth else None,
            # the suffix as given: SDFStudio normals are .npy
            normal_path=data_dir / normal if normal else None,
            mask_path=(data_dir / fr["foreground_mask"]
                       if "foreground_mask" in fr else None)))

    idx = list(range(len(frames)))
    eval_idx = set(idx[::cfg.skip_every_for_val_split])
    frames = [frames[i] for i in idx if (i in eval_idx) == (split != "train")]
    return SceneDataset(frames=frames,
                        depth_unit_scale_factor=cfg.depth_unit_scale_factor,
                        dataparser_scale=scale, normal_format="none",
                        device=device)
