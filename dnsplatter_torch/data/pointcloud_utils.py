"""Seed point clouds for MuSHRoom and ScanNet++ RGB-D captures (counterpart
of dnsplatter_tpu/data/pointcloud_utils.py).

When a dataset ships no seed cloud, or one of the wrong size, one is built:
for kinect captures from the per-frame SpectacularAI PointCloud/*.ply files
re-posed into the COLMAP frame; for iphone and ScanNet++ captures from the
train RGB-D frames, backprojected with a voxel de-duplication, with normals
from the depth maps, or (`use_tsdf`) fused in a TSDF volume whose surface is
sampled. `resample_to_num_points` gives the exact size the parser asks for.
The backprojection and sampling run in numpy on the host, as in the JAX
package, so the cloud's points and their order are the same; the depth
normals and the TSDF fusion run on `device` (None: the card).
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from dnsplatter_torch import resolve_device
from dnsplatter_torch.data import io
from dnsplatter_torch.ops.normals import normal_from_depth_image

OPENGL_TO_OPENCV = np.diag([1.0, -1.0, -1.0, 1.0])


def resample_to_num_points(points: np.ndarray, colors: Optional[np.ndarray],
                           normals: Optional[np.ndarray], num_points: int,
                           seed: int = 0):
    """Exactly `num_points` rows: without replacement when shrinking, with
    replacement when growing."""
    n = len(points)
    if n == 0:
        return points, colors, normals
    idx = np.random.default_rng(seed).choice(n, size=num_points,
                                             replace=n < num_points)
    pick = lambda a: None if a is None else a[idx]  # noqa: E731
    return points[idx], pick(colors), pick(normals)


def _load_frames_meta(capture_dir: Path):
    for name in ("transformations_colmap.json", "transformations.json",
                 "transforms.json"):
        p = capture_dir / name
        if p.exists():
            return json.loads(p.read_text())
    raise FileNotFoundError(f"no transformations json in {capture_dir}")


def _train_frames(capture_dir: Path, meta) -> List[dict]:
    """The frames test.txt does not name."""
    frames = meta["frames"]
    test_txt = capture_dir / "test.txt"
    if not test_txt.exists():
        return frames
    test = {ln.strip() for ln in test_txt.read_text().splitlines()
            if ln.strip()}
    return [fr for fr in frames if Path(fr["file_path"]).stem not in test]


def _frame_intrinsics(meta, fr):
    g = lambda k: fr.get(k, meta.get(k))  # noqa: E731
    return (float(g("fl_x")), float(g("fl_y")), float(g("cx")),
            float(g("cy")), int(g("w")), int(g("h")))


def _load_rgbd_frame(capture_dir: Path, meta, fr, depth_scale: float):
    """(rgb, depth (H, W, 1), OpenGL c2w (4, 4), fx, fy, cx, cy) of one
    frame, the intrinsics at the depth's resolution; None when its image
    or depth file is missing."""
    img_path = capture_dir / fr["file_path"]
    dp = fr.get("depth_file_path")
    depth_path = (capture_dir / dp) if dp else (
        capture_dir / "depth" / (Path(fr["file_path"]).stem + ".png"))
    if not img_path.exists() or not depth_path.exists():
        return None
    fx, fy, cx, cy, w, h = _frame_intrinsics(meta, fr)
    rgb = io.read_image(img_path)
    depth = io.read_depth(depth_path, depth_scale)
    dh, dw = depth.shape[:2]
    if rgb.shape[:2] != (dh, dw):
        rgb = io.resize_image(rgb, dh, dw)
    sx, sy = dw / w, dh / h
    c2w = np.array(fr["transform_matrix"], np.float64)
    if c2w.shape == (3, 4):
        c2w = np.concatenate([c2w, [[0, 0, 0, 1]]], 0)
    return rgb, depth, c2w, fx * sx, fy * sy, cx * sx, cy * sy


def _cap_frames(frames, max_frames):
    """At most `max_frames` frames, by a ceil stride."""
    if max_frames and len(frames) > max_frames:
        return frames[::-(-len(frames) // max_frames)]
    return frames


def backproject_rgbd_cloud(capture_dir: Path, num_points: int = 1_000_000,
                           depth_scale: float = 1e-3,
                           depth_trunc: float = 4.0,
                           voxel_dedup: float = 0.02,
                           with_normals: bool = True,
                           max_frames: Optional[int] = None, seed: int = 0,
                           device=None
                           ) -> Tuple[np.ndarray, np.ndarray,
                                      Optional[np.ndarray]]:
    """(points, colors, normals) fused from the train RGB-D frames: an
    equal share of each frame's valid pixels, one point a `voxel_dedup`
    voxel (unless that keeps under a quarter of `num_points`), resampled to
    `num_points`."""
    dev = resolve_device(device)
    meta = _load_frames_meta(capture_dir)
    frames = _cap_frames(_train_frames(capture_dir, meta), max_frames)
    rng = np.random.default_rng(seed)
    per_frame = (num_points + len(frames)) // max(len(frames), 1)

    pts_l, col_l, nrm_l = [], [], []
    for fr in frames:
        frame = _load_rgbd_frame(capture_dir, meta, fr, depth_scale)
        if frame is None:
            continue
        rgb, depth, c2w, fxd, fyd, cxd, cyd = frame
        depth = depth[..., 0]
        dh, dw = depth.shape
        c2w_cv = c2w @ OPENGL_TO_OPENCV
        us, vs = np.meshgrid(np.arange(dw) + 0.5, np.arange(dh) + 0.5)
        valid = (depth > 1e-4) & (depth < depth_trunc)
        z = depth[valid]
        pc = np.stack([(us[valid] - cxd) * z / fxd,
                       (vs[valid] - cyd) * z / fyd, z], -1)
        pw = pc @ c2w_cv[:3, :3].T + c2w_cv[:3, 3]
        nw = None
        if with_normals:
            n_cam = normal_from_depth_image(
                torch.as_tensor(depth, device=dev), fxd, fyd, cxd,
                cyd).cpu().numpy()
            nw = n_cam[valid] @ c2w_cv[:3, :3].T
        k = min(per_frame, len(pw))
        sel = (rng.choice(len(pw), k, replace=False) if len(pw) > k
               else np.arange(len(pw)))
        pts_l.append(pw[sel])
        col_l.append(rgb[valid][sel])
        if nw is not None:
            nrm_l.append(nw[sel])

    if not pts_l:
        raise FileNotFoundError(f"no RGB-D frames under {capture_dir}")
    pts = np.concatenate(pts_l).astype(np.float32)
    cols = np.concatenate(col_l).astype(np.float32)
    nrms = np.concatenate(nrm_l).astype(np.float32) if nrm_l else None
    if voxel_dedup and voxel_dedup > 0:
        key = np.floor(pts / voxel_dedup).astype(np.int64)
        _, first = np.unique(key, axis=0, return_index=True)
        if len(first) >= num_points // 4:  # keep the density otherwise
            pts, cols = pts[first], cols[first]
            if nrms is not None:
                nrms = nrms[first]
    return resample_to_num_points(pts, cols, nrms, num_points, seed)


def tsdf_fuse_frames(frames, voxel: float = 0.04, trunc: float = 0.2,
                     resolution_cap: int = 192, reach: float = 4.0,
                     device=None):
    """(vertices, faces, colours) of RGB-D frames, each (rgb, depth (H, W,
    1), OpenGL c2w, fx, fy, cx, cy), fused on `device` (None: the card) by
    mesh/tsdf.py in a dense volume over the cameras +- `reach`, at `voxel`
    or coarser so that no side exceeds `resolution_cap` voxels, and meshed
    on the host."""
    from dnsplatter_torch.mesh import tsdf as T

    if not frames:
        raise ValueError("no RGB-D frames to fuse")
    cams = np.stack([(np.asarray(fr[2], np.float64) @ OPENGL_TO_OPENCV)[:3, 3]
                     for fr in frames])
    lo, hi = cams.min(0) - reach, cams.max(0) + reach
    voxel = max(voxel, float(np.max(hi - lo)) / resolution_cap)
    cfg = T.TSDFConfig(voxel_size=voxel, sdf_trunc=max(trunc, 3 * voxel))
    vol = T.create_volume(lo, hi, cfg, device=device)
    for rgb, depth, c2w, fx, fy, cx, cy in frames:
        T.integrate(vol, depth, rgb, c2w, fx, fy, cx, cy, cfg)
    return T.extract_mesh(vol)


def tsdf_fused_cloud(capture_dir: Path, num_points: int = 1_000_000,
                     depth_scale: float = 1e-3, voxel: float = 0.04,
                     trunc: float = 0.2, max_frames: int = 60,
                     resolution_cap: int = 192, device=None
                     ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """The TSDF-fusion route (the reference's o3d ScalableTSDFVolume call,
    voxel 0.04 / trunc 0.2): `tsdf_fuse_frames` of the capture's train
    RGB-D frames, in its own frame (metres), sampled on the host; the
    samples carry the nearest vertex's colour and their face's normal."""
    from scipy.spatial import cKDTree

    from dnsplatter_torch.eval.mesh_metrics import sample_surface

    meta = _load_frames_meta(capture_dir)
    frames = _cap_frames(_train_frames(capture_dir, meta), max_frames)
    loaded = [f for f in (_load_rgbd_frame(capture_dir, meta, fr, depth_scale)
                          for fr in frames) if f is not None]
    if not loaded:
        raise FileNotFoundError(f"no RGB-D frames under {capture_dir}")
    verts, faces, colors = tsdf_fuse_frames(loaded, voxel, trunc,
                                            resolution_cap, device=device)
    if len(faces) == 0:
        raise RuntimeError("TSDF fusion produced an empty surface")
    pts, nrm = sample_surface(verts, faces, num_points, seed=0)
    _, vi = cKDTree(verts, compact_nodes=False).query(pts, k=1, workers=-1)
    return pts.astype(np.float32), colors[vi].astype(np.float32), nrm


def generate_iphone_pointcloud(capture_dir: Path, out_path: Path,
                               num_points: int = 1_000_000,
                               use_tsdf: bool = False,
                               depth_scale: float = 1e-3,
                               device=None) -> Path:
    """The MuSHRoom iphone / ScanNet++ iphone seed cloud from the RGB-D
    frames, written to `out_path` as PLY."""
    if use_tsdf:
        pts, cols, nrms = tsdf_fused_cloud(capture_dir, num_points,
                                           depth_scale, device=device)
    else:
        pts, cols, nrms = backproject_rgbd_cloud(
            capture_dir, num_points=num_points, depth_scale=depth_scale,
            device=device)
    io.write_ply(out_path, pts, colors=cols, normals=nrms)
    return out_path


def generate_kinect_pointcloud(capture_dir: Path, out_path: Path,
                               num_points: int = 1_000_000, seed: int = 0
                               ) -> Path:
    """The MuSHRoom kinect seed cloud from the per-frame SpectacularAI
    clouds: PointCloud/<name>.ply re-posed from the capture world
    (pose/<name>.txt, OpenGL) into the COLMAP frame, written as PLY."""
    meta = _load_frames_meta(capture_dir)
    frames = _train_frames(capture_dir, meta)
    rng = random.Random(seed)
    per_frame = (num_points + len(frames)) // max(len(frames), 1)

    pts_l, col_l, nrm_l = [], [], []
    for fr in frames:
        name = Path(fr["file_path"]).stem
        ply = capture_dir / "PointCloud" / f"{name}.ply"
        pose_txt = capture_dir / "pose" / f"{name}.txt"
        if not ply.exists() or not pose_txt.exists():
            continue
        cloud = io.read_ply(ply)
        pts = cloud["points"].astype(np.float64)
        # The OPENGL_TO_OPENCV factor does not cancel between the two
        # poses: the SpectacularAI pose and the COLMAP transform_matrix use
        # different camera conventions, and this conjugation is the
        # reference's.
        original_pose = np.loadtxt(pose_txt).reshape(4, 4) @ OPENGL_TO_OPENCV
        colmap_pose = np.array(fr["transform_matrix"], np.float64)
        if colmap_pose.shape == (3, 4):
            colmap_pose = np.concatenate([colmap_pose, [[0, 0, 0, 1]]], 0)
        m = colmap_pose @ np.linalg.inv(original_pose)
        pts = pts @ m[:3, :3].T + m[:3, 3]
        sel = np.asarray(rng.sample(range(len(pts)), min(per_frame,
                                                         len(pts))))
        pts_l.append(pts[sel])
        if "colors" in cloud:
            col_l.append(cloud["colors"][sel])
        if "normals" in cloud:
            nrm_l.append(cloud["normals"][sel] @ m[:3, :3].T)

    if not pts_l:
        raise FileNotFoundError(
            f"no PointCloud/pose frames under {capture_dir}")
    pts = np.concatenate(pts_l).astype(np.float32)
    cols = np.concatenate(col_l).astype(np.float32) if col_l else None
    nrms = np.concatenate(nrm_l).astype(np.float32) if nrm_l else None
    pts, cols, nrms = resample_to_num_points(pts, cols, nrms, num_points,
                                             seed)
    io.write_ply(out_path, pts, colors=cols, normals=nrms)
    return out_path
