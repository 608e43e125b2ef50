"""Monocular-depth scale/shift alignment (counterpart of
dnsplatter_tpu/scripts/align_depth.py; host numpy in both packages).

Parity: dn_splatter/scripts/align_depth.py — align relative mono depths to
metric scale using either
  * sparse SfM depths: project COLMAP points3D into each frame, solve the
    closed-form weighted least squares for (scale, shift)
    (align_depth.py:190-210, the monosdf recipe), or
  * dense sensor depth: per-frame gradient descent on (scale, shift)
    (depth_from_pretrain.py:89-144) — here an exact closed-form solve,
    since least squares in 2 unknowns needs no Adam.

Outputs `<name>_aligned.npy` files next to the inputs, the format every
dataparser expects (mono_depth/*_aligned.npy).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def closed_form_scale_shift(
    pred: np.ndarray, target: np.ndarray, weights: Optional[np.ndarray] = None
) -> Tuple[float, float]:
    """Solve min_{s,t} sum w (s*pred + t - target)^2 in closed form.

    Parity: align_depth.py:190-210 (weighted normal equations).
    """
    pred = pred.reshape(-1).astype(np.float64)
    target = target.reshape(-1).astype(np.float64)
    w = (
        weights.reshape(-1).astype(np.float64)
        if weights is not None
        else np.ones_like(pred)
    )
    a00 = np.sum(w * pred * pred)
    a01 = np.sum(w * pred)
    a11 = np.sum(w)
    b0 = np.sum(w * pred * target)
    b1 = np.sum(w * target)
    det = a00 * a11 - a01 * a01
    if abs(det) < 1e-12:
        return 1.0, 0.0
    s = (a11 * b0 - a01 * b1) / det
    t = (a00 * b1 - a01 * b0) / det
    return float(s), float(t)


def align_mono_to_sensor(
    mono: np.ndarray, sensor: np.ndarray, min_depth: float = 0.1,
    max_depth: float = 10.0,
) -> np.ndarray:
    """Align one mono-depth map to a sensor depth map (valid-pixel WLS)."""
    valid = (sensor > min_depth) & (sensor < max_depth) & (mono > 0)
    if valid.sum() < 16:
        return mono
    s, t = closed_form_scale_shift(mono[valid], sensor[valid])
    return (s * mono + t).astype(np.float32)


def sfm_depths_for_frame(
    points3d: np.ndarray,
    c2w_gl: np.ndarray,
    fx: float, fy: float, cx: float, cy: float,
    width: int, height: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Project SfM points into a frame: (pixel (M,2) int, z (M,)) of the
    points landing inside the image with positive depth."""
    c2w_cv = c2w_gl @ np.diag([1.0, -1.0, -1.0, 1.0])
    w2c_rot = c2w_cv[:3, :3].T
    p_cam = (points3d - c2w_cv[:3, 3]) @ w2c_rot.T
    z = p_cam[:, 2]
    ok = z > 1e-6
    u = p_cam[:, 0] * fx / z + cx
    v = p_cam[:, 1] * fy / z + cy
    ok &= (u >= 0) & (u < width) & (v >= 0) & (v < height)
    return (
        np.stack([u[ok], v[ok]], -1).astype(np.int32),
        z[ok].astype(np.float32),
    )


def align_mono_to_sfm(
    mono: np.ndarray,
    pix: np.ndarray,
    sfm_z: np.ndarray,
) -> np.ndarray:
    """Align a mono depth map to sparse SfM depths at known pixels."""
    if len(sfm_z) < 8:
        return mono
    m = mono[pix[:, 1], pix[:, 0]]
    ok = m > 0
    s, t = closed_form_scale_shift(m[ok], sfm_z[ok])
    return (s * mono + t).astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Align mono_depth/*.npy to sensor depth or COLMAP SfM"
    )
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--mono-dir", type=Path, default=None)
    p.add_argument("--sensor-dir", type=Path, default=None)
    p.add_argument("--colmap-path", type=Path, default=None)
    p.add_argument("--depth-unit", type=float, default=1e-3)
    args = p.parse_args(argv)

    mono_dir = args.mono_dir or args.data / "mono_depth"
    monos = sorted(mono_dir.glob("*.npy"))
    monos = [m for m in monos if not m.stem.endswith("_aligned")]

    aligned = 0
    if args.colmap_path:
        from dnsplatter_torch.data import colmap_utils as cu

        cams, imgs, xyz, _ = cu.read_model(args.data / args.colmap_path)
        # match by filename STEM: COLMAP registers only a subset of
        # frames, and positional pairing would shift every mono map after
        # the first dropout onto another frame's SfM depths
        by_stem = {Path(im.name).stem: im for im in imgs.values()}
        for mono_path in monos:
            im = by_stem.get(mono_path.stem)
            if im is None:
                print(f"  skipping {mono_path.name}: not registered in "
                      "the COLMAP model")
                continue
            mono = np.load(mono_path).astype(np.float32)
            cam = cams[im.camera_id]
            fx, fy, cx, cy = cu.camera_intrinsics(cam)
            pix, z = sfm_depths_for_frame(
                xyz, cu.image_c2w_opengl(im), fx, fy, cx, cy,
                cam.width, cam.height,
            )
            out = align_mono_to_sfm(mono, pix, z)
            np.save(mono_path.with_name(mono_path.stem + "_aligned.npy"), out)
            aligned += 1
    else:
        from dnsplatter_torch.data import io

        sensor_dir = args.sensor_dir or args.data / "depth"
        by_stem = {q.stem: q for q in sensor_dir.glob("*") if q.is_file()}
        for mono_path in monos:
            sensor_path = by_stem.get(mono_path.stem)
            if sensor_path is None:
                print(f"  skipping {mono_path.name}: no matching sensor "
                      "depth")
                continue
            mono = np.load(mono_path).astype(np.float32)
            sensor = io.read_depth(sensor_path, args.depth_unit)[..., 0]
            out = align_mono_to_sensor(mono, sensor)
            np.save(mono_path.with_name(mono_path.stem + "_aligned.npy"), out)
            aligned += 1
    print(f"aligned {aligned} of {len(monos)} depth maps")


if __name__ == "__main__":
    main()
