"""Lens distortion: OpenCV polynomial and equidistant fisheye (counterpart
of dnsplatter_tpu/data/distortion.py).

The rasterizer is pinhole-only, so a distorted image is resampled onto the
pinhole grid when it is loaded: for every undistorted output pixel, the
forward model gives the source pixel in the captured image (the recipe of
cv2.undistort). Parameter order is nerfstudio's `distortion_params`:
[k1, k2, k3, k4, p1, p2]. Points are undistorted by fixed-point iteration
(the recipe of cv2.undistortPoints), and COLMAP camera models map onto that
order. Plain numpy: it runs once per frame on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def distort_normalized(xn: np.ndarray, yn: np.ndarray, params: np.ndarray,
                       camera_type: str = "perspective"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The forward distortion model on normalized camera coordinates."""
    k1, k2, k3, k4, p1, p2 = [float(p) for p in params]
    if camera_type == "fisheye":
        r = np.sqrt(xn * xn + yn * yn)
        theta = np.arctan(r)
        theta_d = theta * (1.0 + k1 * theta**2 + k2 * theta**4
                           + k3 * theta**6 + k4 * theta**8)
        scale = np.where(r > 1e-8, theta_d / np.maximum(r, 1e-8), 1.0)
        return xn * scale, yn * scale
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    xd = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
    return xd, yd


def undistort_points(u: np.ndarray, v: np.ndarray, fx: float, fy: float,
                     cx: float, cy: float, params: np.ndarray,
                     camera_type: str = "perspective", iters: int = 20
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Undistorted pixel coordinates of distorted ones, by `iters`
    fixed-point steps on the forward model."""
    xd = (np.asarray(u, np.float64) - cx) / fx
    yd = (np.asarray(v, np.float64) - cy) / fy
    xn, yn = xd.copy(), yd.copy()
    for _ in range(iters):
        xdd, ydd = distort_normalized(xn, yn, params, camera_type)
        xn = xn + (xd - xdd)
        yn = yn + (yd - ydd)
    return xn * fx + cx, yn * fy + cy


def _sample_bilinear(img: np.ndarray, x: np.ndarray, y: np.ndarray
                     ) -> np.ndarray:
    h, w = img.shape[:2]
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0c, x1c = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
    y0c, y1c = np.clip(y0, 0, h - 1), np.clip(y0 + 1, 0, h - 1)
    top = img[y0c, x0c] * (1 - wx) + img[y0c, x1c] * wx
    bot = img[y1c, x0c] * (1 - wx) + img[y1c, x1c] * wx
    return top * (1 - wy) + bot * wy


def undistort_image(img: np.ndarray, fx: float, fy: float, cx: float,
                    cy: float, params: np.ndarray,
                    camera_type: str = "perspective", nearest: bool = False,
                    fill: float = 0.0) -> np.ndarray:
    """Resample a distorted (H, W[, C]) image onto the pinhole grid:
    bilinear for rgb and normals, nearest for depth and label channels;
    pixels whose source lies outside the captured image get `fill`."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    us, vs = np.meshgrid(np.arange(w, dtype=np.float64) + 0.5,
                         np.arange(h, dtype=np.float64) + 0.5, indexing="xy")
    xd, yd = distort_normalized((us - cx) / fx, (vs - cy) / fy, params,
                                camera_type)
    sx = xd * fx + cx - 0.5
    sy = yd * fy + cy - 0.5
    inside = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    if nearest:
        xi = np.clip(np.round(sx).astype(np.int64), 0, w - 1)
        yi = np.clip(np.round(sy).astype(np.int64), 0, h - 1)
        out = img[yi, xi]
    else:
        out = _sample_bilinear(img.astype(np.float64), sx, sy)
    out = np.where(inside[..., None], out, fill).astype(img.dtype)
    return out[..., 0] if squeeze else out


def colmap_distortion(model: str, params: np.ndarray):
    """A COLMAP camera model's parameters -> (the (6,) nerfstudio-order
    params, camera_type); (None, 'perspective') for the pinhole models. A
    model with no equivalent here raises rather than pass as a pinhole."""
    p = np.asarray(params, np.float64)
    z6 = np.zeros(6)
    if model in ("SIMPLE_PINHOLE", "PINHOLE"):
        return None, "perspective"
    if model == "SIMPLE_RADIAL":
        z6[0] = p[3]
        return z6, "perspective"
    if model == "RADIAL":
        z6[0], z6[1] = p[3], p[4]
        return z6, "perspective"
    if model == "OPENCV":  # fx fy cx cy k1 k2 p1 p2
        z6[0], z6[1], z6[4], z6[5] = p[4], p[5], p[6], p[7]
        return z6, "perspective"
    if model == "FULL_OPENCV":
        # fx fy cx cy k1 k2 p1 p2 k3 k4 k5 k6: k3 is a numerator term and
        # kept; k4-k6 are the rational model's denominator, which the
        # polynomial model cannot express, and are dropped
        z6[0], z6[1], z6[2] = p[4], p[5], p[8]
        z6[4], z6[5] = p[6], p[7]
        return z6, "perspective"
    if model == "OPENCV_FISHEYE":  # fx fy cx cy k1 k2 k3 k4
        z6[:4] = p[4:8]
        return z6, "fisheye"
    if model in ("SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
        z6[0] = p[3]
        if len(p) > 4:
            z6[1] = p[4]
        return z6, "fisheye"
    raise ValueError(
        f"unsupported COLMAP camera model {model!r}: refusing to silently "
        "treat it as a distortion-free pinhole")
