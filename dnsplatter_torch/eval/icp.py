"""Iterative Closest Point registration (counterpart of
dnsplatter_tpu/eval/icp.py; numpy and scipy, on the host).

MuSHRoom ships icp_{iphone,kinect}.json files holding the SE(3)
("gt_transformation") that registers a capture's reconstruction frame to
the Faro laser frame; the point-cloud metrics apply it before comparing.
`icp` computes one when the file is absent: point-to-point or
point-to-plane, with correspondences trimmed at a distance (the Open3D
`registration_icp` recipe).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def _best_rigid_transform(src: np.ndarray, dst: np.ndarray,
                          weights: Optional[np.ndarray] = None
                          ) -> np.ndarray:
    """The closed-form (Kabsch, no scale) SE(3) minimizing
    sum w |R s + t - d|^2."""
    if weights is None:
        weights = np.ones(len(src))
    w = weights / max(weights.sum(), 1e-12)
    mu_s = (src * w[:, None]).sum(0)
    mu_d = (dst * w[:, None]).sum(0)
    h = ((src - mu_s) * w[:, None]).T @ (dst - mu_d)
    u, _, vt = np.linalg.svd(h)
    sgn = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, sgn]) @ u.T
    m = np.eye(4)
    m[:3, :3] = r
    m[:3, 3] = mu_d - r @ mu_s
    return m


def _point_to_plane_step(src: np.ndarray, dst: np.ndarray,
                         dst_normals: np.ndarray,
                         weights: np.ndarray) -> np.ndarray:
    """One linearized point-to-plane solve: the small (rx, ry, rz, t)
    minimizing sum w ((R s + t - d) . n)^2 with R ~ I + [r]_x."""
    n = dst_normals
    b = -((src - dst) * n).sum(1)
    a = np.concatenate([np.cross(src, n), n], axis=1)  # (N, 6)
    aw = a * weights[:, None]
    try:
        x = np.linalg.solve(aw.T @ a + 1e-9 * np.eye(6), aw.T @ b)
    except np.linalg.LinAlgError:
        return np.eye(4)
    rx, ry, rz = x[:3]
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    m = np.eye(4)
    m[:3, :3] = (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
                 @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                 @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))
    m[:3, 3] = x[3:]
    return m


def icp(source: np.ndarray, target: np.ndarray,
        init: Optional[np.ndarray] = None, max_iterations: int = 50,
        max_correspondence_distance: float = 0.1,
        method: str = "point_to_point",
        target_normals: Optional[np.ndarray] = None,
        tolerance: float = 1e-7, max_points: int = 100_000, seed: int = 0
        ) -> Tuple[np.ndarray, float]:
    """Register `source` onto `target`: (4x4 transform, rmse of the
    correspondences within `max_correspondence_distance` under it).

    Clouds above `max_points` are subsampled with a Generator of `seed`.
    Each iteration takes nearest neighbours from a KD-tree, trims them at
    the distance, and solves in closed form ("point_to_point") or by the
    linearized normal distance ("point_to_plane", needs `target_normals`).
    """
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    source = np.asarray(source, np.float64)
    target = np.asarray(target, np.float64)
    if len(source) > max_points:
        source = source[rng.choice(len(source), max_points, replace=False)]
    if len(target) > max_points:
        keep = rng.choice(len(target), max_points, replace=False)
        target = target[keep]
        if target_normals is not None:
            target_normals = np.asarray(target_normals)[keep]
    if method == "point_to_plane" and target_normals is None:
        raise ValueError("point_to_plane needs target_normals")

    # Uncompacted nodes give the same nearest neighbours; compacted ones
    # made the searches 5-80x slower on surface-like clouds queried from
    # off the surface (chip_smoke.py's MuSHRoom phase).
    tree = cKDTree(target, compact_nodes=False)

    transform = np.eye(4) if init is None else np.asarray(init, np.float64)
    cur = source @ transform[:3, :3].T + transform[:3, 3]
    prev_rmse = rmse = np.inf
    for _ in range(max_iterations):
        dist, idx = tree.query(cur, k=1, workers=-1)
        keep = dist < max_correspondence_distance
        if keep.sum() < 6:
            break
        w = np.ones(int(keep.sum()))
        if method == "point_to_plane":
            delta = _point_to_plane_step(cur[keep], target[idx[keep]],
                                         target_normals[idx[keep]], w)
        else:
            delta = _best_rigid_transform(cur[keep], target[idx[keep]], w)
        transform = delta @ transform
        cur = source @ transform[:3, :3].T + transform[:3, 3]
        rmse = float(np.sqrt((dist[keep] ** 2).mean()))
        if abs(prev_rmse - rmse) < tolerance:
            break
        prev_rmse = rmse
    # the residuals of the returned transform (the loop's are one update
    # stale: measured before the last delta)
    dist, _ = tree.query(cur, k=1, workers=-1)
    keep = dist < max_correspondence_distance
    if keep.any():
        rmse = float(np.sqrt((dist[keep] ** 2).mean()))
    return transform, rmse


def load_icp_json(path: Path) -> np.ndarray:
    """The (4, 4) transform of an icp_{mode}.json."""
    with open(path) as f:
        data = json.load(f)
    return np.array(data["gt_transformation"], np.float64).reshape(4, 4)


def save_icp_json(path: Path, transform: np.ndarray) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"gt_transformation":
                   np.asarray(transform).reshape(-1).tolist()}, f)


def transform_points(points: np.ndarray, transform: np.ndarray
                     ) -> np.ndarray:
    t = np.asarray(transform)
    return points @ t[:3, :3].T + t[:3, 3]
