"""Pose normalization: auto-orient, center and scale (counterpart of
dnsplatter_tpu/data/poses.py; numpy, on the host).

nerfstudio's `auto_orient_and_center_poses` and `auto_scale_poses`, as
every dataparser applies them. Poses are (N, 4, 4) OpenGL camera-to-world.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The minimal rotation matrix taking unit vector a to unit vector b."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if c < -1.0 + 1e-8:  # antiparallel: a half turn about any normal axis
        ortho = (np.array([1.0, 0, 0]) if abs(a[0]) < 0.9
                 else np.array([0, 1.0, 0]))
        axis = np.cross(a, ortho)
        axis /= np.linalg.norm(axis)
        return 2.0 * np.outer(axis, axis) - np.eye(3)
    k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]],
                 np.float64)
    return np.eye(3) + k + k @ k / (1.0 + c)


def auto_orient_and_center_poses(poses: np.ndarray, method: str = "up",
                                 center_method: str = "poses"
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(oriented poses (N, 4, 4), the applied transform (3, 4)), float32.
    'up' turns the mean camera up axis onto +z; 'poses' and 'focus' both
    center on the mean camera origin."""
    poses = np.asarray(poses, np.float64)
    if center_method in ("poses", "focus"):
        translation = poses[:, :3, 3].mean(axis=0)
    elif center_method == "none":
        translation = np.zeros(3)
    else:
        raise ValueError(center_method)
    if method == "up":
        up = poses[:, :3, 1].mean(axis=0)
        up /= np.linalg.norm(up)
        rot = rotation_between(up, np.array([0.0, 0.0, 1.0]))
    elif method == "none":
        rot = np.eye(3)
    else:
        raise ValueError(method)
    transform = np.concatenate([rot, rot @ -translation[:, None]], axis=1)
    full = np.concatenate([transform, [[0, 0, 0, 1]]], axis=0)
    oriented = np.einsum("ij,njk->nik", full, poses)
    return oriented.astype(np.float32), transform.astype(np.float32)


def auto_scale(poses: np.ndarray, extra_scale: float = 1.0
               ) -> Tuple[np.ndarray, float]:
    """Scale the translations so the largest |component| is 1, times
    `extra_scale`; returns (poses, scale)."""
    s = 1.0 / max(float(np.max(np.abs(poses[:, :3, 3]))), 1e-8)
    s *= extra_scale
    poses = poses.copy()
    poses[:, :3, 3] *= s
    return poses, s


def apply_transform_to_points(points: np.ndarray, transform: np.ndarray,
                              scale: float) -> np.ndarray:
    """The dataparser's (3, 4) transform, then its scale, on world points."""
    return (points @ transform[:3, :3].T + transform[:3, 3]) * scale
