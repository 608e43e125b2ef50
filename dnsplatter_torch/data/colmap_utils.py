"""COLMAP model reader: cameras, images and points3D in the binary and the
text format (counterpart of dnsplatter_tpu/data/colmap_utils.py; numpy, on
the host), with the quaternion and camera conversions the dataparsers use.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

import numpy as np

from dnsplatter_torch.data.distortion import colmap_distortion


class ColmapCamera(NamedTuple):
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific


class ColmapImage(NamedTuple):
    qvec: np.ndarray  # (4,) wxyz world-to-camera rotation
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (M, 2) keypoints
    point3d_ids: np.ndarray  # (M,)


# model id -> (name, parameter count), as COLMAP numbers them
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def rotmat_to_qvec(r: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a rotation matrix, by COLMAP's own eigenvector
    formulation (read_write_model.py rotmat2qvec), w >= 0."""
    rxx, ryx, rzx, rxy, ryy, rzy, rxz, ryz, rzz = np.asarray(r).flat
    k = np.array([
        [rxx - ryy - rzz, 0, 0, 0],
        [ryx + rxy, ryy - rxx - rzz, 0, 0],
        [rzx + rxz, rzy + ryz, rzz - rxx - ryy, 0],
        [ryz - rzy, rzx - rxz, rxy - ryx, rxx + ryy + rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(k)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def read_cameras_bin(path: Path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cam_id, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, n_params = _CAMERA_MODELS[model_id]
            params = np.array(struct.unpack(f"<{n_params}d",
                                            f.read(8 * n_params)))
            cams[cam_id] = ColmapCamera(name, int(w), int(h), params)
    return cams


def read_images_bin(path: Path) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            img_id = struct.unpack("<i", f.read(4))[0]
            q = np.array(struct.unpack("<4d", f.read(32)))
            t = np.array(struct.unpack("<3d", f.read(24)))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            (m,) = struct.unpack("<Q", f.read(8))
            raw = np.frombuffer(f.read(24 * m), dtype="<f8").reshape(m, 3)
            # each keypoint is (x double, y double, point3D id int64)
            ids = np.frombuffer(np.ascontiguousarray(raw[:, 2]).tobytes(),
                                dtype="<i8")
            imgs[img_id] = ColmapImage(q, t, cam_id, name.decode("utf-8"),
                                       raw[:, :2].copy(), ids)
    return imgs


def read_points3d_bin(path: Path
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(xyz (N, 3), rgb (N, 3) in [0, 1], error (N,))."""
    xyzs, rgbs, errs = [], [], []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            data = struct.unpack("<Q3d3Bd", f.read(43))
            xyzs.append(data[1:4])
            rgbs.append(data[4:7])
            errs.append(data[7])
            (track_len,) = struct.unpack("<Q", f.read(8))
            f.read(8 * track_len)
    return (np.array(xyzs, np.float32), np.array(rgbs, np.float32) / 255.0,
            np.array(errs, np.float32))


def camera_distortion(cam: ColmapCamera):
    """(params (6,) in [k1, k2, k3, k4, p1, p2] order or None,
    camera_type) of a COLMAP camera, for data/distortion.undistort_image."""
    return colmap_distortion(cam.model, cam.params)


def camera_intrinsics(cam: ColmapCamera
                      ) -> Tuple[float, float, float, float]:
    """(fx, fy, cx, cy); the distortion is `camera_distortion`'s."""
    p = cam.params
    if cam.model == "SIMPLE_PINHOLE" or cam.model.startswith("SIMPLE_RADIAL"):
        return float(p[0]), float(p[0]), float(p[1]), float(p[2])
    if cam.model in ("PINHOLE", "OPENCV", "FULL_OPENCV", "OPENCV_FISHEYE"):
        return float(p[0]), float(p[1]), float(p[2]), float(p[3])
    if cam.model == "RADIAL":
        return float(p[0]), float(p[0]), float(p[1]), float(p[2])
    raise ValueError(f"unsupported camera model {cam.model}")


def image_c2w_opengl(img: ColmapImage) -> np.ndarray:
    """COLMAP's world-to-camera (OpenCV) -> (4, 4) OpenGL camera-to-world."""
    rot = qvec_to_rotmat(img.qvec)
    c2w = np.eye(4)
    c2w[:3, :3] = rot.T
    c2w[:3, 3] = -rot.T @ img.tvec
    c2w[:3, 1:3] *= -1  # OpenCV -> OpenGL: flip the y and z camera axes
    return c2w


def read_cameras_txt(path: Path) -> Dict[int, ColmapCamera]:
    cams = {}
    for line in Path(path).read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        parts = line.split()
        cams[int(parts[0])] = ColmapCamera(
            parts[1], int(parts[2]), int(parts[3]),
            np.array([float(x) for x in parts[4:]]))
    return cams


def read_images_txt(path: Path) -> Dict[int, ColmapImage]:
    imgs = {}
    # Two lines an image. The second (POINTS2D) may be empty for an image
    # with no triangulated observation, so blank lines are kept to keep the
    # pairing aligned.
    lines = [ln for ln in Path(path).read_text().splitlines()
             if not ln.startswith("#")]
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1  # a stray blank between records
            continue
        parts = lines[i].split()
        imgs[int(parts[0])] = ColmapImage(
            np.array([float(x) for x in parts[1:5]]),
            np.array([float(x) for x in parts[5:8]]), int(parts[8]),
            parts[9], np.zeros((0, 2)), np.zeros((0,), np.int64))
        i += 2
    return imgs


def read_points3d_txt(path: Path):
    """(xyz (N, 3), rgb (N, 3) in [0, 1], None)."""
    xyzs, rgbs = [], []
    for line in Path(path).read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        p = line.split()
        xyzs.append([float(p[1]), float(p[2]), float(p[3])])
        rgbs.append([float(p[4]), float(p[5]), float(p[6])])
    return (np.array(xyzs, np.float32), np.array(rgbs, np.float32) / 255.0,
            None)


def read_model(sparse_dir: Path):
    """(cameras, images, points xyz, points rgb) of a COLMAP model
    directory: the binary files where present, else the text ones."""
    sparse_dir = Path(sparse_dir)
    if (sparse_dir / "cameras.bin").exists():
        cams = read_cameras_bin(sparse_dir / "cameras.bin")
        imgs = read_images_bin(sparse_dir / "images.bin")
        pts_path, read_pts = sparse_dir / "points3D.bin", read_points3d_bin
    else:
        cams = read_cameras_txt(sparse_dir / "cameras.txt")
        imgs = read_images_txt(sparse_dir / "images.txt")
        pts_path, read_pts = sparse_dir / "points3D.txt", read_points3d_txt
    xyz, rgb, _ = read_pts(pts_path) if pts_path.exists() else (None,) * 3
    return cams, imgs, xyz, rgb
