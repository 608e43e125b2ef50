"""Mesh depth and attribute rendering with a z-buffer (counterpart of
dnsplatter_tpu/eval/mesh_render.py), in place of pyrender / OpenGL.

The reference renders ground-truth and predicted mesh depth from the train
poses with pyrender to visibility-cull meshes before scoring them (double
sided). Here the triangles rasterize on `device` (None: the card): each
face covers a bounded pixel window, is tested by barycentrics and written
into the z-buffer by a depth-min scatter (`scatter_reduce_(..., "amin")`),
which is exact and independent of the order. Faces are chunked and bucketed
by screen extent; a face too large for the largest window is split on the
host first, keeping only the pieces that can reach the image.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dnsplatter_torch import resolve_device
from dnsplatter_torch.mesh.tsdf import to_numpy

GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0])
# per window size: the screen extents (pixels) it takes, (lo, hi]
BUCKETS = {8: (-1.0, 6.0), 32: (6.0, 30.0), 128: (30.0, np.inf)}
MAX_EXTENT = 126.0  # a window covers [floor(min), floor(min) + win - 1]


def _camera_space(vertices, camera) -> np.ndarray:
    c2w_cv = to_numpy(camera.c2w, np.float64) @ GL_TO_CV
    return (np.asarray(vertices) - c2w_cv[:3, 3]) @ c2w_cv[:3, :3]


def _intrinsics(camera):
    return (float(camera.fx), float(camera.fy), float(camera.cx),
            float(camera.cy))


def _screen_extent(tri, fx, fy, cx, cy):
    """A conservative per-face screen bbox extent in pixels (camera space);
    faces touching or behind the near plane report 0 (the raster's valid
    mask rejects them anyway)."""
    z = np.maximum(tri[..., 2], 1e-6)
    px = tri[..., 0] * fx / z + cx
    py = tri[..., 1] * fy / z + cy
    ext = np.maximum(px.max(1) - px.min(1), py.max(1) - py.min(1))
    behind = (tri[..., 2] <= 1e-6).any(1)
    return np.where(behind, 0.0, ext)


def _can_write(tri, fx, fy, cx, cy, width, height):
    """Faces that can write a pixel: every vertex in front of the near
    plane (as the raster tests it, in float32) and a screen bbox that
    reaches the image (one pixel of slack for the raster's float32
    projection)."""
    front = (tri[..., 2].astype(np.float32) > 1e-6).all(1)
    z = np.maximum(tri[..., 2], 1e-6)
    px = tri[..., 0] * fx / z + cx
    py = tri[..., 1] * fy / z + cy
    return (front & (px.max(1) >= -1.0) & (px.min(1) <= width + 1.0)
            & (py.max(1) >= -1.0) & (py.min(1) <= height + 1.0))


def _split_large(tri, camera, fattr=None):
    """Midpoint-split faces wider than MAX_EXTENT pixels until they fit (a
    fixed window would cut a big triangle down to its corner and leave
    holes in the z-buffer); attributes are split alongside.

    Faces that cannot write a pixel (a vertex behind the near plane, or
    wholly off the image) are dropped first and after every round. The
    image is unchanged by it, and a face seen from close by splits into
    the pieces that land on the image only: split whole, one face 1 mm
    from the camera becomes up to 4^12 pieces, most of them off the image,
    which exhausts host memory on a room-sized mesh."""
    fx, fy, cx, cy = _intrinsics(camera)
    w, h = camera.width, camera.height

    def drop(tri, fattr):
        keep = _can_write(tri, fx, fy, cx, cy, w, h)
        return tri[keep], (fattr[keep] if fattr is not None else None)

    tri, fattr = drop(tri, fattr)
    for _ in range(12):  # halves the extent a round; 12 covers any scene
        big = _screen_extent(tri, fx, fy, cx, cy) > MAX_EXTENT
        if not big.any():
            break
        parts = [tri] if fattr is None else [tri, fattr]
        out = []
        for t in parts:
            b = t[big]
            m01 = 0.5 * (b[:, 0] + b[:, 1])
            m12 = 0.5 * (b[:, 1] + b[:, 2])
            m20 = 0.5 * (b[:, 2] + b[:, 0])
            out.append(np.concatenate([
                t[~big],
                np.stack([b[:, 0], m01, m20], 1),
                np.stack([m01, b[:, 1], m12], 1),
                np.stack([m20, m12, b[:, 2]], 1),
                np.stack([m01, m12, m20], 1),
            ]))
        tri, fattr = drop(out[0], out[1] if fattr is not None else None)
    return tri, fattr, _screen_extent(tri, fx, fy, cx, cy)


def _raster_windows(v0, v1, v2, fx, fy, cx, cy, width, height, win):
    """Per face and window pixel: (flat pixel index with width * height for
    off-image pixels, barycentrics b0, b1, b2, interpolated z, inside)."""
    def proj(v):
        z = torch.clamp(v[:, 2], min=1e-6)
        return torch.stack([v[:, 0] * fx / z + cx, v[:, 1] * fy / z + cy],
                           -1), v[:, 2]

    p0, z0 = proj(v0)
    p1, z1 = proj(v1)
    p2, z2 = proj(v2)
    valid = (v0[:, 2] > 1e-6) & (v1[:, 2] > 1e-6) & (v2[:, 2] > 1e-6)
    lo = torch.floor(torch.minimum(torch.minimum(p0, p1), p2)).int()
    oy, ox = torch.meshgrid(
        torch.arange(win, dtype=torch.int32, device=v0.device),
        torch.arange(win, dtype=torch.int32, device=v0.device),
        indexing="ij")
    pxi = lo[:, None, None, 0] + ox[None]
    pyi = lo[:, None, None, 1] + oy[None]
    px = pxi.float() + 0.5
    py = pyi.float() + 0.5

    def edge(a, b):
        # cross(b - a, p - a): positive for p left of a -> b
        return ((b[:, None, None, 0] - a[:, None, None, 0])
                * (py - a[:, None, None, 1])
                - (b[:, None, None, 1] - a[:, None, None, 1])
                * (px - a[:, None, None, 0]))

    area = ((p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1])
            - (p1[:, 1] - p0[:, 1]) * (p2[:, 0] - p0[:, 0]))[:, None, None]
    # dividing by the signed area makes the inside test double-sided
    area = torch.where(torch.abs(area) < 1e-12, 1e-12, area)
    b0 = edge(p1, p2) / area
    b1 = edge(p2, p0) / area
    b2 = edge(p0, p1) / area
    inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
    zc = (b0 * z0[:, None, None] + b1 * z1[:, None, None]
          + b2 * z2[:, None, None])
    on_img = (pxi >= 0) & (pxi < width) & (pyi >= 0) & (pyi < height)
    flat = torch.where(on_img, pyi * width + pxi, width * height).long()
    ok = inside & on_img & valid[:, None, None] & (zc > 1e-6)
    return flat, (b0, b1, b2), zc, ok


def _chunks(tri, ext, chunk, fattr=None):
    """(window, faces of the chunk, their attributes) over the buckets."""
    for win, (lo_b, hi_b) in BUCKETS.items():
        m = (ext > lo_b) & (ext <= hi_b)
        sel = tri[m]
        sattr = fattr[m] if fattr is not None else None
        step = max(256, chunk * 64 // (win * win))
        for s in range(0, len(sel), step):
            yield win, sel[s:s + step], (
                sattr[s:s + step] if sattr is not None else None)


@torch.no_grad()
def render_mesh_depth(vertices: np.ndarray, faces: np.ndarray, camera,
                      chunk: int = 1 << 16, device=None) -> np.ndarray:
    """(H, W) z-depth of the mesh from `camera` (inf where no surface)."""
    dev = resolve_device(device)
    tri = _camera_space(vertices, camera)[faces].astype(np.float64)
    fx, fy, cx, cy = _intrinsics(camera)
    tri, _, ext = _split_large(tri, camera)
    w, h = camera.width, camera.height
    zbuf = torch.full((w * h + 1,), float("inf"), device=dev)
    for win, sel, _ in _chunks(tri, ext, chunk):
        t = torch.as_tensor(sel, dtype=torch.float32, device=dev)
        flat, _, zc, ok = _raster_windows(t[:, 0], t[:, 1], t[:, 2], fx, fy,
                                          cx, cy, w, h, win)
        zbuf.scatter_reduce_(0, torch.where(ok, flat, w * h).reshape(-1),
                             torch.where(ok, zc, float("inf")).reshape(-1),
                             "amin")
    return zbuf[:-1].reshape(h, w).cpu().numpy()


@torch.no_grad()
def render_mesh_attributes(vertices: np.ndarray, faces: np.ndarray,
                           vertex_attrs: np.ndarray, camera,
                           chunk: int = 1 << 16, device=None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-vertex attributes (e.g. normals) interpolated by barycentrics:
    (depth (H, W), attrs (H, W, C), zeros where no surface). A z-buffer pass
    first, then a resolve pass keeps the attributes of the faces whose depth
    matches the buffer (the pyrender / pytorch3d role in the reference's
    ground-truth normal renderers)."""
    dev = resolve_device(device)
    zimg = render_mesh_depth(vertices, faces, camera, chunk, device=dev)
    tri = _camera_space(vertices, camera)[faces].astype(np.float64)
    attrs = np.asarray(vertex_attrs, np.float32)
    if attrs.ndim == 1:
        attrs = attrs[:, None]
    fx, fy, cx, cy = _intrinsics(camera)
    tri, fattr, ext = _split_large(tri, camera, attrs[faces])
    w, h = camera.width, camera.height
    cdim = fattr.shape[-1]
    zflat = torch.cat([torch.as_tensor(zimg.reshape(-1), device=dev),
                       torch.full((1,), float("inf"), device=dev)])
    abuf = torch.zeros((w * h + 1, cdim), device=dev)
    for win, sel, sattr in _chunks(tri, ext, chunk, fattr):
        t = torch.as_tensor(sel, dtype=torch.float32, device=dev)
        a = torch.as_tensor(sattr, dtype=torch.float32, device=dev)
        flat, (b0, b1, b2), zc, ok = _raster_windows(
            t[:, 0], t[:, 1], t[:, 2], fx, fy, cx, cy, w, h, win)
        ok = ok & (zc <= zflat[flat] * (1.0 + 1e-4) + 1e-5)
        attr = (b0[..., None] * a[:, None, None, 0, :]
                + b1[..., None] * a[:, None, None, 1, :]
                + b2[..., None] * a[:, None, None, 2, :])
        idx = torch.where(ok, flat, w * h).reshape(-1)
        abuf.index_put_((idx,), attr.reshape(-1, cdim))
    return zimg, abuf[:-1].reshape(h, w, cdim).cpu().numpy()


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted unit per-vertex normals (the trimesh / Open3D
    compute_vertex_normals role)."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    n = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.maximum(n, 1e-12)).astype(np.float32)
