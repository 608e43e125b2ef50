"""Marching tetrahedra isosurface extraction (vectorized numpy; counterpart
of dnsplatter_tpu/mesh/marching.py, host code in both packages).

Replaces PyMCubes (export_mesh.py:716,778) with a self-contained
isosurfacer. Each grid cell is split into 6 tetrahedra; each tetrahedron
contributes 0, 1, or 2 triangles depending on its 4-bit sign case —
a 16-case table that is small enough to write down exactly (unlike the
256-case marching-cubes table). Produces watertight, consistent meshes;
slightly more triangles than classic MC at the same resolution.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# 6-tetrahedra decomposition of a cube (indices into the 8 cube corners).
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    np.int32,
)

# Cube corner offsets (x, y, z).
_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    np.int32,
)

# The 6 edges of a tetrahedron as (corner a, corner b) local indices.
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32
)

# For each of the 16 sign cases (bit i set = vertex i inside), the list of
# triangles as triples of tet-edge indices (-1 padded, max 2 triangles).
# Orientation: consistent outward normals for the standard tet ordering.
_TET_TRIS = -np.ones((16, 2, 3), np.int32)
_TET_TRIS[0b0001, 0] = [0, 2, 1]
_TET_TRIS[0b1110, 0] = [0, 1, 2]
_TET_TRIS[0b0010, 0] = [0, 3, 4]
_TET_TRIS[0b1101, 0] = [0, 4, 3]
_TET_TRIS[0b0100, 0] = [1, 5, 3]
_TET_TRIS[0b1011, 0] = [1, 3, 5]
_TET_TRIS[0b1000, 0] = [2, 4, 5]
_TET_TRIS[0b0111, 0] = [2, 5, 4]
_TET_TRIS[0b0011] = [[1, 3, 2], [2, 3, 4]]
_TET_TRIS[0b1100] = [[1, 2, 3], [2, 4, 3]]
_TET_TRIS[0b0101] = [[0, 2, 5], [0, 5, 3]]
_TET_TRIS[0b1010] = [[0, 5, 2], [0, 3, 5]]
_TET_TRIS[0b0110] = [[0, 1, 5], [0, 5, 4]]
_TET_TRIS[0b1001] = [[0, 5, 1], [0, 4, 5]]


def marching_tetrahedra(field: np.ndarray, level: float = 0.0,
                        backend: str = "auto",
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the `level` isosurface of a (Nx, Ny, Nz) scalar field.

    Returns (vertices (V, 3) in grid coordinates, faces (F, 3) int32).
    Vertices on shared edges are merged (watertight topology).
    backend: "auto" prefers the native C++ module (dnsplatter_torch.native)
    and falls back to the vectorized numpy path; "native" raises when the
    module cannot be built; "numpy" skips it.
    """
    if backend in ("auto", "native"):
        from dnsplatter_torch import native

        out = native.marching_tetrahedra_native(np.asarray(field, np.float32),
                                                level)
        if out is not None:
            return out
        if backend == "native":
            raise RuntimeError("native meshing backend unavailable: "
                               f"{native.build_error()}")
    nx, ny, nz = field.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    f = field - level

    # Corner values for all cells via 8 SHIFTED VIEWS of f — building a
    # (C, 8, 3) index tensor for the whole grid first would peak at ~8 GB
    # for a 320^3 export before the active filter prunes it.
    vals_grid = np.empty((nx - 1, ny - 1, nz - 1, 8), f.dtype)
    for k, (dx, dy, dz) in enumerate(_CORNERS):
        vals_grid[..., k] = f[dx:nx - 1 + dx, dy:ny - 1 + dy,
                              dz:nz - 1 + dz]
    inside = vals_grid < 0
    active = inside.any(-1) & (~inside).any(-1)  # (nx-1, ny-1, nz-1)
    ai, aj, ak = np.nonzero(active)
    if len(ai) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    cells = np.stack([ai, aj, ak], -1)  # (C, 3) active cells only
    vals = vals_grid[ai, aj, ak]  # (C, 8)
    del vals_grid, inside
    corner_idx = cells[:, None, :] + _CORNERS[None, :, :]

    c = len(cells)
    # Per tetrahedron: (C, 6 tets, 4) corner ids + values.
    tet_corner = corner_idx[:, _TETS, :]  # (C, 6, 4, 3)
    tet_vals = vals[:, _TETS]  # (C, 6, 4)
    case = (
        (tet_vals[..., 0] < 0).astype(np.int32)
        | ((tet_vals[..., 1] < 0) << 1)
        | ((tet_vals[..., 2] < 0) << 2)
        | ((tet_vals[..., 3] < 0) << 3)
    )  # (C, 6)

    tris = _TET_TRIS[case]  # (C, 6, 2, 3) edge indices or -1
    has_tri = tris[..., 0] >= 0  # (C, 6, 2)
    ci, ti, ki = np.nonzero(has_tri)
    if len(ci) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    tri_edges = tris[ci, ti, ki]  # (T, 3) tet-edge ids

    # Resolve each tri edge to a global grid edge key + interpolated vertex.
    ea = _TET_EDGES[tri_edges][..., 0]  # (T, 3) local corner a
    eb = _TET_EDGES[tri_edges][..., 1]
    ca = tet_corner[ci, ti]  # (T, 4, 3)
    va = tet_vals[ci, ti]  # (T, 4)
    pa = ca[np.arange(len(ci))[:, None], ea]  # (T, 3, 3) int corner coords
    pb = ca[np.arange(len(ci))[:, None], eb]
    fa = va[np.arange(len(ci))[:, None], ea]  # (T, 3)
    fb = va[np.arange(len(ci))[:, None], eb]

    t = fa / np.where(np.abs(fa - fb) < 1e-12, 1e-12, fa - fb)
    t = np.clip(t, 0.0, 1.0)[..., None]
    verts = pa.astype(np.float64) + t * (pb - pa)  # (T, 3, 3)

    # Merge duplicate vertices by canonical (min corner, max corner) key.
    key_a = (pa[..., 0] * ny + pa[..., 1]) * nz + pa[..., 2]
    key_b = (pb[..., 0] * ny + pb[..., 1]) * nz + pb[..., 2]
    lo = np.minimum(key_a, key_b).astype(np.int64)
    hi = np.maximum(key_a, key_b).astype(np.int64)
    edge_key = lo * (nx * ny * nz) + hi  # unique per grid edge
    flat_keys = edge_key.reshape(-1)
    uniq, inv = np.unique(flat_keys, return_inverse=True)
    vmerged = np.zeros((len(uniq), 3), np.float64)
    vmerged[inv] = verts.reshape(-1, 3)
    faces = inv.reshape(-1, 3).astype(np.int32)

    # Drop degenerate faces; flip winding so normals point OUT of the
    # negative (inside) region (verified on an analytic sphere SDF).
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return vmerged.astype(np.float32), faces[ok][:, [0, 2, 1]]


def filter_faces_to_observed(
    verts: np.ndarray, faces: np.ndarray, observed: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Keep only faces whose grid cube has all 8 corners observed.

    Substituting +1 for unobserved TSDF voxels creates a phantom shell at
    the back of every truncation band (the sign flips back to + one voxel
    behind the surface). Open3D's ScalableTSDFVolume only meshes fully
    observed cubes; this post-filter reproduces that exactly — each face
    lies strictly inside one cube (its centroid floors to it), so
    cube-level filtering after extraction equals masked extraction, and
    keeps the fast native marching path usable.

    Returns (verts, faces, kept_vertex_indices) — callers remap
    per-vertex attributes with the index array."""
    if len(faces) == 0:
        return verts, faces, np.zeros((0,), np.int64)
    obs = np.asarray(observed, bool)
    cube_ok = obs[:-1, :-1, :-1]
    for dx, dy, dz in _CORNERS[1:]:
        nx, ny, nz = obs.shape
        cube_ok = cube_ok & obs[dx:nx - 1 + dx, dy:ny - 1 + dy,
                                dz:nz - 1 + dz]
    centroid = verts[faces].mean(axis=1)
    ci = np.clip(np.floor(centroid).astype(np.int64), 0,
                 np.asarray(cube_ok.shape) - 1)
    keep_f = cube_ok[ci[:, 0], ci[:, 1], ci[:, 2]]
    f = faces[keep_f]
    used = np.zeros(len(verts), bool)
    used[f] = True
    remap = np.cumsum(used) - 1
    idx = np.nonzero(used)[0]
    return verts[used], remap[f].astype(np.int32), idx
