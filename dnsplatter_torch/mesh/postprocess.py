"""Mesh post-processing: clustering, smoothing, quadric decimation
(counterpart of dnsplatter_tpu/mesh/postprocess.py, host numpy in both
packages).

The reference gets these from Open3D:
  * connected-triangle clustering + small-cluster removal
    (export_mesh.py:1026-1039 — Open3DTSDFFusion keeps clusters with at
    least max(50th-largest size, 50) triangles, then drops unreferenced
    vertices and degenerate triangles);
  * `filter_smooth_laplacian()` rounds on the SuGaR Poisson meshes
    (export_mesh.py:681-693);
  * `simplify_quadric_decimation(target_triangles)` on the marching /
    TSDF meshes (export_mesh.py:811-813, 917-919).

Host-side numpy implementations (offline export path, like the
reference's Open3D calls): sort-based union-find over shared edges for
clustering, uniform-weight Laplacian smoothing (Open3D's default
lambda = 0.5, 1 iteration per call), and Garland-Heckbert quadric
error-metric edge collapse for decimation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import heapq

import numpy as np


# ---------------------------------------------------------------------------
# connected components
# ---------------------------------------------------------------------------


def _uf_find(parent: np.ndarray, i: int) -> int:
    root = i
    while parent[root] != root:
        root = parent[root]
    while parent[i] != root:  # path compression
        parent[i], i = root, parent[i]
    return root


def cluster_connected_triangles(
    faces: np.ndarray, verts: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cluster triangles connected via shared edges.

    Returns (cluster_idx (F,), cluster_n_triangles (K,), cluster_area (K,))
    — the Open3D `cluster_connected_triangles` contract. `cluster_area`
    is zeros when `verts` is not given.
    """
    f = np.asarray(faces, np.int64)
    nf = len(f)
    if nf == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int64),
                np.zeros(0, np.float64))
    # undirected edge keys per triangle (3 per face)
    ea = np.concatenate([f[:, 0], f[:, 1], f[:, 2]])
    eb = np.concatenate([f[:, 1], f[:, 2], f[:, 0]])
    lo = np.minimum(ea, eb)
    hi = np.maximum(ea, eb)
    nv = int(hi.max()) + 1 if len(hi) else 0
    key = lo * nv + hi
    tri = np.tile(np.arange(nf, dtype=np.int64), 3)
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    tri_s = tri[order]
    # union consecutive triangles sharing the same edge key
    parent = np.arange(nf, dtype=np.int64)
    same = key_s[1:] == key_s[:-1]
    for i in np.nonzero(same)[0]:
        ra = _uf_find(parent, int(tri_s[i]))
        rb = _uf_find(parent, int(tri_s[i + 1]))
        if ra != rb:
            parent[rb] = ra
    roots = np.array([_uf_find(parent, i) for i in range(nf)], np.int64)
    uniq, cluster_idx = np.unique(roots, return_inverse=True)
    sizes = np.bincount(cluster_idx, minlength=len(uniq)).astype(np.int64)
    areas = np.zeros(len(uniq), np.float64)
    if verts is not None:
        v = np.asarray(verts, np.float64)
        cr = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        a = 0.5 * np.linalg.norm(cr, axis=1)
        np.add.at(areas, cluster_idx, a)
    return cluster_idx.astype(np.int32), sizes, areas


def remove_unreferenced_vertices(
    verts: np.ndarray, faces: np.ndarray, *extras: Optional[np.ndarray]
):
    """Drop vertices not used by any face; remap faces. Extra per-vertex
    arrays (colors, normals) are filtered the same way (None passthrough)."""
    f = np.asarray(faces, np.int64)
    used = np.zeros(len(verts), bool)
    if len(f):
        used[f.reshape(-1)] = True
    remap = np.cumsum(used) - 1
    new_f = remap[f] if len(f) else f
    out_extras = tuple(e[used] if e is not None else None for e in extras)
    out = (np.asarray(verts)[used], new_f.astype(np.int32)) + out_extras
    return out


def remove_degenerate_triangles(faces: np.ndarray) -> np.ndarray:
    """Drop faces with repeated vertex indices (Open3D semantics)."""
    f = np.asarray(faces)
    ok = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
    return f[ok]


def remove_small_clusters(
    verts: np.ndarray,
    faces: np.ndarray,
    colors: Optional[np.ndarray] = None,
    keep_top: int = 50,
    min_triangles: int = 50,
):
    """Open3DTSDFFusion cleanup (export_mesh.py:1026-1039): keep clusters
    with >= max(size of the `keep_top`-th largest cluster, `min_triangles`)
    triangles, then drop unreferenced vertices and degenerate faces.

    Returns (verts, faces, colors) — colors is None when not given.
    """
    f = np.asarray(faces, np.int64)
    if len(f) == 0:
        return np.asarray(verts), f.astype(np.int32), colors
    cluster_idx, sizes, _ = cluster_connected_triangles(f)
    srt = np.sort(sizes)
    thresh = srt[-keep_top] if len(srt) >= keep_top else srt[0]
    thresh = max(int(thresh), min_triangles)
    keep = sizes[cluster_idx] >= thresh
    f = remove_degenerate_triangles(f[keep])
    verts, f, colors = remove_unreferenced_vertices(verts, f, colors)
    return verts, f, colors


# ---------------------------------------------------------------------------
# Laplacian smoothing
# ---------------------------------------------------------------------------


def filter_smooth_laplacian(
    verts: np.ndarray,
    faces: np.ndarray,
    number_of_iterations: int = 1,
    lam: float = 0.5,
) -> np.ndarray:
    """Uniform-weight Laplacian smoothing — Open3D
    `filter_smooth_laplacian` defaults (1 iteration, lambda 0.5):
    v' = v + lam * (mean(edge neighbors) - v)."""
    v = np.asarray(verts, np.float64).copy()
    f = np.asarray(faces, np.int64)
    if len(f) == 0 or len(v) == 0:
        return v.astype(np.float32)
    src = np.concatenate([f[:, 0], f[:, 1], f[:, 2], f[:, 1], f[:, 2],
                          f[:, 0]])
    dst = np.concatenate([f[:, 1], f[:, 2], f[:, 0], f[:, 0], f[:, 1],
                          f[:, 2]])
    # dedupe directed edges so boundary/interior weighting matches the
    # neighbor-set definition
    nv = len(v)
    key = src * nv + dst
    uniq = np.unique(key)
    src = (uniq // nv).astype(np.int64)
    dst = (uniq % nv).astype(np.int64)
    deg = np.bincount(src, minlength=nv).astype(np.float64)
    safe = np.maximum(deg, 1.0)
    for _ in range(number_of_iterations):
        acc = np.zeros_like(v)
        np.add.at(acc, src, v[dst])
        mean = acc / safe[:, None]
        upd = v + lam * (mean - v)
        v = np.where((deg > 0)[:, None], upd, v)
    return v.astype(np.float32)


# ---------------------------------------------------------------------------
# quadric decimation (Garland-Heckbert)
# ---------------------------------------------------------------------------


def _face_quadrics(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """(F, 4, 4) fundamental error quadrics Kp = p p^T for face planes."""
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-30)
    d = -np.sum(n * v[f[:, 0]], axis=1, keepdims=True)
    p = np.concatenate([n, d], axis=1)  # (F, 4)
    return p[:, :, None] * p[:, None, :]


def _pair_cost(q: np.ndarray, va: np.ndarray, vb: np.ndarray):
    """Best collapse target among {endpoint a, b, midpoint, quadric
    optimum}; returns (cost, position)."""
    a2 = q[:3, :3]
    b2 = q[:3, 3]
    cands = [va, vb, 0.5 * (va + vb)]
    # optimal point: solve A x = -b (A = upper-left 3x3 of the quadric)
    det = np.linalg.det(a2)
    if abs(det) > 1e-12:
        try:
            cands.append(np.linalg.solve(a2, -b2))
        except np.linalg.LinAlgError:
            pass
    best_c, best_p = np.inf, va
    for p in cands:
        ph = np.append(p, 1.0)
        c = float(ph @ q @ ph)
        if c < best_c:
            best_c, best_p = c, p
    return best_c, best_p


def simplify_quadric_decimation(
    verts: np.ndarray,
    faces: np.ndarray,
    target_number_of_triangles: int,
):
    """Garland-Heckbert edge-collapse decimation to (at most) the target
    triangle count — the Open3D `simplify_quadric_decimation` role
    (export_mesh.py:811-813, 917-919). Returns (verts, faces).

    Vertex quadrics accumulate face-plane quadrics; edges collapse in
    min-cost heap order to the best of {endpoints, midpoint, quadric
    optimum}. Collapses that flip a surviving face's orientation are
    rejected (standard consistency check)."""
    v = np.asarray(verts, np.float64).copy()
    f = np.asarray(faces, np.int64).copy()
    f = remove_degenerate_triangles(f)
    nf = len(f)
    if nf <= target_number_of_triangles or nf == 0:
        return v.astype(np.float32), f.astype(np.int32)

    nv = len(v)
    kq = _face_quadrics(v, f)
    q = np.zeros((nv, 4, 4))
    for k in range(3):
        np.add.at(q, f[:, k], kq)

    # adjacency: vertex -> set of face ids; faces mutate in place
    vfaces = [set() for _ in range(nv)]
    for fi, tri in enumerate(f):
        for vi in tri:
            vfaces[vi].add(fi)
    alive_f = np.ones(nf, bool)
    # union-find over vertices (collapse a<-b redirects b)
    parent = np.arange(nv, dtype=np.int64)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    edges = set()
    for tri in f:
        for a, b in ((tri[0], tri[1]), (tri[1], tri[2]), (tri[2], tri[0])):
            edges.add((min(a, b), max(a, b)))
    heap = []
    version = {}
    for (a, b) in edges:
        c, p = _pair_cost(q[a] + q[b], v[a], v[b])
        version[(a, b)] = 0
        heapq.heappush(heap, (c, a, b, 0, p))

    n_alive = nf
    while n_alive > target_number_of_triangles and heap:
        cost, a, b, ver, pos = heapq.heappop(heap)
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        if version.get((min(a, b), max(a, b)), -1) != ver or (
                ra != a or rb != b):
            # Stale entry (outdated cost, or an endpoint collapsed away).
            # Discard: every collapse refreshes ALL surviving incident
            # edges of the merged vertex with bumped versions, so the
            # re-keyed edge already has a live entry.
            continue
        # orientation check: no surviving face may flip
        affected = (vfaces[a] | vfaces[b])
        flip = False
        for fi in affected:
            if not alive_f[fi]:
                continue
            tri = f[fi]
            if (tri == a).any() and (tri == b).any():
                continue  # will degenerate and be removed
            old = v[tri]
            n_old = np.cross(old[1] - old[0], old[2] - old[0])
            new = old.copy()
            for k in range(3):
                if tri[k] == a or tri[k] == b:
                    new[k] = pos
            n_new = np.cross(new[1] - new[0], new[2] - new[0])
            if np.dot(n_old, n_new) <= 0:
                flip = True
                break
        if flip:
            continue
        # collapse b -> a at pos
        parent[b] = a
        v[a] = pos
        q[a] = q[a] + q[b]
        for fi in list(vfaces[b]):
            if not alive_f[fi]:
                continue
            tri = f[fi]
            f[fi] = np.where(tri == b, a, tri)
            tri = f[fi]
            if tri[0] == tri[1] or tri[1] == tri[2] or tri[0] == tri[2]:
                alive_f[fi] = False
                n_alive -= 1
                for vi in set(int(x) for x in tri):
                    vfaces[vi].discard(fi)
            else:
                vfaces[a].add(fi)
        vfaces[b] = set()
        # refresh a's incident edges
        nbrs = set()
        for fi in vfaces[a]:
            if alive_f[fi]:
                for vi in f[fi]:
                    if vi != a:
                        nbrs.add(int(vi))
        for nb in nbrs:
            key = (min(a, nb), max(a, nb))
            nver = version.get(key, 0) + 1
            version[key] = nver
            c, p = _pair_cost(q[a] + q[nb], v[a], v[nb])
            heapq.heappush(heap, (c, key[0], key[1], nver, p))

    f_out = f[alive_f]
    v_out, f_out = remove_unreferenced_vertices(v, f_out)[:2]
    return v_out.astype(np.float32), f_out.astype(np.int32)
