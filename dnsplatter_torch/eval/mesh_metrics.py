"""Visibility-culled mesh evaluation (counterpart of
dnsplatter_tpu/eval/mesh_metrics.py).

Parity: dn_splatter/eval/eval_mesh_vis_cull.py — the protocol used for
every mesh table in the reference:

  1. subdivide both meshes to max edge length 0.015 (:270-290)
  2. render each mesh's depth from the training poses (here with the
     z-buffer renderer of eval/mesh_render.py on `device`, None: the card,
     instead of pyrender) and cull faces that are never
     seen, occluded (behind the rendered depth + tolerance), or outside
     the scene bounds (`cull_mesh`, :176-267)
  3. sample point clouds from both culled surfaces and compute
     Acc (mean pred->gt), Comp (mean gt->pred), Chamfer-L1,
     Normal-Consistency (mean |cos| to the NN's normal), and F-score at
     5 cm (`compute_metrics`, :333-398)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from dnsplatter_torch.eval.mesh_render import render_mesh_depth
from dnsplatter_torch.mesh.tsdf import to_numpy
from dnsplatter_torch.ops.camera import Camera


def subdivide_to_edge_length(
    vertices: np.ndarray, faces: np.ndarray, max_edge: float = 0.015,
    max_iters: int = 10,
) -> Tuple[np.ndarray, np.ndarray]:
    """Midpoint-subdivide faces until every edge is <= max_edge."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    for _ in range(max_iters):
        e = v[f]  # (F, 3, 3)
        el = np.stack(
            [
                np.linalg.norm(e[:, 0] - e[:, 1], axis=1),
                np.linalg.norm(e[:, 1] - e[:, 2], axis=1),
                np.linalg.norm(e[:, 2] - e[:, 0], axis=1),
            ],
            1,
        )
        big = el.max(1) > max_edge
        if not big.any():
            break
        keep = f[~big]
        split = f[big]
        # 4-way midpoint split (shared midpoints merged afterwards)
        m01 = (v[split[:, 0]] + v[split[:, 1]]) / 2
        m12 = (v[split[:, 1]] + v[split[:, 2]]) / 2
        m20 = (v[split[:, 2]] + v[split[:, 0]]) / 2
        base = len(v)
        nsp = len(split)
        v = np.concatenate([v, m01, m12, m20])
        i01 = base + np.arange(nsp)
        i12 = base + nsp + np.arange(nsp)
        i20 = base + 2 * nsp + np.arange(nsp)
        newf = np.concatenate(
            [
                keep,
                np.stack([split[:, 0], i01, i20], 1),
                np.stack([i01, split[:, 1], i12], 1),
                np.stack([i20, i12, split[:, 2]], 1),
                np.stack([i01, i12, i20], 1),
            ]
        )
        f = newf
    # merge duplicate vertices (midpoints of shared edges)
    vr = np.round(v / 1e-7).astype(np.int64)
    _, uniq_idx, inv = np.unique(vr, axis=0, return_index=True,
                                 return_inverse=True)
    v = v[uniq_idx]
    f = inv[f]
    return v.astype(np.float32), f.astype(np.int32)


def compact_mesh(vertices: np.ndarray, faces: np.ndarray,
                 face_keep: np.ndarray):
    """Drop faces where ~face_keep and compact to the used vertex set."""
    f = faces[face_keep]
    used = np.zeros(len(vertices), bool)
    used[f] = True
    remap = np.cumsum(used) - 1
    return vertices[used], remap[f].astype(np.int32)


def cull_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    cameras: List[Camera],
    depth_tolerance: float = 0.05,
    bounds: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Remove faces never visible from the training cameras.

    A vertex is 'seen' by a camera if it projects inside the image with
    positive depth and is not occluded by the mesh's own rendered depth
    (z <= rendered + tolerance). Faces with no seen vertex — or outside
    `bounds` — are culled (eval_mesh_vis_cull.py:176-267).
    """
    seen = np.zeros(len(vertices), bool)
    for cam in cameras:
        zimg = render_mesh_depth(vertices, faces, cam, device=device)
        c2w_cv = to_numpy(cam.c2w) @ np.diag([1.0, -1.0, -1.0, 1.0])
        v_cam = (vertices - c2w_cv[:3, 3]) @ c2w_cv[:3, :3]
        z = v_cam[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = v_cam[:, 0] * float(cam.fx) / z + float(cam.cx)
            vv = v_cam[:, 1] * float(cam.fy) / z + float(cam.cy)
        inside = (
            (z > 1e-6)
            & (u >= 0) & (u < cam.width) & (vv >= 0) & (vv < cam.height)
        )
        ui = np.clip(u.astype(np.int64), 0, cam.width - 1)
        vi = np.clip(vv.astype(np.int64), 0, cam.height - 1)
        rendered = zimg[vi, ui]
        visible = inside & (z <= rendered + depth_tolerance)
        seen |= visible
    if bounds is not None:
        lo, hi = bounds
        inb = ((vertices >= lo) & (vertices <= hi)).all(1)
        seen &= inb
    face_keep = seen[faces].any(1)
    return compact_mesh(vertices, faces, face_keep)


def sample_surface(
    vertices: np.ndarray, faces: np.ndarray, n: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Area-weighted surface samples + their face normals."""
    rng = np.random.default_rng(seed)
    tri = vertices[faces]
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=1)
    nrm = cross / np.maximum(np.linalg.norm(cross, axis=1, keepdims=True),
                             1e-12)
    probs = area / max(area.sum(), 1e-12)
    fi = rng.choice(len(faces), size=n, p=probs)
    r1 = np.sqrt(rng.uniform(size=(n, 1)))
    r2 = rng.uniform(size=(n, 1))
    a, b, c = tri[fi, 0], tri[fi, 1], tri[fi, 2]
    pts = (1 - r1) * a + r1 * (1 - r2) * b + r1 * r2 * c
    return pts.astype(np.float32), nrm[fi].astype(np.float32)


def compute_metrics(
    pred_v: np.ndarray, pred_f: np.ndarray,
    gt_v: np.ndarray, gt_f: np.ndarray,
    num_samples: int = 200_000,
    fscore_thresh: float = 0.05,
) -> Dict[str, float]:
    """Acc / Comp / Chamfer-L1 / NormalConsistency / F-score@thresh
    (eval_mesh_vis_cull.py:333-398)."""
    from scipy.spatial import cKDTree

    p_pts, p_nrm = sample_surface(pred_v, pred_f, num_samples, seed=0)
    g_pts, g_nrm = sample_surface(gt_v, gt_f, num_samples, seed=1)

    gt_tree = cKDTree(g_pts, compact_nodes=False)
    d_p2g, i_p2g = gt_tree.query(p_pts, k=1, workers=-1)
    pred_tree = cKDTree(p_pts, compact_nodes=False)
    d_g2p, i_g2p = pred_tree.query(g_pts, k=1, workers=-1)

    acc = float(d_p2g.mean())
    comp = float(d_g2p.mean())
    nc_p = np.abs((p_nrm * g_nrm[i_p2g]).sum(1)).mean()
    nc_g = np.abs((g_nrm * p_nrm[i_g2p]).sum(1)).mean()
    precision = float((d_p2g < fscore_thresh).mean())
    recall = float((d_g2p < fscore_thresh).mean())
    fscore = (
        2 * precision * recall / max(precision + recall, 1e-12)
    )
    return {
        "acc": acc,
        "comp": comp,
        "chamfer_l1": 0.5 * (acc + comp),
        "normal_consistency": float(0.5 * (nc_p + nc_g)),
        "precision": precision,
        "recall": recall,
        "fscore": fscore,
    }


def evaluate_mesh(
    pred_v, pred_f, gt_v, gt_f, cameras: List[Camera],
    max_edge: float = 0.015,
    depth_tolerance: float = 0.05,
    num_samples: int = 200_000,
    subdivide: bool = True,
    device=None,
) -> Dict[str, float]:
    """Full visibility-culled protocol over both meshes."""
    if subdivide:
        pred_v, pred_f = subdivide_to_edge_length(pred_v, pred_f, max_edge)
        gt_v, gt_f = subdivide_to_edge_length(gt_v, gt_f, max_edge)
    pred_v, pred_f = cull_mesh(pred_v, pred_f, cameras, depth_tolerance,
                               device=device)
    gt_v, gt_f = cull_mesh(gt_v, gt_f, cameras, depth_tolerance,
                           device=device)
    if len(pred_f) == 0 or len(gt_f) == 0:
        return {"acc": float("inf"), "comp": float("inf"),
                "chamfer_l1": float("inf"), "normal_consistency": 0.0,
                "precision": 0.0, "recall": 0.0, "fscore": 0.0}
    return compute_metrics(pred_v, pred_f, gt_v, gt_f, num_samples)
