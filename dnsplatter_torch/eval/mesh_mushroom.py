"""MuSHRoom mesh evaluation protocol: ICP align, footprint cut, cull
(counterpart of dnsplatter_tpu/eval/mesh_mushroom.py; the z-buffer renders
run on `device`, None: the card).

Parity: dn_splatter/eval/eval_mesh_mushroom_vis_cull.py (725 LoC) — the
protocol behind the paper's MuSHRoom reconstruction tables:

  1. align: the Faro gt mesh is brought into the capture frame with the
     inverse of the icp_{device}.json transform (:653-666); when the json
     is absent we compute it with our own ICP (eval/icp.py) instead of
     requiring the shipped file.
  2. cut: the predicted mesh is cropped to the gt mesh's 2D footprint in
     the xy / xz / yz projections (`cut_mesh`, :459-483): gt vertices are
     rasterized into a 500x500 occupancy image, dilated with a
     `kernel_size` box, and pred vertices must fall inside the filled
     outer contour. (The reference extracts cv2 external contours and
     point-in-polygon tests them; rasterizing + flood-filling the same
     image is equivalent at the same 500-cell resolution and keeps this
     dependency-free.)
  3. cull: both meshes are subdivided to max edge 0.015 and
     visibility-culled from the long-capture train poses with
     missing-depth and occlusion handling (`cull_mesh` via go-surf,
     :511-559): per-vertex observation counts, invalid when the gt
     sensor depth is missing, face kept when any vertex has > 3
     observations and not (invalid > 0.7 * observed) for all vertices.
  4. metrics: the shared Acc/Comp/Chamfer/NC/F-score suite
     (eval/mesh_metrics.py).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from dnsplatter_torch.eval import mesh_metrics as MM
from dnsplatter_torch.eval.icp import icp, load_icp_json, transform_points
from dnsplatter_torch.eval.mesh_render import render_mesh_depth
from dnsplatter_torch.mesh.tsdf import to_numpy
from dnsplatter_torch.ops.camera import Camera

_GRID = 500


def _binary_dilate(img: np.ndarray, k: int) -> np.ndarray:
    """Box dilation with a k x k ones kernel (cv2.dilate equivalent)."""
    from scipy.ndimage import binary_dilation

    return binary_dilation(img, structure=np.ones((k, k), bool))


def _fill_outer(img: np.ndarray) -> np.ndarray:
    """True inside the outer contour: complement of the background flood
    fill from the border (matplotlib Path.contains_point on cv2
    RETR_EXTERNAL contours keeps interior holes — so do we)."""
    from scipy.ndimage import label

    bg = ~img
    lab, _ = label(bg)
    border_labels = np.unique(
        np.concatenate([lab[0, :], lab[-1, :], lab[:, 0], lab[:, -1]])
    )
    border_labels = border_labels[border_labels != 0]
    outside = np.isin(lab, border_labels)
    return ~outside


def footprint_mask_2d(gt_2d: np.ndarray, kernel_size: int = 15,
                      dilate: bool = True):
    """(mask, min_val, max_val): 500x500 filled footprint of gt points."""
    min_val = gt_2d.min(0)
    max_val = gt_2d.max(0)
    span = np.maximum(max_val - min_val, 1e-9)
    # round (not floor): must match _inside_footprint's nearest-cell
    # lookup or boundary vertices fall into unmarked cells
    ij = np.round((gt_2d - min_val) / span * (_GRID - 1)).astype(np.int64)
    img = np.zeros((_GRID, _GRID), bool)
    img[ij[:, 1], ij[:, 0]] = True
    if kernel_size > 1:
        if dilate:
            img = _binary_dilate(img, kernel_size)
    return _fill_outer(img), min_val, span


def _inside_footprint(pts_2d: np.ndarray, mask, min_val, span) -> np.ndarray:
    ij = ((pts_2d - min_val) / span * (_GRID - 1))
    # half-cell slack: points exactly on the footprint bounds (common when
    # pred geometry coincides with gt walls) must not fall out to fp noise
    valid = (
        (ij[:, 0] >= -0.5) & (ij[:, 0] <= _GRID - 0.5)
        & (ij[:, 1] >= -0.5) & (ij[:, 1] <= _GRID - 0.5)
    )
    ii = np.clip(np.round(ij[:, 1]).astype(np.int64), 0, _GRID - 1)
    jj = np.clip(np.round(ij[:, 0]).astype(np.int64), 0, _GRID - 1)
    return valid & mask[ii, jj]


def cut_mesh(
    gt_vertices: np.ndarray,
    pred_v: np.ndarray,
    pred_f: np.ndarray,
    kernel_size: int = 15,
    dilate: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Crop pred mesh to the gt footprint in xy, xz, and yz projections
    (eval_mesh_mushroom_vis_cull.py:459-483)."""
    keep = np.ones(len(pred_v), bool)
    for axes in ((0, 1), (0, 2), (1, 2)):
        mask, mn, span = footprint_mask_2d(
            gt_vertices[:, axes], kernel_size, dilate
        )
        keep &= _inside_footprint(pred_v[:, axes], mask, mn, span)
    face_keep = keep[pred_f].all(1)
    return MM.compact_mesh(pred_v, pred_f, face_keep)


def cull_mesh_mushroom(
    vertices: np.ndarray,
    faces: np.ndarray,
    cameras: List[Camera],
    gt_depths: Optional[List[np.ndarray]] = None,
    depth_tolerance: float = 0.05,
    obs_threshold: int = 3,
    invalid_ratio: float = 0.7,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """go-surf grid culling (eval_mesh_mushroom_vis_cull.py:510-596):
    count per-vertex observations (visible, unoccluded) and invalid
    observations (gt sensor depth missing at the pixel); keep a face iff
    any vertex has obs > obs_threshold and NOT all vertices have
    invalid > invalid_ratio * obs."""
    obs = np.zeros(len(vertices), np.int32)
    inv = np.zeros(len(vertices), np.int32)
    for i, cam in enumerate(cameras):
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
        obs += visible
        if gt_depths is not None:
            gd = to_numpy(gt_depths[i])
            if gd.ndim == 3:
                gd = gd[..., 0]
            missing = gd[vi, ui] <= 0.0
            inv += (visible & missing).astype(np.int32)
    o = obs[faces]
    seen_face = (o > obs_threshold).any(1)
    if gt_depths is not None:
        iv = inv[faces]
        invalid_face = (iv > invalid_ratio * np.maximum(o, 1)).all(1)
    else:
        invalid_face = np.zeros(len(faces), bool)
    face_keep = seen_face & ~invalid_face
    return MM.compact_mesh(vertices, faces, face_keep)


def evaluate_mesh_mushroom(
    pred_v: np.ndarray,
    pred_f: np.ndarray,
    gt_v: np.ndarray,
    gt_f: np.ndarray,
    cameras: List[Camera],
    gt_depths: Optional[List[np.ndarray]] = None,
    icp_transform: Optional[np.ndarray] = None,
    icp_json: Optional[Path] = None,
    max_edge: float = 0.015,
    kernel_size: int = 15,
    num_samples: int = 200_000,
    subdivide: bool = True,
    obs_threshold: int = 3,
    device=None,
) -> Dict[str, float]:
    """Full MuSHRoom protocol (eval_mesh_mushroom_vis_cull.py:599-717).

    `icp_transform` is the capture->Faro registration (the shipped
    icp_{device}.json); gt is brought into the capture frame with its
    inverse. When neither `icp_transform` nor `icp_json` is given, the
    registration is computed here with point-to-point ICP between vertex
    samples (coarse init from centroids).
    """
    if icp_transform is None and icp_json is not None and Path(icp_json).exists():
        icp_transform = load_icp_json(icp_json)
    if icp_transform is None:
        init = np.eye(4)
        init[:3, 3] = pred_v.mean(0) - gt_v.mean(0)
        # gt -> capture frame directly (this IS inv(gt_transformation))
        inv_t, icp_rmse = icp(gt_v, pred_v, init=init,
                              max_correspondence_distance=0.3)
        if not np.isfinite(icp_rmse) or icp_rmse > 0.15:
            import warnings

            warnings.warn(
                f"mesh_mushroom: fallback point-to-point ICP converged "
                f"poorly (rmse {icp_rmse:.3f} m) — downstream metrics may "
                "be meaningless; supply the shipped icp_{device}.json "
                "(the reference protocol) or a global registration init.",
                stacklevel=2,
            )
    else:
        inv_t = np.linalg.inv(np.asarray(icp_transform))
    gt_v = transform_points(np.asarray(gt_v, np.float64), inv_t)

    pred_v, pred_f = cut_mesh(gt_v, np.asarray(pred_v, np.float64),
                              np.asarray(pred_f), kernel_size)
    if subdivide:
        pred_v, pred_f = MM.subdivide_to_edge_length(pred_v, pred_f, max_edge)
        gt_v, gt_f = MM.subdivide_to_edge_length(gt_v, gt_f, max_edge)
    pred_v, pred_f = cull_mesh_mushroom(pred_v, pred_f, cameras, gt_depths,
                                        obs_threshold=obs_threshold,
                                        device=device)
    gt_v, gt_f = cull_mesh_mushroom(gt_v, gt_f, cameras, gt_depths,
                                    obs_threshold=obs_threshold,
                                    device=device)
    if len(pred_f) == 0 or len(gt_f) == 0:
        return {"acc": float("inf"), "comp": float("inf"),
                "chamfer_l1": float("inf"), "normal_consistency": 0.0,
                "precision": 0.0, "recall": 0.0, "fscore": 0.0}
    return MM.compute_metrics(pred_v, pred_f, gt_v, gt_f, num_samples)
