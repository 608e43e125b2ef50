"""Two-pass normal-weighted TSDF fusion, the AGS-Mesh mesher (counterpart of
dnsplatter_tpu/mesh/isofusion.py).

Parity target: dn_splatter/scripts/isooctree_dn.py. The AGS-Mesh mesher
evaluates a multi-frame TSDF isoFunc with a two-pass normal-weighted
fusion: pass 1 picks a per-voxel reference normal from the best-aligned
frames; pass 2 fuses TSDF observations weighted by view/normal agreement,
skipping back-facing observations (hole avoidance), with a depth-validity
mask from relative depth deltas. `fuse_normal_weighted` fuses a dense grid
on `device` (None: the card); `make_isofunc` gives the point-wise isoFunc
the adaptive octree (mesh/octree.py) evaluates near the surface only.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from dnsplatter_torch import resolve_device
from dnsplatter_torch.mesh import tsdf as tsdf_lib


@dataclasses.dataclass(frozen=True)
class IsoFusionConfig:
    voxel_size: float = 0.02
    tsdf_rel: float = 3.0  # truncation = tsdf_rel * voxel_size
    back_mask_dot: float = 0.1  # skip observations this anti-aligned
    min_weight: float = 1.0
    depth_validity_rel: float = 0.1  # relative delta for validity mask
    chunk: int = 1 << 18


def depth_validity_mask(depth: np.ndarray, rel: float = 0.1) -> np.ndarray:
    """Reject pixels whose depth jumps by > rel * depth against a
    neighbour."""
    d = depth[..., 0] if depth.ndim == 3 else depth
    ok = d > 0
    # edge-clamped neighbour differences: a wrap-around would compare the
    # first row against the last
    pad = np.pad(d, 1, mode="edge")
    for nb in (pad[:-2, 1:-1], pad[2:, 1:-1], pad[1:-1, :-2], pad[1:-1, 2:]):
        ok &= np.abs(nb - d) <= rel * np.maximum(d, 1e-6)
    return ok


def _observe(centers, fr, trunc):
    """One frame's observations of world points: (sdf, surface normal,
    unit ray, valid)."""
    z, ui, vi, in_img = tsdf_lib.project(centers, fr["w2c"], fr["fx"],
                                         fr["fy"], fr["cx"], fr["cy"],
                                         fr["h"], fr["w"])
    d = fr["depth"][vi, ui]
    ok = in_img & (d > 1e-6) & fr["validity"][vi, ui]
    sdf = d - z
    nrm = fr["normal"][vi, ui]  # (V, 3) world-frame surface normal
    ray = centers - fr["cam_pos"]
    ray = ray / torch.clamp(torch.linalg.norm(ray, dim=-1, keepdim=True),
                            min=1e-12)
    return sdf, nrm, ray, ok & (sdf >= -trunc)


def _prep_frames(frames: List[dict], cfg: IsoFusionConfig, dev) -> list:
    """Each frame's tensors on `dev`: depth, world normals, validity, w2c,
    camera position, intrinsics."""
    prepped = []
    for fr in frames:
        depth = tsdf_lib.to_numpy(fr["depth"], np.float32)
        c2w_cv, w2c = tsdf_lib.world_to_camera(fr["c2w_gl"])
        prepped.append(dict(
            depth=torch.as_tensor(depth[..., 0], device=dev),
            normal=torch.as_tensor(fr["normal_w"], dtype=torch.float32,
                                   device=dev),
            validity=torch.as_tensor(
                depth_validity_mask(depth, cfg.depth_validity_rel),
                device=dev),
            w2c=torch.as_tensor(w2c, device=dev),
            cam_pos=torch.as_tensor(c2w_cv[:3, 3], dtype=torch.float32,
                                    device=dev),
            fx=float(fr["fx"]), fy=float(fr["fy"]), cx=float(fr["cx"]),
            cy=float(fr["cy"]), h=depth.shape[0], w=depth.shape[1]))
    return prepped


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


@torch.no_grad()
def fuse_normal_weighted(frames: List[dict],
                         bounds: Tuple[np.ndarray, np.ndarray],
                         cfg: IsoFusionConfig = IsoFusionConfig(),
                         device=None) -> tsdf_lib.TSDFVolume:
    """Two-pass fusion over frames (each: depth (H, W, 1), normal_w (H, W,
    3) world, c2w_gl (4, 4), fx, fy, cx, cy). Pass 1 accumulates
    validity-weighted normals into a reference normal per voxel; pass 2
    updates the TSDF weighted by the agreement between that normal and the
    observation's surface normal, skipping anti-aligned observations."""
    dev = resolve_device(device)
    trunc = cfg.tsdf_rel * cfg.voxel_size
    vol = tsdf_lib.create_volume(
        bounds[0], bounds[1],
        tsdf_lib.TSDFConfig(voxel_size=cfg.voxel_size, sdf_trunc=trunc),
        device=dev)
    nvox = vol.tsdf.shape[0]
    prepped = _prep_frames(frames, cfg, dev)

    # pass 1: reference normals
    ref_normal = torch.zeros((nvox, 3), device=dev)
    for p in prepped:
        for s in range(0, nvox, cfg.chunk):
            e = min(s + cfg.chunk, nvox)
            sdf, nrm, ray, ok = _observe(tsdf_lib.voxel_centers(vol, s, e),
                                         p, trunc)
            band = ok & (torch.abs(sdf) <= trunc)
            # weighted by how head-on the view is (|n . ray|)
            wgt = torch.where(band, torch.abs(torch.sum(nrm * ray, -1)), 0.0)
            ref_normal[s:e] += wgt[:, None] * nrm
    ref_normal = _unit(ref_normal)

    # pass 2: normal-weighted TSDF
    tsdf, weight = vol.tsdf, vol.weight
    for p in prepped:
        for s in range(0, nvox, cfg.chunk):
            e = min(s + cfg.chunk, nvox)
            sdf, nrm, ray, ok = _observe(tsdf_lib.voxel_centers(vol, s, e),
                                         p, trunc)
            agree = torch.sum(nrm * ref_normal[s:e], -1)
            # back-mask: skip observations whose surface normal opposes
            # the voxel's reference normal (hole avoidance)
            w_obs = torch.where(ok & (agree > cfg.back_mask_dot),
                                torch.clamp(agree, min=0.0), 0.0)
            obs = torch.clamp(sdf / trunc, -1.0, 1.0)
            w_tot = weight[s:e] + w_obs
            tsdf[s:e] = torch.where(
                w_obs > 0,
                (tsdf[s:e] * weight[s:e] + obs * w_obs)
                / torch.clamp(w_tot, min=1e-8), tsdf[s:e])
            weight[s:e] = w_tot
    return vol


def extract(vol: tsdf_lib.TSDFVolume, min_weight: float = 1.0):
    return tsdf_lib.extract_mesh(vol, min_weight)


def make_isofunc(frames: List[dict], cfg: IsoFusionConfig = IsoFusionConfig(),
                 trunc: Optional[float] = None, device=None):
    """Point-wise two-pass fused-TSDF isoFunc for the adaptive octree mesher
    (the analogue of isooctree_dn.py's isoFunc): a callable (N, 3) world
    points -> (N,) signed values, +1 in unobserved space. Unlike
    `fuse_normal_weighted` there is no dense grid: the octree evaluates only
    near-surface points, on `device` (None: the card)."""
    dev = resolve_device(device)
    trunc = trunc if trunc is not None else cfg.tsdf_rel * cfg.voxel_size
    prepped = _prep_frames(frames, cfg, dev)

    @torch.no_grad()
    def eval_fn(points: np.ndarray) -> np.ndarray:
        pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
        n = pts.shape[0]
        ref = torch.zeros((n, 3), device=dev)
        for p in prepped:
            sdf, nrm, ray, ok = _observe(pts, p, trunc)
            band = ok & (torch.abs(sdf) <= trunc)
            wgt = torch.where(band, torch.abs(torch.sum(nrm * ray, -1)), 0.0)
            ref = ref + wgt[:, None] * nrm
        ref = _unit(ref)
        acc = torch.zeros(n, device=dev)
        wsum = torch.zeros(n, device=dev)
        for p in prepped:
            sdf, nrm, ray, ok = _observe(pts, p, trunc)
            agree = torch.sum(nrm * ref, -1)
            w_obs = torch.where(ok & (agree > cfg.back_mask_dot),
                                torch.clamp(agree, min=0.0), 0.0)
            acc = acc + w_obs * torch.clamp(sdf / trunc, -1.0, 1.0)
            wsum = wsum + w_obs
        fused = torch.where(wsum >= cfg.min_weight,
                            acc / torch.clamp(wsum, min=1e-8), 1.0)
        return fused.cpu().numpy()

    return eval_fn
