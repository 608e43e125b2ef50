"""Mesh export commands (counterpart of dnsplatter_tpu/mesh/exporters.py;
parity: dn_splatter/export_mesh.py, `gs-mesh`).

The reference's six exporters over a trained checkpoint:
  tsdf          TSDF fusion of rendered RGB-D (the vdbfusion role)
  o3dtsdf       TSDF fusion with Open3D ScalableTSDFVolume's defaults
                (voxel 0.01 / trunc 0.03) and its small-cluster cleanup
  dn            rendered depth + surface normals backprojected into an
                oriented point cloud with depth-edge filtering, its Poisson
                mesh, and a TSDF mesh
  gaussians     Gaussian centres + normals as an oriented point cloud (the
                reference's GaussiansToPoisson input) and its Poisson mesh
  sugar-coarse  SuGaR density level-set points + normals, Poisson meshes
  marching      a density grid's isosurface
and the AGS-Mesh `isofusion` mesher (normal-weighted fusion, adaptive
octree or dense grid).

Frames render through the port's `get_outputs` under `torch.no_grad()`, so
on the card every render launches the expansion and `forward_tiles`. Each
exporter takes `pair_capacity`, the renders' pair-list capacity (default
2^21, the JAX package's fixed value): a frame with more (Gaussian, tile)
pairs than that drops whole Gaussians, so callers size it to the scene.
Everything runs on the device of the parameters; marching, clustering,
decimation, KD-trees and the brick hash run on the host.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from dnsplatter_torch.data import io
from dnsplatter_torch.eval.evaluator import eval_raster_config
from dnsplatter_torch.mesh import tsdf as tsdf_lib
from dnsplatter_torch.mesh.tsdf import GL_TO_CV, to_numpy
from dnsplatter_torch.models.dn_model import ModelConfig, get_outputs
from dnsplatter_torch.ops.camera import backproject_depth

DEFAULT_PAIR_CAPACITY = 1 << 21


def _render_frames(params, alive, data, model_cfg, sh_degree,
                   pair_capacity: int = DEFAULT_PAIR_CAPACITY):
    """Yield (camera, outputs dict of tensors) over all frames."""
    if sh_degree is None:
        sh_degree = params.sh_degree  # from the checkpoint
    background = torch.zeros(3, device=params.means.device)
    for i in range(len(data)):
        cam, _ = data.get(i)
        cfg = eval_raster_config(cam.width, cam.height, pair_capacity)
        with torch.no_grad():
            out, _ = get_outputs(params, alive, cam, model_cfg, cfg,
                                 sh_degree=sh_degree, training=False,
                                 background=background)
        yield cam, out


def _world_normals(out, c2w_cv: np.ndarray) -> torch.Tensor:
    """(H, W, 3) world normals from the [0, 1] camera-frame
    `surface_normal` (flipped for display)."""
    n_cam = 2.0 * out["surface_normal"] - 1.0
    n_cam = n_cam * torch.tensor([1.0, -1.0, -1.0], device=n_cam.device)
    rot = torch.as_tensor(c2w_cv[:3, :3], dtype=torch.float32,
                          device=n_cam.device)
    return n_cam @ rot.T


def find_depth_edges(depth: np.ndarray, threshold: float = 0.01,
                     dilation: int = 2) -> np.ndarray:
    """Laplacian depth-discontinuity mask (export_mesh.py:58-90)."""
    d = depth[..., 0] if depth.ndim == 3 else depth
    # edge-clamped Laplacian and dilation: a wrap-around would flag
    # spurious edges along every border row and column
    pad = np.pad(d, 1, mode="edge")
    lap = (-4.0 * d + pad[:-2, 1:-1] + pad[2:, 1:-1] + pad[1:-1, :-2]
           + pad[1:-1, 2:])
    edges = np.abs(lap) > threshold
    for _ in range(dilation):
        ep = np.pad(edges, 1, mode="edge")
        edges = (edges | ep[:-2, 1:-1] | ep[2:, 1:-1] | ep[1:-1, :-2]
                 | ep[1:-1, 2:])
    return edges


@dataclasses.dataclass
class TSDFExportConfig:
    voxel_size: float = 0.01
    sdf_trunc: float = 0.03
    depth_max: float = 5.0
    min_weight: float = 2.0
    # dense-grid memory guard: the voxel size is raised so that the grid
    # never exceeds max_resolution^3 (camera-AABB + depth_max margins can
    # span 15+ m: 1500^3 cells at 1 cm would be ~67 GB)
    max_resolution: int = 320
    # Open3DTSDFFusion cleanup: drop connected components smaller than
    # max(50th-largest, 50) triangles. `tsdf` leaves it off, `o3dtsdf`
    # turns it on.
    cleanup_clusters: bool = False
    # quadric decimation to this triangle count (None: full resolution)
    target_triangles: Optional[int] = None
    # Brick-hash sparse fusion (mesh/tsdf_sparse.py) keeps the requested
    # voxel size at room scale. "auto": sparse whenever the dense grid
    # would have to coarsen the voxels; True / False force it.
    sparse: object = "auto"


class _IndexView:
    """Length/get view of a dataset restricted to `indices`."""

    def __init__(self, data, indices):
        self._data = data
        self._idx = list(indices)

    def __len__(self):
        return len(self._idx)

    def get(self, i):
        return self._data.get(self._idx[i])


def _clipped_depth(out, depth_max: float) -> torch.Tensor:
    depth = out["depth"]
    return torch.where(depth < depth_max, depth, 0.0)


def export_tsdf(params, alive, data, output_dir: Path,
                model_cfg: ModelConfig = ModelConfig(),
                cfg: TSDFExportConfig = TSDFExportConfig(),
                sh_degree: Optional[int] = None,
                bounds: Optional[Tuple] = None,
                pair_capacity: int = DEFAULT_PAIR_CAPACITY) -> Path:
    """`gs-mesh tsdf` / `gs-mesh o3dtsdf`: fuse the rendered RGB-D."""
    dev = params.means.device
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    cams = [data.get(i)[0] for i in range(len(data))]
    if bounds is None:
        bounds = tsdf_lib.scene_bounds_from_cameras(cams, cfg.depth_max)
    span = float(np.max(np.asarray(bounds[1]) - np.asarray(bounds[0])))
    use_sparse = (cfg.sparse is True
                  or (cfg.sparse == "auto"
                      and span / cfg.voxel_size > cfg.max_resolution))
    frames = _render_frames(params, alive, data, model_cfg, sh_degree,
                            pair_capacity)
    if use_sparse:
        # the brick-hash volume keeps cfg.voxel_size whatever the span
        from dnsplatter_torch.mesh.tsdf_sparse import (SparseTSDF,
                                                       SparseTSDFConfig)

        sp = SparseTSDF(origin=np.asarray(bounds[0], np.float32),
                        cfg=SparseTSDFConfig(voxel_size=cfg.voxel_size,
                                             sdf_trunc=cfg.sdf_trunc),
                        device=dev)
        for cam, out in frames:
            sp.integrate(_clipped_depth(out, cfg.depth_max), out["rgb"],
                         cam.c2w, float(cam.fx), float(cam.fy),
                         float(cam.cx), float(cam.cy))
        verts, faces, cols = sp.extract_mesh(cfg.min_weight)
    else:
        voxel = max(cfg.voxel_size, span / cfg.max_resolution)
        vol = tsdf_lib.create_volume(
            bounds[0], bounds[1],
            tsdf_lib.TSDFConfig(voxel_size=voxel,
                                sdf_trunc=max(cfg.sdf_trunc, 3 * voxel)),
            device=dev)
        for cam, out in frames:
            tsdf_lib.integrate(vol, _clipped_depth(out, cfg.depth_max),
                               out["rgb"], cam.c2w, float(cam.fx),
                               float(cam.fy), float(cam.cx), float(cam.cy))
        verts, faces, cols = tsdf_lib.extract_mesh(vol, cfg.min_weight)
    if cfg.cleanup_clusters:
        from dnsplatter_torch.mesh.postprocess import remove_small_clusters

        verts, faces, cols = remove_small_clusters(verts, faces, cols)
    if cfg.target_triangles and len(faces) > cfg.target_triangles:
        from scipy.spatial import cKDTree

        from dnsplatter_torch.mesh.postprocess import (
            simplify_quadric_decimation)

        verts_pre, cols_pre = verts, cols
        verts, faces = simplify_quadric_decimation(verts, faces,
                                                   cfg.target_triangles)
        if cols_pre is not None and len(verts_pre):
            # decimation moves vertices: colours from the nearest vertex
            # before it
            _, nn = cKDTree(verts_pre, compact_nodes=False).query(
                verts, k=1, workers=-1)
            cols = cols_pre[nn]
        else:
            cols = None
    out_path = output_dir / "TSDFfusion_mesh.ply"
    io.write_ply(out_path, verts, colors=cols, faces=faces)
    return out_path


def export_dn(params, alive, data, output_dir: Path,
              model_cfg: ModelConfig = ModelConfig(),
              sh_degree: Optional[int] = None,
              edge_threshold: float = 0.01,
              total_points: int = 2_000_000,
              also_tsdf: bool = True,
              poisson_resolution: int = 192,
              pair_capacity: int = DEFAULT_PAIR_CAPACITY) -> Path:
    """`gs-mesh dn`: depth + surface-normal backprojection with edge
    filtering -> oriented point cloud -> Poisson mesh [+ TSDF mesh]."""
    from dnsplatter_torch.mesh.poisson import (
        PoissonConfig, density_quantile_cull, poisson_reconstruct,
        trim_mesh_to_points)

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    pts_all, nrm_all, col_all = [], [], []
    per_frame = max(1, total_points // max(len(data), 1))
    for cam, out in _render_frames(params, alive, data, model_cfg, sh_degree,
                                   pair_capacity):
        depth = out["depth"]
        c2w_cv = to_numpy(cam.c2w, np.float64) @ GL_TO_CV
        pts = backproject_depth(
            depth[..., 0], cam.fx, cam.fy, cam.cx, cam.cy,
            torch.as_tensor(c2w_cv, dtype=torch.float32,
                            device=depth.device)).reshape(-1, 3)
        depth = depth.cpu().numpy()
        edges = find_depth_edges(depth, edge_threshold)
        acc = out["accumulation"].cpu().numpy().reshape(-1)
        ok = (acc > 0.5) & ~edges.reshape(-1) & (depth.reshape(-1) > 0)
        idx = np.where(ok)[0]
        if len(idx) > per_frame:
            # a uniform random subsample (the reference random-chooses its
            # total_points budget; a stride alias-patterns the cloud)
            idx = np.random.default_rng(len(pts_all)).choice(
                idx, per_frame, replace=False)
        sel = torch.as_tensor(idx, device=pts.device)
        pts_all.append(pts[sel].cpu().numpy())
        nrm_all.append(_world_normals(out, c2w_cv).reshape(-1, 3)[sel]
                       .cpu().numpy())
        col_all.append(out["rgb"].reshape(-1, 3)[sel].cpu().numpy())
    pts = np.concatenate(pts_all)
    nrm = np.concatenate(nrm_all)
    cols = np.concatenate(col_all)
    io.write_ply(output_dir / "DepthAndNormals_pcd.ply", pts, colors=cols,
                 normals=nrm)
    verts, faces = poisson_reconstruct(
        pts, nrm, PoissonConfig(resolution=poisson_resolution),
        device=params.means.device)
    extent = float(np.linalg.norm(pts.max(0) - pts.min(0)))
    verts, faces = trim_mesh_to_points(verts, faces, pts, 0.02 * extent)
    # the reference's density-quantile vertex cull
    verts, faces = density_quantile_cull(verts, faces, pts, quantile=0.1)
    mesh_path = output_dir / "DepthAndNormals_poisson_mesh.ply"
    io.write_ply(mesh_path, verts, faces=faces)
    if also_tsdf:
        export_tsdf(params, alive, data, output_dir, model_cfg,
                    sh_degree=sh_degree, pair_capacity=pair_capacity)
    return mesh_path


def export_gaussians(params, alive, data, output_dir: Path,
                     min_opacity: float = 0.1,
                     cull_by_color: bool = False,
                     poisson_resolution: int = 192,
                     densify_gaussians: Optional[int] = None) -> Path:
    """`gs-mesh gaussians`: centres + per-Gaussian normals as an oriented
    point cloud and its Poisson mesh. `densify_gaussians` adds that many
    volume-weighted samples inside the Gaussians, each with its parent's
    normal and colour, drawn from a generator seeded 0 on the parameters'
    device (the JAX package draws from PRNGKey(0))."""
    from dnsplatter_torch.ops.sh import sh_to_rgb

    dev = params.means.device
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    alive_np = to_numpy(alive) > 0.5
    opac = torch.sigmoid(params.opacities).cpu().numpy()
    keep = alive_np & (opac > min_opacity)
    normals_np = to_numpy(params.normals)
    pts = to_numpy(params.means)[keep]
    nrm = normals_np[keep]
    all_cols = np.clip(sh_to_rgb(params.features_dc).cpu().numpy(), 0, 1)
    cols = all_cols[keep]
    if densify_gaussians:
        from dnsplatter_torch.models.sugar import sample_points_in_gaussians

        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
        extra, gidx = sample_points_in_gaussians(
            generator, params, torch.as_tensor(keep, dtype=torch.float32,
                                               device=dev),
            int(densify_gaussians))
        gidx = gidx.cpu().numpy()
        pts = np.concatenate([pts, extra.cpu().numpy()])
        nrm = np.concatenate([nrm, normals_np[gidx]])
        cols = np.concatenate([cols, all_cols[gidx]])
    if cull_by_color:
        keep2 = cols.mean(-1) > 0.1
        pts, nrm, cols = pts[keep2], nrm[keep2], cols[keep2]
    out_path = output_dir / "Gaussians_pcd.ply"
    io.write_ply(out_path, pts, colors=cols, normals=nrm)
    if len(pts) > 100:
        from dnsplatter_torch.mesh.poisson import (
            PoissonConfig, poisson_reconstruct, trim_mesh_to_points)

        verts, faces = poisson_reconstruct(
            pts, nrm, PoissonConfig(resolution=poisson_resolution),
            device=dev)
        extent = float(np.linalg.norm(pts.max(0) - pts.min(0)))
        verts, faces = trim_mesh_to_points(verts, faces, pts, 0.03 * extent)
        io.write_ply(output_dir / "Gaussians_poisson_mesh.ply", verts,
                     faces=faces)
    return out_path


def export_sugar_coarse(params, alive, data, output_dir: Path,
                        model_cfg: ModelConfig = ModelConfig(),
                        sh_degree: Optional[int] = None,
                        surface_levels=(0.1, 0.3, 0.5),
                        frame_stride: int = 4,
                        subsample: int = 8,
                        pair_capacity: int = DEFAULT_PAIR_CAPACITY) -> Path:
    """`gs-mesh sugar-coarse`: density level-set points + normals, their
    Poisson meshes and two Laplacian-smoothed variants of each."""
    from dnsplatter_torch.mesh.poisson import PoissonConfig, poisson_reconstruct
    from dnsplatter_torch.mesh.postprocess import filter_smooth_laplacian
    from dnsplatter_torch.models.sugar import compute_level_surface_points

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    acc: dict = {lv: ([], [], []) for lv in surface_levels}
    # stride the indices before rendering
    strided = _IndexView(data, list(range(len(data)))[::frame_stride])
    for cam, out in _render_frames(params, alive, strided, model_cfg,
                                   sh_degree, pair_capacity):
        res = compute_level_surface_points(
            params, alive, cam, out["depth"], out["rgb"],
            surface_levels=surface_levels, subsample=subsample)
        for lv, d in res.items():
            acc[lv][0].append(d["points"])
            acc[lv][1].append(d["colors"])
            acc[lv][2].append(d["normals"])
    last = None
    for lv, (p, c, n) in acc.items():
        if not p:
            continue
        pp = np.concatenate(p)
        nn = np.concatenate(n)
        path = output_dir / f"sugar_level_{lv:.1f}_pcd.ply"
        io.write_ply(path, pp, colors=np.concatenate(c), normals=nn)
        if len(pp) > 100:
            verts, faces = poisson_reconstruct(pp, nn, PoissonConfig(),
                                               device=params.means.device)
            io.write_ply(output_dir / f"sugar_level_{lv:.1f}_poisson_mesh.ply",
                         verts, faces=faces)
            # the reference saves two successive Laplacian-smoothed variants
            # of each level-set mesh
            for k in (1, 2):
                verts = filter_smooth_laplacian(verts, faces)
                io.write_ply(
                    output_dir / f"sugar_level_{lv:.1f}_smoothed_{k}_mesh.ply",
                    verts, faces=faces)
        last = path
    return last


def export_isofusion(params, alive, data, output_dir: Path,
                     model_cfg: ModelConfig = ModelConfig(),
                     sh_degree: Optional[int] = None,
                     voxel_size: float = 0.02,
                     depth_max: float = 5.0,
                     adaptive: bool = True,
                     coarse_res: int = 64,
                     octree_levels: int = 3,
                     pair_capacity: int = DEFAULT_PAIR_CAPACITY) -> Path:
    """AGS-Mesh two-pass normal-weighted fusion (the isooctree_dn.py role)
    of the rendered depth and surface normals of every frame.
    `adaptive=True` meshes through the octree isosurfacer (mesh/octree.py:
    effective resolution coarse_res * 2**octree_levels, evaluated near the
    surface only); `adaptive=False` fuses a dense grid at `voxel_size`."""
    from dnsplatter_torch.mesh.isofusion import (
        IsoFusionConfig, extract, fuse_normal_weighted, make_isofunc)

    dev = params.means.device
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    frames, cams = [], []
    for cam, out in _render_frames(params, alive, data, model_cfg, sh_degree,
                                   pair_capacity):
        cams.append(cam)
        c2w_cv = to_numpy(cam.c2w, np.float64) @ GL_TO_CV
        frames.append(dict(
            depth=_clipped_depth(out, depth_max).cpu().numpy(),
            normal_w=_world_normals(out, c2w_cv), c2w_gl=to_numpy(cam.c2w),
            fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx),
            cy=float(cam.cy)))
    bounds = tsdf_lib.scene_bounds_from_cameras(cams, depth_max)
    out_path = output_dir / "IsoFusion_mesh.ply"
    if adaptive:
        from dnsplatter_torch.mesh.octree import adaptive_isosurface

        span = float(np.max(np.asarray(bounds[1]) - np.asarray(bounds[0])))
        cfg = IsoFusionConfig(
            voxel_size=span / (coarse_res * 2 ** octree_levels))
        verts, faces = adaptive_isosurface(
            make_isofunc(frames, cfg, device=dev), bounds[0], bounds[1],
            coarse_res=coarse_res, levels=octree_levels)
        io.write_ply(out_path, verts, faces=faces)
        return out_path
    vol = fuse_normal_weighted(frames, bounds,
                               IsoFusionConfig(voxel_size=voxel_size),
                               device=dev)
    verts, faces, _ = extract(vol)
    # the normal-weighted fusion integrates no colour: no colour property
    io.write_ply(out_path, verts, faces=faces)
    return out_path


def export_marching(params, alive, data, output_dir: Path,
                    resolution: int = 256, level: float = 0.5,
                    padding: float = 0.1,
                    target_triangles: Optional[int] = 1_000_000) -> Path:
    """`gs-mesh marching`: a density grid over the live Gaussians' extent
    and its isosurface; vertex colours from the nearest Gaussian's DC
    colour. One KD-tree over the live centres serves every chunk of grid
    points."""
    from dnsplatter_torch.mesh.marching import marching_tetrahedra
    from dnsplatter_torch.models.sugar import (closest_gaussians_tree,
                                               get_closest_gaussians,
                                               get_density)
    from dnsplatter_torch.ops.sh import sh_to_rgb

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    alive_np = to_numpy(alive) > 0.5
    means = to_numpy(params.means)[alive_np]
    lo = means.min(0) - padding
    hi = means.max(0) + padding
    xs = [np.linspace(lo[d], hi[d], resolution) for d in range(3)]
    grid = np.stack(np.meshgrid(*xs, indexing="ij"), -1).reshape(-1, 3)

    tree = closest_gaussians_tree(params, alive)
    dens = np.zeros(len(grid), np.float32)
    chunk = 1 << 17
    for s in range(0, len(grid), chunk):
        pts = grid[s:s + chunk].astype(np.float32)
        closest = get_closest_gaussians(pts, params, alive, tree=tree)
        dens[s:s + chunk] = get_density(pts, params, alive, closest,
                                        clamp=False).cpu().numpy()
    field = dens.reshape(resolution, resolution, resolution)
    # marching extracts "inside = field < level"; density is inside when
    # above the level, so negate
    verts, faces = marching_tetrahedra(level - field, 0.0)
    verts_w = lo + verts * ((hi - lo) / (resolution - 1))
    if target_triangles and len(faces) > target_triangles:
        from dnsplatter_torch.mesh.postprocess import (
            simplify_quadric_decimation)

        verts_w, faces = simplify_quadric_decimation(verts_w, faces,
                                                     target_triangles)
    cols = None
    if len(verts_w):
        _, nn = tree[0].query(verts_w, k=1, workers=-1)
        dc = sh_to_rgb(params.features_dc).cpu().numpy()[alive_np]
        cols = np.clip(dc[nn], 0, 1)
    out_path = output_dir / "MarchingCubes_mesh.ply"
    io.write_ply(out_path, verts_w.astype(np.float32), colors=cols,
                 faces=faces)
    return out_path
