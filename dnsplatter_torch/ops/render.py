"""Full render: projection + SH + one rasterizer pass for rgb, camera-frame
normals and depth (counterpart of dnsplatter_tpu/ops/render.py).

Outputs match the reference's `get_outputs` dict: rgb, depth (expected),
normal (camera frame), surface_normal (depth-gradient), accumulation,
background. Differentiable in the Gaussian parameters; `xys_sink` and
`absgrad_sink` expose the screen-space gradients that densification reads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from dnsplatter_torch.models.gaussians import GaussianParams
from dnsplatter_torch.ops.camera import Camera
from dnsplatter_torch.ops.normals import (
    per_gaussian_normals,
    surface_normal_output,
    world_to_camera_normals,
)
from dnsplatter_torch.ops.projection import project_gaussians
from dnsplatter_torch.ops.rasterize import RasterizeConfig, rasterize
from dnsplatter_torch.ops.sh import eval_sh
from dnsplatter_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class RenderOutputs:
    rgb: torch.Tensor  # (H, W, 3) background-composited
    depth: torch.Tensor  # (H, W, 1) expected depth (alpha-normalized)
    normal: torch.Tensor  # (H, W, 3) composited camera-frame normals
    surface_normal: torch.Tensor  # (H, W, 3) depth-gradient normals in [0,1]
    accumulation: torch.Tensor  # (H, W, 1) alpha
    background: torch.Tensor  # (3,)


@dataclasses.dataclass(frozen=True)
class RenderInfo:
    """Densification statistics (gsplat `info` equivalent)."""

    radii: torch.Tensor  # (N,) screen radii (0 = culled)
    depths: torch.Tensor  # (N,) camera z
    valid: torch.Tensor  # (N,) bool visibility
    means2d: torch.Tensor  # (N, 2) screen centers


@dataclasses.dataclass(frozen=True)
class ScreenSpace:
    """The per-Gaussian inputs of one rasterizer pass, before binning."""

    means2d: torch.Tensor  # (N, 2)
    conics: torch.Tensor  # (N, 3)
    depths: torch.Tensor  # (N,) camera z
    opacities: torch.Tensor  # (N,) post-sigmoid (x compensation if antialiased)
    features: torch.Tensor  # (N, 7) rgb, camera-frame normal, depth
    valid: torch.Tensor  # (N,) bool: in the frustum, alive and in crop_box
    radii_xy: torch.Tensor  # (N, 2) per-axis screen extents
    radii: torch.Tensor  # (N,) screen radii (0 = culled)


def screen_space(
    params: GaussianParams,
    alive: torch.Tensor,
    camera: Camera,
    sh_degree_to_use: int = 3,
    rasterize_mode: str = "classic",
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    crop_box: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> ScreenSpace:
    """Projection, SH colours and per-Gaussian normals: everything of
    `render` that is per Gaussian, so a sharded caller can run it on its own
    rows. Counts the rows computed and the visible ones (`project.*`)."""
    with profiling.span("render.screen"):
        viewmat = camera.viewmat()
        opac_raw = torch.sigmoid(params.opacities)
        proj = project_gaussians(
            params.means, params.quats, torch.exp(params.scales), viewmat,
            camera.fx, camera.fy, camera.cx, camera.cy, camera.width,
            camera.height, near_plane=near_plane, far_plane=far_plane,
            opacities=opac_raw,
        )
        valid = proj.valid & (alive > 0.5)
        if crop_box is not None:
            lo, hi = crop_box
            inside = torch.all(
                (params.means >= lo[None]) & (params.means <= hi[None]),
                dim=-1)
            valid = valid & inside
        if profiling.enabled():
            profiling.count("project.rows", valid.shape[0])
            profiling.count("project.visible", valid.sum())

        opac = opac_raw
        if rasterize_mode == "antialiased":
            opac = opac * proj.compensations

        cam_pos = camera.position()
        colors = eval_sh(sh_degree_to_use, params.sh_coeffs(),
                         params.means - cam_pos[None, :])
        n_world = per_gaussian_normals(params.scales, params.quats,
                                       params.means, cam_pos)
        n_cam = world_to_camera_normals(n_world, camera.c2w)
        feats = torch.cat([colors, n_cam, proj.depths[:, None]], dim=-1)
    return ScreenSpace(means2d=proj.means2d, conics=proj.conics,
                       depths=proj.depths, opacities=opac, features=feats,
                       valid=valid, radii_xy=proj.radii_xy, radii=proj.radii)


def finish(img: torch.Tensor, alpha: torch.Tensor, camera: Camera,
           background: torch.Tensor) -> RenderOutputs:
    """The image-space part of `render`: the background composite, the
    expected depth and the depth-gradient normals of a composited frame
    (H, W, 7) with its alpha."""
    with profiling.span("render.finish"):
        rgb = img[..., 0:3] + (1.0 - alpha) * background[None, None, :]
        # clip as min(max(x, 0), 1): at a tie the gradient halves, as the
        # JAX package's jnp.clip does (torch.clamp would pass it whole)
        rgb = torch.minimum(torch.maximum(rgb, rgb.new_zeros(())),
                            rgb.new_ones(()))
        depth_acc = img[..., 6:7]
        # Expected depth: accumulated / alpha where visible, the (detached)
        # maximum elsewhere (splatfacto semantics).
        max_depth = depth_acc.max().detach()
        depth = torch.where(
            alpha > 0.0,
            depth_acc / torch.maximum(alpha, alpha.new_full((), 1e-10)),
            max_depth)
        surface_normal = surface_normal_output(depth.detach(), camera.fx,
                                               camera.fy, camera.cx,
                                               camera.cy)
    return RenderOutputs(rgb=rgb, depth=depth, normal=img[..., 3:6],
                         surface_normal=surface_normal, accumulation=alpha,
                         background=background)


def render(
    params: GaussianParams,
    alive: torch.Tensor,
    camera: Camera,
    raster_cfg: RasterizeConfig,
    sh_degree_to_use: int = 3,
    background: Optional[torch.Tensor] = None,
    rasterize_mode: str = "classic",
    xys_sink: Optional[torch.Tensor] = None,
    absgrad_sink: Optional[torch.Tensor] = None,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    crop_box: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[RenderOutputs, RenderInfo]:
    """Render one camera. `alive` (C,) {0,1} masks capacity padding;
    `crop_box` (lo, hi) keeps only Gaussians inside a world AABB.
    `xys_sink` / `absgrad_sink`: optional (C, 2) zeros whose gradients are
    the screen-space mean gradients / their absolute values."""
    if background is None:
        background = torch.zeros(3, device=params.means.device)
    ss = screen_space(params, alive, camera, sh_degree_to_use,
                      rasterize_mode, near_plane, far_plane, crop_box)
    means2d = ss.means2d
    if xys_sink is not None:
        means2d = means2d + xys_sink
    img, alpha = rasterize(means2d, ss.conics, ss.depths, ss.opacities,
                           ss.features, ss.valid, raster_cfg,
                           absgrad_sink=absgrad_sink, radii=ss.radii_xy)
    info = RenderInfo(radii=ss.radii, depths=ss.depths, valid=ss.valid,
                      means2d=ss.means2d)
    return finish(img, alpha, camera, background), info
