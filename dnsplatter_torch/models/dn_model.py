"""DN-Splatter model outputs (counterpart of
dnsplatter_tpu/models/dn_model.py).

`ModelConfig` carries every flag of the JAX package with its default;
`get_outputs` renders the reference's output dict {rgb, depth, normal,
surface_normal, accumulation, background} in one rasterizer pass;
`compute_loss` assembles the splatfacto main loss (L1 + SSIM), the scale
regularizer and the DN-Splatter or AGS-Mesh strategy, with the gt clamp at
10/255 for the edge weights, the mask, sensor-before-mono depth priority
and the mono-or-depth normal supervision switch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from dnsplatter_torch.models import losses as L
from dnsplatter_torch.models.gaussians import GaussianParams
from dnsplatter_torch.models.regularization import (
    RegularizationConfig,
    ags_regularization_loss,
    dn_regularization_loss,
)
from dnsplatter_torch.ops.camera import Camera
from dnsplatter_torch.ops.normals import normal_from_depth_image
from dnsplatter_torch.ops.rasterize import RasterizeConfig
from dnsplatter_torch.ops.render import RenderInfo, RenderOutputs, render
from dnsplatter_torch.utils import profiling

# Viser's default background colour, used by splatfacto at eval when
# background_color == "random".
VISER_BACKGROUND = (0.1490, 0.1647, 0.2157)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """DNSplatterModelConfig parity + the splatfacto base flags."""

    # --- DN-Splatter flags ---
    regularization_strategy: str = "dn-splatter"  # or "ags-mesh"
    use_depth_loss: bool = False
    depth_loss_type: str = "edge_aware_log_l1"
    depth_tolerance: float = 0.1
    smooth_loss_type: str = "tv"  # or "edge_aware_tv"
    depth_lambda: float = 0.0
    use_depth_smooth_loss: bool = False
    smooth_loss_lambda: float = 0.1
    predict_normals: bool = True
    use_normal_loss: bool = True
    use_normal_cosine_loss: bool = False
    use_normal_tv_loss: bool = True
    normal_supervision: str = "mono"  # or "depth"
    normal_lambda: float = 0.1
    use_sparse_loss: bool = False
    sparse_lambda: float = 0.1
    sparse_loss_steps: int = 10
    use_binary_opacities: bool = False
    binary_opacities_threshold: float = 0.9
    two_d_gaussians: bool = True

    # --- splatfacto base flags ---
    warmup_length: int = 500
    refine_every: int = 100
    resolution_schedule: int = 3000
    num_downscales: int = 0
    cull_alpha_thresh: float = 0.1
    cull_scale_thresh: float = 0.5
    continue_cull_post_densification: bool = True
    reset_alpha_every: int = 30
    densify_grad_thresh: float = 0.0008
    densify_size_thresh: float = 0.01
    n_split_samples: int = 2
    sh_degree_interval: int = 1000
    cull_screen_size: float = 0.15
    split_screen_size: float = 0.05
    stop_screen_size_at: int = 4000
    stop_split_at: int = 15000
    sh_degree: int = 3
    use_scale_regularization: bool = False
    max_gauss_ratio: float = 5.0
    ssim_lambda: float = 0.2
    rasterize_mode: str = "classic"
    background_color: str = "random"
    num_random: int = 500_000
    random_scale: float = 10.0
    camera_optimizer_mode: str = "off"  # "off" | "SO3xR3"

    def regularization(self) -> RegularizationConfig:
        return RegularizationConfig(
            depth_tolerance=self.depth_tolerance,
            depth_loss_type=self.depth_loss_type,
            depth_lambda=self.depth_lambda,
            normal_lambda=self.normal_lambda,
            use_normal_loss=self.use_normal_loss,
            use_normal_tv_loss=self.use_normal_tv_loss,
            use_normal_cosine_loss=self.use_normal_cosine_loss,
        )


def sh_degree_to_use(step: int, cfg: ModelConfig) -> int:
    """SH degree schedule: one degree per `sh_degree_interval` steps."""
    return min(int(step) // cfg.sh_degree_interval, cfg.sh_degree)


def pick_background(cfg: ModelConfig, training: bool,
                    generator: Optional[torch.Generator],
                    device) -> torch.Tensor:
    """A uniform random colour drawn from `generator` when training with
    background_color "random", else Viser's grey."""
    if (cfg.background_color == "random" and training
            and generator is not None):
        return torch.rand(3, generator=generator,
                          device=generator.device).to(device)
    return torch.tensor(VISER_BACKGROUND, dtype=torch.float32, device=device)


def outputs_dict(out: RenderOutputs) -> Dict[str, torch.Tensor]:
    """The reference `get_outputs` dict of a rendered frame."""
    # Unit-normalize the composited normal map and map it to [0, 1].
    # rsqrt(|n|^2 + eps), not a norm: empty pixels composite a zero normal,
    # where a norm's gradient is undefined and would reach whole tiles
    # through the backward sums.
    with profiling.span("render.finish"):
        n = out.normal
        n = n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
    return {
        "rgb": out.rgb,
        "depth": out.depth,
        "normal": (n + 1.0) * 0.5,
        "surface_normal": out.surface_normal,
        "accumulation": out.accumulation,
        "background": out.background,
    }


def get_outputs(
    params: GaussianParams,
    alive: torch.Tensor,
    camera: Camera,
    cfg: ModelConfig,
    raster_cfg: RasterizeConfig,
    sh_degree: int = 3,
    background: Optional[torch.Tensor] = None,
    xys_sink: Optional[torch.Tensor] = None,
    absgrad_sink: Optional[torch.Tensor] = None,
    training: bool = True,
    generator: Optional[torch.Generator] = None,
    crop_box=None,
) -> Tuple[Dict[str, torch.Tensor], RenderInfo]:
    """The reference `get_outputs` dict. Without a `background`: see
    `pick_background`."""
    with profiling.span("model.outputs"):
        if background is None:
            background = pick_background(cfg, training, generator,
                                         params.means.device)
        out, info = render(params, alive, camera, raster_cfg,
                           sh_degree_to_use=sh_degree, background=background,
                           rasterize_mode=cfg.rasterize_mode,
                           xys_sink=xys_sink, absgrad_sink=absgrad_sink,
                           crop_box=crop_box)
        return outputs_dict(out), info


def compute_loss(
    outputs: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    params: GaussianParams,
    alive: torch.Tensor,
    camera: Camera,
    cfg: ModelConfig,
    step: int,
    pearson_corners=None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and its parts {main_loss, scale_reg, rgb_loss, reg_loss}.

    batch keys (all optional except image): image (H, W, 3), sensor_depth
    (H, W, 1), mono_depth (H, W, 1), normal (H, W, 3 in [0, 1]), confidence
    (H, W, 1 raw 0..255), mask (H, W, 1). `step` is a Python int.
    `pearson_corners` / `generator` feed the random boxes of
    depth_loss_type "pearson".
    """
    step = int(step)
    # The 10/255 clamp feeds only the regularizers' edge-aware weights; the
    # photometric loss sees the unclamped image.
    gt_img_raw = batch["image"]
    gt_img = torch.clamp_min(gt_img_raw, 10.0 / 255.0)
    pred_img = outputs["rgb"]
    depth_out = outputs["depth"]

    sensor_depth = batch.get("sensor_depth")
    mono_depth = batch.get("mono_depth")
    gt_normal = batch.get("normal")
    confidence = None
    if batch.get("confidence") is not None:
        confidence = 1.0 - batch["confidence"] / 255.0

    mask = batch.get("mask")
    pred_normal = outputs["normal"]
    if mask is not None:
        depth_out = depth_out * mask
        if sensor_depth is not None:
            sensor_depth = sensor_depth * mask
        if mono_depth is not None:
            mono_depth = mono_depth * mask
        if gt_normal is not None:
            gt_normal = gt_normal * mask
        pred_normal = pred_normal * mask

    main_loss = L.rgb_main_loss(pred_img, gt_img_raw, cfg.ssim_lambda)

    # splatfacto applies the PhysGauss penalty every 10 steps when enabled
    scale_reg = torch.zeros((), device=pred_img.device)
    if cfg.use_scale_regularization and step % 10 == 0:
        scale_reg = L.physgauss_scale_reg(params.scales, alive,
                                          cfg.max_gauss_ratio)

    if cfg.normal_supervision == "depth":
        dn = normal_from_depth_image(depth_out.detach(), camera.fx,
                                     camera.fy, camera.cx, camera.cy)
        dn = dn * torch.tensor([1.0, -1.0, -1.0], device=dn.device)
        gt_normal_eff = (1.0 + dn) * 0.5
    else:
        gt_normal_eff = gt_normal

    # depth target: sensor first, mono overrides if both
    depth_gt = sensor_depth
    if mono_depth is not None:
        depth_gt = mono_depth

    reg_cfg = cfg.regularization()
    if cfg.regularization_strategy == "dn-splatter":
        reg_loss = dn_regularization_loss(
            reg_cfg,
            pred_depth=depth_out,
            gt_depth=depth_gt if cfg.use_depth_loss else None,
            pred_normal=pred_normal if cfg.use_normal_loss else None,
            gt_normal=gt_normal_eff,
            scales=params.scales,
            gt_img=gt_img,
            alive=alive,
            pearson_corners=pearson_corners,
            generator=generator,
        )
    elif cfg.regularization_strategy == "ags-mesh":
        surf = 2.0 * outputs["surface_normal"] - 1.0
        gtn = 2.0 * gt_normal_eff - 1.0 if gt_normal_eff is not None else None
        predn = 2.0 * pred_normal - 1.0
        reg_loss = ags_regularization_loss(
            reg_cfg,
            step=step,
            pred_depth=depth_out,
            gt_depth=depth_gt if cfg.use_depth_loss else None,
            confidence=confidence,
            surf_normal=surf,
            gt_normal=gtn,
            pred_normal=predn,
            scales=params.scales,
            gt_img=gt_img,
            alive=alive,
            pearson_corners=pearson_corners,
            generator=generator,
        )
    else:
        raise ValueError(cfg.regularization_strategy)

    total = main_loss + reg_loss

    # working versions of the reference's dead flags (default off)
    if cfg.use_depth_smooth_loss:
        if cfg.smooth_loss_type == "edge_aware_tv":
            total = total + cfg.smooth_loss_lambda * L.edge_aware_tv_loss(
                depth_out, gt_img)
        else:
            total = total + cfg.smooth_loss_lambda * L.tv_loss(depth_out)
    if cfg.use_sparse_loss and step % cfg.sparse_loss_steps == 0:
        total = total + cfg.sparse_lambda * L.sparse_opacity_loss(
            params.opacities, alive)

    total = total + scale_reg
    loss_dict = {
        "main_loss": main_loss + reg_loss,
        "scale_reg": scale_reg,
        "rgb_loss": main_loss,
        "reg_loss": reg_loss,
    }
    return total, loss_dict


def apply_binary_opacities(params: GaussianParams, alive: torch.Tensor,
                           cfg: ModelConfig, step: int) -> GaussianParams:
    """Binary-opacity trick: outside the opacity-reset margin, snap live
    opacity logits to +-15 by thresholding the sigmoided opacity (the JAX
    package's reading of the flag, its PARITY.md)."""
    if not cfg.use_binary_opacities:
        return params
    step = int(step)
    skip = cfg.reset_alpha_every * cfg.refine_every
    if not (step > cfg.warmup_length and (step % skip) > 200):
        return params
    o = torch.sigmoid(params.opacities)
    snapped = torch.where(o >= cfg.binary_opacities_threshold, 15.0, -15.0)
    new_o = torch.where(alive > 0.5, snapped, params.opacities)
    return dataclasses.replace(params, opacities=new_o)
