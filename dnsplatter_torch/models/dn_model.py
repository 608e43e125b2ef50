"""DN-Splatter model outputs (counterpart of
dnsplatter_tpu/models/dn_model.py).

`ModelConfig` carries every flag of the JAX package with its default;
`get_outputs` renders the reference's output dict {rgb, depth, normal,
surface_normal, accumulation, background} in one rasterizer pass.
`compute_loss` and the training-time random background come with the
training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from dnsplatter_torch.models.gaussians import GaussianParams
from dnsplatter_torch.ops.camera import Camera
from dnsplatter_torch.ops.rasterize import RasterizeConfig
from dnsplatter_torch.ops.render import RenderInfo, render

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


def sh_degree_to_use(step: int, cfg: ModelConfig) -> int:
    """SH degree schedule: one degree per `sh_degree_interval` steps."""
    return min(int(step) // cfg.sh_degree_interval, cfg.sh_degree)


def get_outputs(
    params: GaussianParams,
    alive: torch.Tensor,
    camera: Camera,
    cfg: ModelConfig,
    raster_cfg: RasterizeConfig,
    sh_degree: int = 3,
    background: Optional[torch.Tensor] = None,
    training: bool = False,
    crop_box=None,
) -> Tuple[Dict[str, torch.Tensor], RenderInfo]:
    """The reference `get_outputs` dict, at evaluation (`training=False`).
    Without a `background`, eval uses Viser's grey."""
    if training:
        raise NotImplementedError(
            "get_outputs(training=True) comes with the training slice "
            "(ROADMAP.md queue A item 5)")
    if background is None:
        background = torch.tensor(VISER_BACKGROUND, dtype=torch.float32,
                                  device=params.means.device)
    out, info = render(params, alive, camera, raster_cfg,
                       sh_degree_to_use=sh_degree, background=background,
                       rasterize_mode=cfg.rasterize_mode, crop_box=crop_box)
    # Unit-normalize the composited normal map (rsqrt(|n|^2 + eps), as the
    # JAX package) and map it to [0, 1].
    n = out.normal
    n = n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
    outputs = {
        "rgb": out.rgb,
        "depth": out.depth,
        "normal": (n + 1.0) * 0.5,
        "surface_normal": out.surface_normal,
        "accumulation": out.accumulation,
        "background": out.background,
    }
    return outputs, info
