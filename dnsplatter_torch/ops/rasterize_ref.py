"""Dense oracle rasterizer (counterpart of
dnsplatter_tpu/ops/rasterize_ref.py).

Composites every valid Gaussian over every pixel in strict global depth
order with the CUDA rasterizer's per-pixel termination: alpha =
min(0.999, op * exp(-sigma)), skipped below 1/255; a pixel stops when the
would-be next transmittance drops to <= 1e-4, and the Gaussian that trips
it is not composited. O(N * H * W): tests and tiny scenes only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dnsplatter_torch.ops.camera import pixel_coords

ALPHA_THRESHOLD = 1.0 / 255.0
MAX_ALPHA = 0.999
TRANSMITTANCE_EPS = 1e-4


def rasterize_pixels_ref(
    means2d: torch.Tensor,
    conics: torch.Tensor,
    depths: torch.Tensor,
    opacities: torch.Tensor,
    features: torch.Tensor,
    valid: torch.Tensor,
    width: int,
    height: int,
    radii: torch.Tensor | None = None,
    tile_size: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (image (H, W, F) without background, alpha (H, W, 1)).

    With `radii` ((N,) or (N, 2)), a Gaussian only touches pixels whose
    tile meets its [mean - radius, mean + radius] box, as tile binning
    does.
    """
    dev = means2d.device
    n = means2d.shape[0]
    hw = height * width
    valid = valid.bool()
    order = torch.argsort(torch.where(valid, depths, torch.inf), stable=True)
    means2d = means2d[order]
    conics = conics[order]
    opacities = torch.where(valid[order], opacities[order], 0.0)
    features = features[order]
    if radii is None:
        radii_s = torch.full((n, 2), torch.inf, device=dev)
    else:
        if radii.ndim == 1:
            radii = torch.stack([radii, radii], -1)
        radii_s = radii[order]

    pix = pixel_coords(width, height, device=dev).reshape(hw, 2)
    pix_tile = torch.floor(pix / tile_size)
    t = torch.ones(hw, device=dev)
    done = torch.zeros(hw, dtype=torch.bool, device=dev)
    out = torch.zeros(hw, features.shape[-1], device=dev)
    for g in range(n):
        d = pix - means2d[g][None, :]
        con = conics[g]
        sigma = (0.5 * (con[0] * d[:, 0] ** 2 + con[2] * d[:, 1] ** 2)
                 + con[1] * d[:, 0] * d[:, 1])
        alpha = torch.clamp_max(opacities[g] * torch.exp(-sigma), MAX_ALPHA)
        tile_lo = torch.floor((means2d[g] - radii_s[g]) / tile_size)
        tile_hi = torch.floor((means2d[g] + radii_s[g]) / tile_size)
        in_fp = torch.all((pix_tile >= tile_lo) & (pix_tile <= tile_hi),
                          dim=-1)
        hit = (sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD) & in_fp
        next_t = t * (1.0 - alpha)
        would_terminate = hit & (next_t <= TRANSMITTANCE_EPS)
        accept = hit & ~done & ~would_terminate
        w = torch.where(accept, alpha * t, 0.0)
        out = out + w[:, None] * features[g][None, :]
        t = torch.where(accept, next_t, t)
        done = done | would_terminate
    image = out.reshape(height, width, -1)
    alpha = (1.0 - t).reshape(height, width, 1)
    return image, alpha


def render_ref(means, quats, scales, opacities, features, camera,
               near_plane: float = 0.01, far_plane: float = 1e10,
               eps2d: float = 0.3, rasterize_mode: str = "classic"):
    """Oracle render: projection + camera-z depth channel + compositing.

    Returns (image (H,W,F), accumulated depth (H,W,1), alpha (H,W,1)).
    """
    from dnsplatter_torch.ops.projection import project_gaussians

    proj = project_gaussians(
        means, quats, scales, camera.viewmat(), camera.fx, camera.fy,
        camera.cx, camera.cy, camera.width, camera.height, eps2d=eps2d,
        near_plane=near_plane, far_plane=far_plane,
    )
    opac = opacities
    if rasterize_mode == "antialiased":
        opac = opac * proj.compensations
    feats = torch.cat([features, proj.depths[:, None]], dim=-1)
    img, alpha = rasterize_pixels_ref(
        proj.means2d, proj.conics, proj.depths, opac, feats, proj.valid,
        camera.width, camera.height,
    )
    return img[..., :-1], img[..., -1:], alpha
