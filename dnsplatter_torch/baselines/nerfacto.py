"""g_nerfacto / g_depthnerfacto baselines: hash-field NeRF ray marching
(counterpart of dnsplatter_tpu/baselines/nerfacto.py).

Hierarchical sampling (uniform coarse + pdf fine) over a hash-encoded
density/colour field, volume rendering with expected depth; g_depthnerfacto
adds a depth loss on the expected-depth render. The random draws (pixels,
coarse jitter, the pdf's uniforms) come from a `torch.Generator`, or are
passed in as `draws` so that tests can feed the JAX package's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from dnsplatter_torch.baselines import fields as F
from dnsplatter_torch.ops.camera import GL_TO_CV

N_RAYS = 1024  # rays a train step (the JAX step's constant)


@dataclasses.dataclass(frozen=True)
class NerfactoConfig:
    near: float = 0.05
    far: float = 12.0
    n_coarse: int = 64
    n_fine: int = 64
    hash: F.HashGridConfig = F.HashGridConfig()
    hidden: int = 64
    geo_feat: int = 15
    use_depth_loss: bool = False  # g_depthnerfacto
    depth_lambda: float = 0.1
    scene_scale: float = 4.0  # world box [-s, s] mapped into [0,1]^3


class NerfactoParams(nn.Module):
    """`tables` (L, T, F), `density_mlp` and `color_mlp` (`w{i}`, `b{i}`):
    the JAX NamedTuple's fields."""

    def __init__(self, cfg: NerfactoConfig,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        in_dim = cfg.hash.n_levels * cfg.hash.features_per_level
        if generator is None:
            tables = torch.zeros((cfg.hash.n_levels,
                                  1 << cfg.hash.log2_table_size,
                                  cfg.hash.features_per_level))
        else:
            tables = F.init_hash_grid(generator, cfg.hash)
        self.tables = nn.Parameter(tables.to(device))
        self.density_mlp = F.init_mlp(
            generator, (in_dim, cfg.hidden, 1 + cfg.geo_feat), device)
        self.color_mlp = F.init_mlp(
            generator, (cfg.geo_feat + 9, cfg.hidden, cfg.hidden, 3), device)


def init_params(generator: torch.Generator, cfg: NerfactoConfig,
                device=None) -> NerfactoParams:
    return NerfactoParams(cfg, generator, device)


def _density_geo(params: NerfactoParams, cfg: NerfactoConfig,
                 pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x01 = torch.clamp(pts / (2 * cfg.scene_scale) + 0.5, 0.0, 1.0)
    h = params.density_mlp(F.hash_encode(params.tables, x01, cfg.hash))
    return nn.functional.softplus(h[..., 0] - 1.0), h[..., 1:]


def field(params: NerfactoParams, cfg: NerfactoConfig, pts: torch.Tensor,
          dirs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """pts (..., 3) world, dirs (..., 3) -> (density (...), rgb (..., 3))."""
    density, geo = _density_geo(params, cfg, pts)
    rgb = params.color_mlp(torch.cat([geo, F.sh_dir_encode(dirs)], -1),
                           torch.sigmoid)
    return density, rgb


def _render_weights(density: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """(R, S) densities + (R, S) sample distances -> (R, S) weights."""
    deltas = torch.diff(ts, dim=-1, append=ts[..., -1:] + 1e10)
    alpha = 1.0 - torch.exp(-density * deltas)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    return alpha * trans


@torch.no_grad()
def _sample_pdf(ts: torch.Tensor, weights: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF resampling between coarse sample midpoints at the
    uniforms `u` (R, n)."""
    mids = 0.5 * (ts[..., 1:] + ts[..., :-1])
    w = weights[..., 1:-1] + 1e-5
    pdf = w / torch.sum(w, -1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, -1)],
                    -1).contiguous()
    idx = torch.searchsorted(cdf, u.contiguous(), right=True)
    idx = torch.clamp(idx, 1, cdf.shape[-1] - 1)
    lo = torch.gather(cdf, -1, idx - 1)
    hi = torch.gather(cdf, -1, idx)
    last = mids.shape[-1] - 1
    t_lo = torch.gather(mids, -1, torch.clamp(idx - 1, 0, last))
    t_hi = torch.gather(mids, -1, torch.clamp(idx, 0, last))
    frac = (u - lo) / torch.clamp(hi - lo, min=1e-8)
    return t_lo + frac * (t_hi - t_lo)


def ray_draws(cfg: NerfactoConfig, n_rays: int,
              generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The uniforms of one render: coarse jitter (R, n_coarse) and the
    pdf's (R, n_fine), in [0, 1)."""
    dev = generator.device
    return {"jitter": torch.rand((n_rays, cfg.n_coarse), generator=generator,
                                 device=dev),
            "u": torch.rand((n_rays, cfg.n_fine), generator=generator,
                            device=dev)}


def render_rays(params: NerfactoParams, cfg: NerfactoConfig,
                origins: torch.Tensor, dirs: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """origins (R, 3), unit dirs (R, 3) -> rgb (R, 3), depth and
    accumulation (R, 1). `draws` holds the uniforms ("jitter", "u"; from
    `generator` when not given) or the sample distances "ts" (R, S) they
    lead to."""
    if draws is None:
        draws = ray_draws(cfg, origins.shape[0], generator)
    ts = draws["ts"] if "ts" in draws else sample_distances(
        params, cfg, origins, dirs, draws)
    return render_samples(params, cfg, origins, dirs, ts)


@torch.no_grad()
def sample_distances(params: NerfactoParams, cfg: NerfactoConfig,
                     origins: torch.Tensor, dirs: torch.Tensor,
                     draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(R, n_coarse + n_fine) sorted sample distances: the jittered coarse
    grid and the fine samples drawn from its weights. They only place the
    samples (the JAX package stops their gradient), so no autograd here."""
    r = origins.shape[0]
    t_coarse = torch.linspace(cfg.near, cfg.far, cfg.n_coarse,
                              device=origins.device).expand(r, cfg.n_coarse)
    t_coarse = t_coarse + draws["jitter"] * (
        (cfg.far - cfg.near) / cfg.n_coarse)
    pts = origins[:, None] + t_coarse[..., None] * dirs[:, None]
    dens_c, _ = _density_geo(params, cfg, pts)
    w_c = _render_weights(dens_c, t_coarse)
    t_fine = _sample_pdf(t_coarse, w_c, draws["u"])
    return torch.sort(torch.cat([t_coarse, t_fine], -1), -1)[0]


def render_samples(params: NerfactoParams, cfg: NerfactoConfig,
                   origins: torch.Tensor, dirs: torch.Tensor,
                   ts: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Volume rendering of the field at sample distances `ts` (R, S)."""
    pts = origins[:, None] + ts[..., None] * dirs[:, None]
    dens, rgb = field(params, cfg, pts, dirs[:, None].expand(pts.shape))
    w = _render_weights(dens, ts)
    rgb_out = torch.sum(w[..., None] * rgb, dim=1)
    acc = torch.sum(w, dim=1, keepdim=True)
    depth = torch.sum(w * ts, dim=1, keepdim=True) / F.jmax(acc, 1e-8)
    return {"rgb": rgb_out, "depth": depth, "accumulation": acc}


def camera_rays(camera, pixels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pixels (R, 2) int (x, y) -> world-space (origins, unit dirs)."""
    x = (pixels[:, 0].float() + 0.5 - camera.cx) / camera.fx
    y = (pixels[:, 1].float() + 0.5 - camera.cy) / camera.fy
    d_cam = torch.stack([x, y, torch.ones_like(x)], -1)  # OpenCV frame
    c2w_cv = camera.c2w @ torch.as_tensor(GL_TO_CV, device=camera.device)
    d_world = d_cam @ c2w_cv[:3, :3].T
    d_world = d_world / torch.linalg.norm(d_world, dim=-1, keepdim=True)
    return c2w_cv[:3, 3].expand(d_world.shape), d_world


def pixel_draws(n_rays: int, width: int, height: int,
                generator: torch.Generator) -> torch.Tensor:
    """(n_rays, 2) int64 pixels (x, y), uniform over the image."""
    dev = generator.device
    return torch.stack([
        torch.randint(0, width, (n_rays,), generator=generator, device=dev),
        torch.randint(0, height, (n_rays,), generator=generator, device=dev),
    ], -1)


class Adam:
    """optax.adam(lr)'s rule (b1 0.9, b2 0.999, eps 1e-8 outside the square
    root, bias-corrected), one parameter at a time in a plain loop, as
    `torch.optim.Adam(foreach=False)` computes it. Not that class itself:
    building one imports `torch._dynamo`, seconds of start-up in every
    process that trains a baseline."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: nn.Module, lr: float):
        self.params = list(params.parameters())
        self.lr = lr
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (nu / c2).sqrt_().add_(self.eps)
            p.addcdiv_(mu, denom, value=-self.lr / c1)


def train_loss(params: NerfactoParams, cfg: NerfactoConfig, camera,
               image: torch.Tensor, depth_gt: Optional[torch.Tensor],
               draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The step's loss on the rays of `draws["px"]` (and the rest of the
    draws, see `render_rays`): colour MSE, plus the masked L1 depth term for
    g_depthnerfacto."""
    px = draws["px"]
    o, d = camera_rays(camera, px)
    gt = image[px[:, 1], px[:, 0]]
    out = render_rays(params, cfg, o, d, draws=draws)
    loss = torch.mean((out["rgb"] - gt) ** 2)
    if cfg.use_depth_loss and depth_gt is not None:
        dgt = depth_gt[px[:, 1], px[:, 0]]
        mask = (dgt[:, 0] > 0.1).float()
        loss = loss + cfg.depth_lambda * torch.sum(
            mask * torch.abs(out["depth"][:, 0] - dgt[:, 0])
        ) / torch.clamp(mask.sum(), min=1.0)
    return loss


def make_train_step(cfg: NerfactoConfig, lr: float = 1e-2):
    """(step, Adam init): `step(params, opt, camera, image, depth_gt,
    generator=None, draws=None)` takes one Adam step over `N_RAYS` random
    pixel rays of one frame and returns the loss (detached)."""

    def step(params, opt, camera, image, depth_gt, generator=None,
             draws=None):
        if draws is None:
            draws = {"px": pixel_draws(N_RAYS, camera.width, camera.height,
                                       generator),
                     **ray_draws(cfg, N_RAYS, generator)}
        opt.zero_grad()
        loss = train_loss(params, cfg, camera, image, depth_gt, draws)
        loss.backward()
        opt.step()
        return loss.detach()

    return step, functools.partial(Adam, lr=lr)
