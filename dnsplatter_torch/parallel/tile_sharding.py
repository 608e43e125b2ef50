"""Tile-sharded rendering, the "tile" strategy (counterpart of
dnsplatter_tpu/parallel/tile_sharding.py).

The workload's two parallel axes are Gaussians and image tiles:

* the Gaussian state lives sharded along the capacity axis, and each rank
  projects and SH-evaluates its own rows;
* the projected payload (17 float32 a Gaussian, plus the absgrad sink) is
  gathered with `all_gather_rows(..., backward="sum")`;
* each rank owns a horizontal slab of tile rows and rasterizes it with the
  ordinary rasterizer, the gathered means2d shifted by the slab's `y0`, so
  the same kernels run unchanged on a shorter frame;
* the slabs are assembled with a gather whose backward is "this rank's
  slab" (every rank takes the same loss of the assembled image, so the
  image gradient is the same everywhere), and the image-space
  post-processing runs on the assembled image;
* backward: each slab's rasterizer backward adds its own pairs' part to
  every Gaussian, so the payload gather's backward sums over ranks onto
  each row's owner (a reduce-scatter under NCCL).

The slab height is the padded frame height over the rank count in whole
tile rows, so every rank rasterizes the same shape.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch

from dnsplatter_torch.models.dn_model import outputs_dict, pick_background
from dnsplatter_torch.ops.rasterize import RasterizeConfig
from dnsplatter_torch.ops.render import finish, screen_space
from dnsplatter_torch.parallel import collectives as C
from dnsplatter_torch.parallel.collectives import Axis
from dnsplatter_torch.parallel.distributed import Mesh
from dnsplatter_torch.parallel.sharding import (
    PAYLOAD_COLS,
    LossRows,
    local_camera,
    local_info,
    pack_payload,
    rasterize_payload,
)


def slab_config(cfg: RasterizeConfig, n_devices: int
                ) -> Tuple[RasterizeConfig, int]:
    """Per-device slab rasterizer config + slab pixel height."""
    rows = cfg.tiles_y
    rows_per_dev = -(-rows // n_devices)
    slab_h = rows_per_dev * cfg.tile_size
    cap = max(cfg.pair_capacity // n_devices, 1 << 12)
    slab_cfg = dataclasses.replace(
        cfg, height=slab_h,
        pair_capacity=-(-cap // cfg.chunk) * cfg.chunk)
    return slab_cfg, slab_h


def _slab_render(payload, sink, cfg: RasterizeConfig, axis: Axis):
    """This rank's slab of the gathered payload, assembled with the other
    ranks' slabs: (image (H, W, F), alpha (H, W, 1))."""
    slab_cfg, slab_h = slab_config(cfg, axis.size)
    img, alpha = rasterize_payload(payload, slab_cfg, sink,
                                   y0=float(axis.rank * slab_h))
    f = img.shape[-1]
    # identical loss on every rank downstream: the slab's gradient is this
    # rank's rows of the image gradient, no sum
    full = C.all_gather_rows(torch.cat([img, alpha], -1), axis,
                             backward="slice")[:cfg.height]
    return full[..., :f], full[..., f:]


def _gathered_payload(ss, sink, axis: Axis):
    # each slab adds its own pairs' gradient: the owner needs the sum
    full = C.all_gather_rows(torch.cat([pack_payload(ss), sink], -1), axis,
                             backward="sum")
    return full[:, :PAYLOAD_COLS], full[:, PAYLOAD_COLS:]


def tile_sharded_render(params, alive: torch.Tensor, camera,
                        cfg: RasterizeConfig, mesh: Mesh,
                        sh_degree: int = 3
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable multi-rank render of the raw composites: (image
    (H, W, 7), alpha (H, W, 1)), the same on every rank. `params` / `alive`
    are this rank's rows."""
    axis = mesh.gauss_axis
    ss = screen_space(params, alive, camera, sh_degree)
    payload, sink = _gathered_payload(
        ss, torch.zeros_like(params.means[:, :2]), axis)
    return _slab_render(payload, sink, cfg, axis)


def tile_outputs(axis: Axis) -> Callable:
    """The `outputs_fn` of the tile strategy over `axis` (see
    `train.trainer.single_device_outputs` for the signature)."""

    def outputs_fn(params, alive, camera, model_cfg, raster_cfg, sh_degree,
                   background, absgrad_sink, generator):
        if background is None:
            background = pick_background(model_cfg, True, generator,
                                         params.means.device)
        ss = screen_space(params, alive, local_camera(camera, axis),
                          sh_degree, model_cfg.rasterize_mode)
        payload, sink = _gathered_payload(ss, absgrad_sink, axis)
        img, alpha = _slab_render(payload, sink, raster_cfg, axis)
        # the loss's own rows: the same loss on every rank, "slice"
        rows = C.all_gather_rows(torch.cat(
            [params.scales, params.opacities[:, None], alive[:, None]], -1),
            axis, backward="slice")
        out = outputs_dict(finish(img, alpha, camera, background))
        return (out, local_info(ss),
                LossRows(scales=rows[:, :3], opacities=rows[:, 3]),
                rows[:, 4])

    return outputs_fn


def tile_sharded_outputs(params, alive, camera, model_cfg,
                         cfg: RasterizeConfig, mesh: Mesh,
                         sh_degree: int = 3,
                         background: Optional[torch.Tensor] = None,
                         absgrad_sink: Optional[torch.Tensor] = None,
                         training: bool = True,
                         generator: Optional[torch.Generator] = None):
    """`get_outputs` rendered tile-sharded: (outputs dict, RenderInfo of
    this rank's rows), the dict the same on every rank."""
    if background is None:
        background = pick_background(model_cfg, training, generator,
                                     params.means.device)
    if absgrad_sink is None:
        absgrad_sink = torch.zeros_like(params.means[:, :2])
    out, info, _, _ = tile_outputs(mesh.gauss_axis)(
        params, alive, camera, model_cfg, cfg, sh_degree, background,
        absgrad_sink, generator)
    return out, info


def make_tile_train_step(model_cfg, optim_cfg, raster_cfg,
                         sh_degree: int, mesh: Mesh) -> Callable:
    """The full train step over the tile-sharded renderer: `train_step`'s
    arguments from `params` on, on this rank's shard. The camera optimizer
    is not wired into the tile path (as in the JAX package): `cam_state`
    and `cam_i` are ignored."""
    from dnsplatter_torch.train.trainer import train_step

    inner = functools.partial(train_step, model_cfg, optim_cfg, raster_cfg,
                              sh_degree,
                              outputs_fn=tile_outputs(mesh.gauss_axis))

    def step_fn(params, alive, adam, stats, camera, batch, step,
                background=None, generator=None, pearson_corners=None,
                cam_state=None, cam_i=0):
        del cam_state, cam_i
        return inner(params, alive, adam, stats, camera, batch, step,
                     background=background, generator=generator,
                     pearson_corners=pearson_corners)

    return step_fn
