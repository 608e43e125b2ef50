"""Gaussian-axis sharding, the "gspmd" strategy (counterpart of
dnsplatter_tpu/parallel/sharding.py).

Every per-Gaussian stage (projection, SH, normals, the Adam update, the
statistics) is parallel along the capacity axis, so rank g of G keeps rows
[g C / G, (g + 1) C / G) of the parameters, `alive`, the Adam state and
the statistics. The JAX package lets GSPMD insert the collectives; here
they are explicit. One step:

1. each rank projects, evaluates SH and computes normals for its rows;
2. one `all_gather_rows(..., backward="slice")` collects the screen-space
   payload, the absgrad sink and the rows the loss reads (log-scales,
   opacity logits, alive): 24 float32 a Gaussian;
3. every rank bins, rasterizes and takes the loss of the whole frame,
   redundantly and identically;
4. the gradient of the gathered rows is then the same on every rank, so
   each keeps its own rows' part and nothing moves back (a sum over ranks
   would multiply it by G);
5. Adam and the statistics update run on the shard.

Bytes a step: the gather, C x 96 bytes, against 992 bytes a Gaussian of
parameters and Adam state at SH degree 3; no O(capacity x SH) exchange.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import torch

from dnsplatter_torch.models.dn_model import outputs_dict, pick_background
from dnsplatter_torch.ops.rasterize import rasterize
from dnsplatter_torch.ops.render import (
    RenderInfo,
    ScreenSpace,
    finish,
    screen_space,
)
from dnsplatter_torch.parallel import collectives as C
from dnsplatter_torch.parallel.collectives import Axis
from dnsplatter_torch.parallel.distributed import (
    Mesh,
    dist_context,
    make_hybrid_mesh,
    shard_state_hybrid,
)

# columns of the screen-space payload: means2d, conics, depth, opacity,
# per-axis radii, valid, then the 7 composited features
PAYLOAD_COLS = 17


class LossRows(NamedTuple):
    """The per-Gaussian parameters `compute_loss` reads."""

    scales: torch.Tensor
    opacities: torch.Tensor


def make_mesh(n: Optional[int] = None) -> Mesh:
    """The world as one Gaussian axis (dp = 1). `n`, if given, must be the
    world size: the port runs one process a device."""
    world = dist_context().process_count
    if n is not None and n != world:
        raise ValueError(f"{n} devices asked for, {world} processes in the "
                         f"world: launch one process a device (torchrun "
                         f"--nproc-per-node {n})")
    return make_hybrid_mesh(dp=1)


def shard_gaussian_state(mesh: Mesh, params, alive, adam, stats):
    """This rank's rows of the full training state (see the module note);
    ValueError unless the capacity divides into G shards."""
    return shard_state_hybrid(mesh, params, alive, adam, stats)


def pack_payload(ss: ScreenSpace) -> torch.Tensor:
    """(N, PAYLOAD_COLS) float32: the rasterizer's inputs of each Gaussian."""
    return torch.cat([ss.means2d, ss.conics, ss.depths[:, None],
                      ss.opacities[:, None], ss.radii_xy,
                      ss.valid.to(torch.float32)[:, None], ss.features], -1)


def rasterize_payload(payload: torch.Tensor, cfg, sink: torch.Tensor,
                      y0: float = 0.0):
    """Rasterize gathered payload rows; `y0` shifts the screen rows (a tile
    slab's origin). The depth and radii columns take no gradient."""
    m2d = payload[:, 0:2]
    if y0:
        m2d = m2d - m2d.new_tensor([0.0, y0])
    return rasterize(m2d, payload[:, 2:5], payload[:, 5], payload[:, 6],
                     payload[:, PAYLOAD_COLS - 7:], payload[:, 9], cfg,
                     absgrad_sink=sink, radii=payload[:, 7:9])


def local_camera(camera, axis: Axis):
    """The camera of this rank's rows: its pose gradient (the pose
    optimizer's) comes from those rows only, so it is summed over the
    axis."""
    return dataclasses.replace(camera,
                               c2w=C.sum_gradients(camera.c2w, axis))


def local_info(ss: ScreenSpace) -> RenderInfo:
    return RenderInfo(radii=ss.radii, depths=ss.depths, valid=ss.valid,
                      means2d=ss.means2d)


def gspmd_outputs(axis: Axis) -> Callable:
    """The `outputs_fn` of the gspmd strategy over `axis` (see
    `train.trainer.single_device_outputs` for the signature): the render
    of the whole frame from this rank's rows."""

    def outputs_fn(params, alive, camera, model_cfg, raster_cfg, sh_degree,
                   background, absgrad_sink, generator):
        if background is None:
            background = pick_background(model_cfg, True, generator,
                                         params.means.device)
        ss = screen_space(params, alive, local_camera(camera, axis),
                          sh_degree, model_cfg.rasterize_mode)
        mine = torch.cat([pack_payload(ss), absgrad_sink, params.scales,
                          params.opacities[:, None], alive[:, None]], -1)
        # Every rank takes the same loss of the same gathered rows, so the
        # gradient of those rows is identical everywhere: "slice".
        full = C.all_gather_rows(mine, axis, backward="slice")
        p = PAYLOAD_COLS
        img, alpha = rasterize_payload(full[:, :p], raster_cfg,
                                       full[:, p:p + 2])
        out = outputs_dict(finish(img, alpha, camera, background))
        rows = LossRows(scales=full[:, p + 2:p + 5],
                        opacities=full[:, p + 5])
        return out, local_info(ss), rows, full[:, p + 6]

    return outputs_fn


def make_sharded_train_step(model_cfg, optim_cfg, raster_cfg,
                            sh_degree: int, mesh: Mesh) -> Callable:
    """The gspmd train step over the mesh's Gaussian axis: `train_step`'s
    arguments from `params` on, on this rank's shard, with the camera,
    batch and draws the same on every rank; returns this rank's shard of
    the update."""
    from dnsplatter_torch.train.trainer import train_step

    return functools.partial(train_step, model_cfg, optim_cfg, raster_cfg,
                             sh_degree,
                             outputs_fn=gspmd_outputs(mesh.gauss_axis))
