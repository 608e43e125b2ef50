"""ADC refinement strategy: densify / duplicate / cull / opacity reset
(counterpart of dnsplatter_tpu/train/strategy.py).

The Gaussian state lives in fixed-capacity tensors with an `alive` mask,
and refinement is a set of indexed stores:

  * screen-space gradient statistics accumulate every step from the
    rasterizer's absgrad sink;
  * split: high-gradient large Gaussians spawn `n_split_samples` children
    sampled from their own ellipsoid, scales / 1.6, originals culled;
  * duplicate: high-gradient small Gaussians are copied once;
  * cull: low-opacity and oversized (world or screen) Gaussians die;
  * opacity reset: logits clamp to logit(2 * cull_alpha_thresh) and the
    opacities' Adam moments are zeroed.

New Gaussians go into dead slots in the order of a stable argsort of
`alive` (dead slots first, ascending index): duplicates first, then each
split parent's children side by side. Children that find no free slot are
dropped. Which action fires at which step is the Trainer's business.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from dnsplatter_torch import resolve_device
from dnsplatter_torch.models.dn_model import ModelConfig
from dnsplatter_torch.models.gaussians import FIELDS, GaussianParams
from dnsplatter_torch.ops.quat import quat_rotate
from dnsplatter_torch.train.optim import (
    AdamState,
    zero_moments_at,
    zero_moments_field,
)
from dnsplatter_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class RefineStats:
    """Accumulated densification statistics."""

    grad_sum: torch.Tensor  # (C,) sum of screen-space grad norms when visible
    vis_count: torch.Tensor  # (C,) visibility counts
    max_2d: torch.Tensor  # (C,) max screen radius / max(W, H)


def init_stats(capacity: int, device=None) -> RefineStats:
    dev = resolve_device(device)
    return RefineStats(*(torch.zeros(capacity, device=dev) for _ in range(3)))


def stats_to_numpy(stats: RefineStats) -> dict:
    return {f.name: getattr(stats, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(RefineStats)}


def stats_from_numpy(arrays: Mapping[str, np.ndarray],
                     device=None) -> RefineStats:
    """The JAX package's RefineStats, as numpy arrays keyed by field."""
    dev = resolve_device(device)
    return RefineStats(**{
        f.name: torch.as_tensor(np.asarray(arrays[f.name], np.float32),
                                device=dev)
        for f in dataclasses.fields(RefineStats)})


@torch.no_grad()
def update_stats(stats: RefineStats, grad2d: torch.Tensor,
                 radii: torch.Tensor, valid: torch.Tensor,
                 max_size: float) -> RefineStats:
    """grad2d (C, 2): the absgrad of means2d; valid (C,) bool."""
    gn = torch.linalg.norm(grad2d, dim=-1)
    vis = valid.to(torch.float32)
    return RefineStats(
        grad_sum=stats.grad_sum + gn * vis,
        vis_count=stats.vis_count + vis,
        max_2d=torch.maximum(stats.max_2d,
                             torch.where(valid, radii / max_size, 0.0)),
    )


def _free_slots(alive: torch.Tensor) -> torch.Tensor:
    """Slot indices, dead slots first, each group in ascending order."""
    return torch.argsort(alive, stable=True)


def _write_rows(params: GaussianParams, slots: torch.Tensor,
                rows: GaussianParams, ok: torch.Tensor
                ) -> Tuple[GaussianParams, torch.Tensor]:
    """`rows[ok]` stored at `slots[ok]`, field by field (new tensors),
    and the slots written. Which rows are written is read back once
    (`sync.refine_rows`)."""
    sel = profiling.host_read("refine_rows", torch.nonzero, ok)[:, 0]
    tgt = slots[sel]
    out = {}
    for f in FIELDS:
        dst = getattr(params, f).clone()
        dst[tgt] = getattr(rows, f)[sel]
        out[f] = dst
    return GaussianParams(**out), tgt


def _cull_mask(cfg: ModelConfig, params: GaussianParams,
               stats: RefineStats, step: int, sizes: torch.Tensor
               ) -> torch.Tensor:
    """Low alpha, plus (after the first opacity reset) world or screen
    oversize."""
    culls = torch.sigmoid(params.opacities) < cfg.cull_alpha_thresh
    if step > cfg.refine_every * cfg.reset_alpha_every:
        too_big = sizes > cfg.cull_scale_thresh
        if step < cfg.stop_screen_size_at:
            too_big = too_big | (stats.max_2d > cfg.cull_screen_size)
        culls = culls | too_big
    return culls


@torch.no_grad()
def densify_and_cull(
    cfg: ModelConfig,
    params: GaussianParams,
    alive: torch.Tensor,
    adam: AdamState,
    stats: RefineStats,
    step: int,
    max_size: float,
    draws: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[GaussianParams, torch.Tensor, AdamState, RefineStats]:
    """One densify + cull event. `draws` (n_split_samples, C, 3) are the
    standard-normal samples that place the split children; without them
    they come from `generator` (on its device). The Adam state is updated
    in place."""
    step = int(step)
    capacity = params.capacity
    dev = alive.device
    alive_b = alive > 0.5
    if draws is None:
        gdev = generator.device if generator is not None else dev
        draws = torch.randn((cfg.n_split_samples, capacity, 3),
                            generator=generator, device=gdev).to(dev)

    avg_grad = (stats.grad_sum / torch.clamp_min(stats.vis_count, 1.0)
                * 0.5 * max_size)
    high_grads = (avg_grad > cfg.densify_grad_thresh) & alive_b
    scales_lin = torch.exp(params.scales)
    sizes = torch.amax(scales_lin, dim=-1)

    splits = sizes > cfg.densify_size_thresh
    if step < cfg.stop_screen_size_at:
        splits = splits | (stats.max_2d > cfg.split_screen_size)
    splits = splits & high_grads
    dups = (sizes <= cfg.densify_size_thresh) & high_grads

    # split originals always die
    culls = (_cull_mask(cfg, params, stats, step, sizes) | splits) & alive_b
    alive_new = torch.where(culls, 0.0, alive)

    free = _free_slots(alive_new)
    n_free = (alive_new < 0.5).sum()

    # duplicates: one copy each
    dup_rank = torch.cumsum(dups.long(), 0) - 1
    n_dups = dups.sum()
    dup_ok = dups & (dup_rank < n_free)
    dup_slots = free[dup_rank.clamp(0, capacity - 1)]
    params_new, tgt = _write_rows(params, dup_slots, params, dup_ok)
    alive_new[tgt] = 1.0
    touched = [tgt]

    # splits: n_split_samples children sampled inside the parent
    split_rank = torch.cumsum(splits.long(), 0) - 1
    new_scales = torch.log(scales_lin / 1.6)
    for s in range(cfg.n_split_samples):
        offs = quat_rotate(params.quats, draws[s] * scales_lin)
        child = dataclasses.replace(params, means=params.means + offs,
                                    scales=new_scales)
        slot_idx = n_dups + split_rank * cfg.n_split_samples + s
        ok = splits & (slot_idx < n_free)
        slots = free[slot_idx.clamp(0, capacity - 1)]
        params_new, tgt = _write_rows(params_new, slots, child, ok)
        alive_new[tgt] = 1.0
        touched.append(tgt)

    # Zero the moments of every written slot, and of culled slots too, so
    # stale moments never leak into a slot that is revived later.
    touched.append(profiling.host_read("cull", torch.nonzero, culls)[:, 0])
    adam = zero_moments_at(adam, torch.cat(touched))
    return params_new, alive_new, adam, init_stats(capacity, dev)


@torch.no_grad()
def cull_only(cfg: ModelConfig, params: GaussianParams, alive: torch.Tensor,
              adam: AdamState, stats: RefineStats, step: int
              ) -> Tuple[GaussianParams, torch.Tensor, AdamState, RefineStats]:
    """Post-densification culling."""
    sizes = torch.amax(torch.exp(params.scales), dim=-1)
    culls = _cull_mask(cfg, params, stats, int(step), sizes)
    alive_new = torch.where(culls & (alive > 0.5), 0.0, alive)
    return params, alive_new, adam, init_stats(params.capacity, alive.device)


@torch.no_grad()
def reset_opacity(cfg: ModelConfig, params: GaussianParams, adam: AdamState
                  ) -> Tuple[GaussianParams, AdamState]:
    """Clamp the logits to logit(2 * cull_alpha_thresh) and zero the
    opacities' Adam moments."""
    reset_value = cfg.cull_alpha_thresh * 2.0
    max_logit = float(np.log(np.float32(reset_value / (1.0 - reset_value))))
    if not math.isfinite(max_logit):
        raise ValueError("cull_alpha_thresh must be in (0, 0.5)")
    params = dataclasses.replace(
        params, opacities=torch.clamp_max(params.opacities, max_logit))
    return params, zero_moments_field(adam, "opacities")
