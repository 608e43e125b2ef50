"""Per-field Adam with the reference's learning rates (counterpart of
dnsplatter_tpu/train/optim.py).

Seven groups: means 1.6e-4 decaying exponentially to 1.6e-6 over
`max_steps`, features_dc 2.5e-3, features_rest 2.5e-3 / 20, opacities 5e-2,
scales 5e-3, quats 1e-3, normals 1e-3, eps 1e-15 everywhere. It is not
`torch.optim.Adam`: features_dc and features_rest sum their gradients over
a 10-step window and apply one update per window with a bias-correction
counter of their own, and densification zeroes moments slot by slot, which
is one indexed store when the moments are GaussianParams-shaped tensors.

`adam_step` returns new parameter tensors and updates the optimizer state
in place (moments, accumulators, counters): the state is owned by one
Trainer and nothing else holds its tensors, so a second copy of four
capacity-sized trees a step would only cost memory traffic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from dnsplatter_torch import resolve_device
from dnsplatter_torch.models.gaussians import (
    FIELDS,
    GaussianParams,
    params_from_numpy,
    params_to_numpy,
)


@dataclasses.dataclass
class AdamState:
    mu: GaussianParams  # first moments, shaped as the parameters
    nu: GaussianParams  # second moments
    count: Dict[str, int]  # per-field number of applied updates
    accum: GaussianParams  # per-field gradient accumulators


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr_means: float = 1.6e-4
    lr_means_final: float = 1.6e-6
    lr_features_dc: float = 2.5e-3
    lr_features_rest: float = 2.5e-3 / 20.0
    lr_opacities: float = 5e-2
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_normals: float = 1e-3
    max_steps: int = 30000
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-15
    # the reference steps the colour groups every 10 iterations with
    # summed gradients
    accum_features_dc: int = 10
    accum_features_rest: int = 10
    # camera-optimizer group (`cam_opt_update`)
    lr_camera_opt: float = 1e-3
    lr_camera_opt_final: float = 5e-5
    accum_camera_opt: int = 100

    def accum_steps(self) -> Dict[str, int]:
        """Per-field accumulation windows."""
        steps = {f: 1 for f in FIELDS}
        steps["features_dc"] = self.accum_features_dc
        steps["features_rest"] = self.accum_features_rest
        return steps


def _zeros_like(params: GaussianParams) -> GaussianParams:
    return GaussianParams(**{f: torch.zeros_like(getattr(params, f))
                             for f in FIELDS})


def init_adam(params: GaussianParams) -> AdamState:
    return AdamState(mu=_zeros_like(params), nu=_zeros_like(params),
                     count={f: 0 for f in FIELDS},
                     accum=_zeros_like(params))


def lr_tree(cfg: OptimConfig, step: int) -> Dict[str, float]:
    """Per-field learning rates; means follow
    lr0 * (lr_final / lr0) ** (step / max_steps), computed in float32 as
    the JAX package does."""
    frac = np.clip(np.float32(step) / np.float32(cfg.max_steps), 0.0, 1.0)
    lr_means = np.float32(cfg.lr_means) * np.power(
        np.float32(cfg.lr_means_final / cfg.lr_means), np.float32(frac))
    return {
        "means": float(lr_means),
        "scales": cfg.lr_scales,
        "quats": cfg.lr_quats,
        "features_dc": cfg.lr_features_dc,
        "features_rest": cfg.lr_features_rest,
        "opacities": cfg.lr_opacities,
        "normals": cfg.lr_normals,
    }


@torch.no_grad()
def adam_step(cfg: OptimConfig, params: GaussianParams,
              grads: GaussianParams, state: AdamState, step: int
              ) -> tuple[GaussianParams, AdamState]:
    """Adam with per-field gradient accumulation. A field with window N
    adds its gradient to the accumulator and, on every Nth call
    ((step + 1) % N == 0), applies one update with its own counter; N = 1
    is plain Adam. `state` is updated in place and returned."""
    step = int(step)
    lrs = lr_tree(cfg, step)
    windows = cfg.accum_steps()
    new = {}
    for f in FIELDS:
        p = getattr(params, f)
        acc = getattr(state.accum, f)
        acc.add_(getattr(grads, f))
        n = windows[f]
        if n > 1 and (step + 1) % n != 0:
            new[f] = p
            continue
        state.count[f] += 1
        cf = np.float32(max(state.count[f], 1))
        bc1 = float(np.float32(1.0) - np.power(np.float32(cfg.b1), cf))
        bc2 = float(np.float32(1.0) - np.power(np.float32(cfg.b2), cf))
        m = getattr(state.mu, f)
        v = getattr(state.nu, f)
        m.mul_(cfg.b1).add_(acc, alpha=1.0 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(acc, acc, value=1.0 - cfg.b2)
        new[f] = p - lrs[f] * (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        acc.zero_()
    return GaussianParams(**new), state


@torch.no_grad()
def zero_moments_at(state: AdamState, idx: torch.Tensor) -> AdamState:
    """Zero the moments and pending accumulators at the Gaussian slots
    `idx` (indices >= capacity are dropped): the densification surgery."""
    for tree in (state.mu, state.nu, state.accum):
        for f in FIELDS:
            x = getattr(tree, f)
            x[idx[idx < x.shape[0]]] = 0.0
    return state


@torch.no_grad()
def zero_moments_field(state: AdamState, field: str) -> AdamState:
    """Zero all moments of one field (the opacity-reset surgery)."""
    for tree in (state.mu, state.nu, state.accum):
        getattr(tree, field).zero_()
    return state


def pad_adam(state: AdamState, pad: int) -> AdamState:
    """The state at a capacity `pad` slots larger: new slots have no
    history."""
    def padz(tree):
        return GaussianParams(**{
            f: torch.cat([getattr(tree, f), torch.zeros(
                (pad,) + tuple(getattr(tree, f).shape[1:]),
                dtype=getattr(tree, f).dtype, device=getattr(tree, f).device)])
            for f in FIELDS})

    return AdamState(mu=padz(state.mu), nu=padz(state.nu),
                     count=dict(state.count), accum=padz(state.accum))


# -- state carried across the two packages (numpy in the JAX layout) --------


def adam_to_numpy(state: AdamState) -> Dict[str, np.ndarray]:
    """The JAX package's checkpoint keys of an AdamState:
    `adam.<mu|nu|count|accum>.<field>`, counts as () int32."""
    flat = {}
    for name in ("mu", "nu", "accum"):
        for f, a in params_to_numpy(getattr(state, name)).items():
            flat[f"adam.{name}.{f}"] = a
    for f in FIELDS:
        flat[f"adam.count.{f}"] = np.asarray(state.count[f], np.int32)
    return flat


def adam_from_numpy(flat: Mapping[str, np.ndarray], device=None) -> AdamState:
    """The inverse of `adam_to_numpy`, on `device` (None: the card)."""
    dev = resolve_device(device)

    def tree(name):
        return params_from_numpy(
            {f: flat[f"adam.{name}.{f}"] for f in FIELDS}, device=dev)

    return AdamState(mu=tree("mu"), nu=tree("nu"),
                     count={f: int(flat[f"adam.count.{f}"]) for f in FIELDS},
                     accum=tree("accum"))


@dataclasses.dataclass
class CamOptState:
    """Camera-pose optimizer state: SO3xR3 tangents and their Adam.
    `cam_opt_update` changes it in place, like `adam_step` its state."""

    adj: torch.Tensor  # (n_cams, 6) SE(3) tangents
    accum: torch.Tensor  # (n_cams, 6) gradients summed since the last update
    mu: torch.Tensor  # (n_cams, 6) Adam first moments
    nu: torch.Tensor  # (n_cams, 6) Adam second moments
    count: int  # applied updates (bias correction)


CAM_OPT_FIELDS = tuple(f.name for f in dataclasses.fields(CamOptState))


def init_cam_opt(n_cams: int, device=None) -> CamOptState:
    dev = resolve_device(device)
    return CamOptState(
        **{f: torch.zeros((max(n_cams, 1), 6), device=dev)
           for f in CAM_OPT_FIELDS[:-1]}, count=0)


def cam_opt_update(cfg: OptimConfig, state: CamOptState, cam_i,
                   gadj: torch.Tensor, step: int) -> None:
    """Add this step's pose gradient (6,) to camera `cam_i`'s accumulator
    (or, with an index tensor (k,), the gradients (k, 6) to their cameras,
    a repeated index adding up) and, on every `accum_camera_opt`-th step,
    apply one Adam update over all cameras at the learning rate decaying
    exponentially from `lr_camera_opt` to `lr_camera_opt_final` over
    `max_steps`. Plain Adam on the summed gradients; rows without gradients
    still decay their moments, as one optimizer over the stacked tangents
    does."""
    if torch.is_tensor(cam_i):
        state.accum.index_add_(0, cam_i.to(state.accum.device),
                               gadj.reshape(-1, 6))
    else:
        state.accum[cam_i] += gadj
    if (step + 1) % cfg.accum_camera_opt != 0:
        return
    acc = state.accum
    state.count += 1
    state.mu = cfg.b1 * state.mu + (1.0 - cfg.b1) * acc
    state.nu = cfg.b2 * state.nu + (1.0 - cfg.b2) * acc * acc
    # bias corrections in float32, as the JAX package computes them
    c = np.float32(state.count)
    mhat = state.mu / float(np.float32(1.0) - np.float32(cfg.b1) ** c)
    vhat = state.nu / float(np.float32(1.0) - np.float32(cfg.b2) ** c)
    frac = min(max(step / cfg.max_steps, 0.0), 1.0)
    lr = cfg.lr_camera_opt * (
        cfg.lr_camera_opt_final / cfg.lr_camera_opt) ** frac
    state.adj = state.adj - lr * mhat / (torch.sqrt(vhat) + cfg.eps)
    state.accum = torch.zeros_like(acc)


def cam_opt_to_numpy(state: CamOptState) -> Dict[str, np.ndarray]:
    """Checkpoint keys `cam_opt.<field>` and the alias `cam_adj`."""
    flat = {f"cam_opt.{f}": getattr(state, f).cpu().numpy()
            for f in CAM_OPT_FIELDS[:-1]}
    flat["cam_opt.count"] = np.asarray(state.count, np.int32)
    flat["cam_adj"] = flat["cam_opt.adj"]
    return flat


def cam_opt_from_numpy(flat: Mapping[str, np.ndarray], device=None
                       ) -> CamOptState:
    dev = resolve_device(device)
    return CamOptState(
        **{f: torch.as_tensor(np.asarray(flat[f"cam_opt.{f}"], np.float32),
                              device=dev) for f in CAM_OPT_FIELDS[:-1]},
        count=int(flat["cam_opt.count"]))
