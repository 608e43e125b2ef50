"""CLI-trainable baseline methods: gnerfacto / gdepthfacto / gneusfacto
(counterpart of dnsplatter_tpu/baselines/runner.py).

`python -m dnsplatter_torch.cli train gnerfacto <dataparser> --data ...`
trains the corresponding baseline with the reference's optimizer presets
(Adam; lr 1e-2 for the nerfacto variants, 5e-3 for gneusfacto), serving
frames in sequence and sampling random pixel rays each step.

Checkpoints are the JAX package's: `baseline_<method>.npz` holds the
parameters as `leaf_{j}` in `jax.tree.flatten` order (the NamedTuple's
fields in order, each MLP's keys sorted: `b0 b1 .. w0 w1 ..`), beside
`baseline_<method>_history.json`, so either package reads the other's.
`params_from_jax` and `leaves_like_jax` convert between that order and the
port's modules.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from dnsplatter_torch import resolve_device
from dnsplatter_torch.baselines import fields as F
from dnsplatter_torch.baselines import nerfacto, neusfacto
from dnsplatter_torch.ops.camera import Camera

# method -> reference-preset base learning rate (the reference's
# eval_configs.py: gnerfacto / gdepthfacto fields lr 1e-2; gneusfacto 5e-3
# on the compact hash field)
BASELINE_METHODS: Dict[str, float] = {
    "gnerfacto": 1e-2,
    "gdepthfacto": 1e-2,
    "gneusfacto": 5e-3,
}
# The JAX NamedTuples' fields, in order.
JAX_FIELDS = {
    nerfacto.NerfactoParams: ("tables", "density_mlp", "color_mlp"),
    neusfacto.NeuSParams: ("tables", "sdf_mlp", "color_mlp", "inv_s"),
}

Config = Union[nerfacto.NerfactoConfig, neusfacto.NeuSConfig]


def method_config(method: str) -> Config:
    if method not in BASELINE_METHODS:
        raise ValueError(f"unknown baseline method {method!r}; "
                         f"choices: {sorted(BASELINE_METHODS)}")
    if method == "gneusfacto":
        return neusfacto.NeuSConfig()
    return nerfacto.NerfactoConfig(use_depth_loss=method == "gdepthfacto")


def _new_params(cfg: Config, generator=None, device=None) -> nn.Module:
    if isinstance(cfg, neusfacto.NeuSConfig):
        return neusfacto.NeuSParams(cfg, generator, device)
    return nerfacto.NerfactoParams(cfg, generator, device)


def leaves_like_jax(params: nn.Module) -> List[torch.Tensor]:
    """The module's parameters in `jax.tree.flatten` order of the JAX
    package's NamedTuple."""
    out = []
    for name in JAX_FIELDS[type(params)]:
        v = getattr(params, name)
        if isinstance(v, F.MLP):
            out += [getattr(v, k) for k in sorted(dict(v.named_parameters()))]
        else:
            out.append(v)
    return out


def _flatten_jax(src) -> list:
    """Leaves of a JAX NamedTuple of arrays and dicts (its `_fields` in
    order, dict keys sorted), or the sequence as given."""
    if not hasattr(src, "_fields"):
        return list(src)
    out = []
    for name in src._fields:
        v = getattr(src, name)
        out += [v[k] for k in sorted(v)] if isinstance(v, dict) else [v]
    return out


def params_from_jax(src, cfg: Config, device=None) -> nn.Module:
    """The port's parameter module for `cfg` holding the JAX package's
    parameters: a NamedTuple of arrays, or its leaves in flatten order
    (numpy or JAX arrays; an npz's `leaf_{j}` in order)."""
    params = _new_params(cfg, device=resolve_device(device))
    leaves = _flatten_jax(src)
    dest = leaves_like_jax(params)
    if len(leaves) != len(dest):
        raise ValueError(f"{len(leaves)} leaves for a module of {len(dest)}")
    with torch.no_grad():
        for d, s in zip(dest, leaves):
            a = np.asarray(s, np.float32)
            if a.shape != tuple(d.shape):
                raise ValueError(f"leaf of shape {a.shape}, expected "
                                 f"{tuple(d.shape)}")
            d.copy_(torch.from_numpy(a))
    return params


def load_baseline(path: Path, method: str, device=None) -> nn.Module:
    """A `baseline_<method>.npz` of either package as the port's module."""
    with np.load(path) as z:
        leaves = [z[f"leaf_{j}"] for j in range(len(z.files))]
    return params_from_jax(leaves, method_config(method), device)


def _device_frame(data, i: int, device: torch.device):
    cam, batch = data.get(i)
    if cam.device != device:
        cam = Camera.create(cam.fx.item(), cam.fy.item(), cam.cx.item(),
                            cam.cy.item(), cam.c2w.cpu().numpy(), cam.width,
                            cam.height, device=device)

    return cam, *(torch.as_tensor(batch[k], dtype=torch.float32,
                                  device=device) if k in batch else None
                  for k in ("image", "sensor_depth", "normal"))


def train_baseline(
    method: str,
    data,
    num_steps: int = 30000,
    out_dir: Optional[Path] = None,
    seed: int = 42,
    lr: Optional[float] = None,
    log_every: int = 100,
    device=None,
):
    """Train one baseline method on a scene source (`len(data)` frames,
    `data.get(i) -> (Camera, batch)`). Returns (params, history). The
    initial weights come from a CPU generator seeded with `seed` (the same
    on every device), the step's draws from one on `device`. Frames are
    cached on the device after their first upload."""
    cfg = method_config(method)
    dev = resolve_device(device)
    lr = lr if lr is not None else BASELINE_METHODS[method]
    init_gen = torch.Generator(device="cpu")
    init_gen.manual_seed(seed)
    params = _new_params(cfg, init_gen, dev)
    draw_gen = torch.Generator(device=dev)
    draw_gen.manual_seed(seed + 1)
    is_neus = method == "gneusfacto"
    mod = neusfacto if is_neus else nerfacto
    step, make_opt = mod.make_train_step(cfg, lr=lr)
    opt = make_opt(params)

    n = len(data)
    history = []
    t0 = time.time()
    cache: Dict[int, tuple] = {}
    for i in range(num_steps):
        fi = i % n
        if fi not in cache:
            cache[fi] = _device_frame(data, fi, dev)
        cam, img, dep, nrm = cache[fi]
        if is_neus:
            loss = step(params, opt, cam, img, dep, nrm, draw_gen)
        else:
            loss = step(params, opt, cam, img, dep, draw_gen)
        if (i + 1) % log_every == 0 or i + 1 == num_steps:
            row = dict(step=i + 1, loss=float(loss),
                       wall_s=round(time.time() - t0, 2))
            history.append(row)
            print(f"[{method}] step {i + 1:6d}  loss {row['loss']:.4f}  "
                  f"{row['wall_s']:.1f}s", flush=True)

    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        np.savez(out_dir / f"baseline_{method}.npz", **{
            f"leaf_{j}": x.detach().cpu().numpy()
            for j, x in enumerate(leaves_like_jax(params))})
        (out_dir / f"baseline_{method}_history.json").write_text(
            json.dumps(history))
        print(f"checkpoint: {out_dir / f'baseline_{method}.npz'}", flush=True)
    return params, history

