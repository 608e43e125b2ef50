"""Neural fields: multiresolution hash encoding and MLP heads (counterpart
of dnsplatter_tpu/baselines/fields.py).

Hash tables are plain learnable (L, T, F) tensors; trilinear interpolation
is one gather of the eight corners a level and a weighted sum. The corners'
hashes and weights are products of two values an axis, so they are formed
a level from six hash terms and six weights by broadcasting. MLP weights
are `(in, out)` parameters keyed `w{i}` / `b{i}` as in the JAX package, used
as `h @ w + b`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
from torch import nn

from dnsplatter_torch.ops.sh import sh_basis

# The JAX package hashes in uint32 (PRIMES there is uint32). Torch has no
# full uint32 arithmetic, so the hash runs in int64: the low 32 bits of each
# product are the uint32 product, XOR is bitwise, and T divides 2^32, so
# `h & (T - 1)` is the uint32 hash modulo T exactly.
PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 12
    features_per_level: int = 2
    log2_table_size: int = 17
    base_res: int = 16
    max_res: int = 1024


def level_resolutions(cfg: HashGridConfig) -> list:
    """Each level's grid resolution, as the JAX package computes it (Python
    float64, truncated)."""
    growth = (
        math.exp((math.log(cfg.max_res) - math.log(cfg.base_res))
                 / max(cfg.n_levels - 1, 1))
        if cfg.n_levels > 1 else 1.0)
    return [int(cfg.base_res * growth**lvl) for lvl in range(cfg.n_levels)]


def init_hash_grid(generator: torch.Generator, cfg: HashGridConfig,
                   device=None) -> torch.Tensor:
    """(L, T, F) tables, uniform in [-1e-4, 1e-4)."""
    t = 1 << cfg.log2_table_size
    u = torch.rand((cfg.n_levels, t, cfg.features_per_level),
                   generator=generator, device=generator.device)
    return (u * 2e-4 - 1e-4).to(device or generator.device)


def hash_encode(tables: torch.Tensor, x: torch.Tensor,
                cfg: HashGridConfig) -> torch.Tensor:
    """x: (..., 3) in [0, 1] -> (..., L*F) features."""
    t = 1 << cfg.log2_table_size
    lead = x.shape[:-1]
    outs = []
    for lvl, res in enumerate(level_resolutions(cfg)):
        xs = x * res
        x0 = torch.floor(xs)
        frac = xs - x0
        c0 = x0.to(torch.int64)
        # per axis, the hash terms and weights of the cell's two corner
        # planes; corner k = bx + 2 by + 4 bz, so z, y, x index (..., 2, 2, 2)
        h = [torch.stack([c0[..., a] * p, (c0[..., a] + 1) * p], -1)
             for a, p in enumerate(PRIMES)]
        w = [torch.stack([1.0 - frac[..., a], frac[..., a]], -1)
             for a in range(3)]
        idx = ((h[0][..., None, None, :] ^ h[1][..., None, :, None]
                ^ h[2][..., :, None, None]) & (t - 1)).reshape(lead + (8,))
        wc = (w[0][..., None, None, :] * w[1][..., None, :, None]
              * w[2][..., :, None, None]).reshape(lead + (8,))
        feats = tables[lvl].index_select(0, idx.reshape(-1)).reshape(
            idx.shape + (tables.shape[-1],))
        outs.append(torch.sum(wc[..., None] * feats, dim=-2))
    return torch.cat(outs, dim=-1)


class MLP(nn.Module):
    """Weights `w{i}` (in, out) and biases `b{i}` (out,), the JAX package's
    parameter dict; ReLU between layers."""

    def __init__(self, sizes: Sequence[int], generator: Optional[
            torch.Generator] = None, device=None):
        super().__init__()
        self.n = len(sizes) - 1
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            if generator is not None:
                w = torch.randn((a, b), generator=generator,
                                device=generator.device) * math.sqrt(2.0 / a)
            else:
                w = torch.zeros((a, b))
            self.register_parameter(f"w{i}", nn.Parameter(w.to(device)))
            self.register_parameter(
                f"b{i}", nn.Parameter(torch.zeros((b,), device=device)))

    def forward(self, x: torch.Tensor, final_activation=None) -> torch.Tensor:
        h = x
        for i in range(self.n):
            h = h @ getattr(self, f"w{i}") + getattr(self, f"b{i}")
            if i < self.n - 1:
                h = torch.relu(h)
        return final_activation(h) if final_activation else h


def mlp(params: MLP, x: torch.Tensor, final_activation=None) -> torch.Tensor:
    return params(x, final_activation)


def init_mlp(generator: Optional[torch.Generator], sizes,
             device=None) -> MLP:
    """He-normal weights from `generator` (zeros without one), zero
    biases."""
    return MLP(sizes, generator, device)


def sh_dir_encode(dirs: torch.Tensor) -> torch.Tensor:
    """Degree-2 SH direction encoding (9 features)."""
    d = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                           min=1e-8)
    return sh_basis(2, d)


def jmax(x: torch.Tensor, v: float) -> torch.Tensor:
    """`jnp.maximum(x, v)` with its gradient: half at a tie, where
    `torch.clamp` passes all of it."""
    return torch.maximum(x, torch.full((), v, dtype=x.dtype, device=x.device))


def jclip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip(x, lo, hi)` with its gradient (half at either bound)."""
    return torch.minimum(jmax(x, lo),
                         torch.full((), hi, dtype=x.dtype, device=x.device))
