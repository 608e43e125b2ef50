"""Gaussian parameter state (counterpart of
dnsplatter_tpu/models/gaussians.py): fixed-capacity tensors plus an
`alive` mask kept beside them."""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from dnsplatter_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class GaussianParams:
    """Gaussian state, leading dim = capacity C."""

    means: torch.Tensor  # (C, 3)
    scales: torch.Tensor  # (C, 3) log-scales
    quats: torch.Tensor  # (C, 4) wxyz
    features_dc: torch.Tensor  # (C, 3) SH degree-0 coefficients
    features_rest: torch.Tensor  # (C, B-1, 3) higher SH coefficients
    opacities: torch.Tensor  # (C,) logits
    normals: torch.Tensor  # (C, 3) trainable normal parameter

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def sh_bases(self) -> int:
        return self.features_rest.shape[1] + 1

    @property
    def sh_degree(self) -> int:
        """Degree implied by the stored bases: B = (deg+1)^2."""
        return int(round(self.sh_bases ** 0.5)) - 1

    def sh_coeffs(self) -> torch.Tensor:
        """(C, B, 3) concatenated SH coefficients."""
        return torch.cat([self.features_dc[:, None, :], self.features_rest],
                         dim=1)


FIELDS = tuple(f.name for f in dataclasses.fields(GaussianParams))


def params_from_numpy(arrays: Mapping[str, np.ndarray],
                      device=None) -> GaussianParams:
    """The JAX package's parameters, as numpy arrays keyed by field name,
    as the port's float32 parameters on `device` (None: the card)."""
    dev = resolve_device(device)
    missing = [f for f in FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"missing Gaussian fields: {missing}")
    return GaussianParams(**{
        f: torch.as_tensor(np.asarray(arrays[f], np.float32), device=dev)
        for f in FIELDS
    })
