"""Checkpoint loading (counterpart of `load_checkpoint_arrays` in
dnsplatter_tpu/train/trainer.py). The Trainer comes with the training
slice.

The JAX package writes checkpoints as npz files holding `params.<field>`
for the seven Gaussian fields, `alive` and `step` (plus optimizer state,
which serving ignores). Reading them with numpy is how a scene trained by
the JAX package is served by the port.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from dnsplatter_torch import resolve_device
from dnsplatter_torch.models.gaussians import (
    FIELDS,
    GaussianParams,
    params_from_numpy,
)


def load_checkpoint_arrays(path: Path, device=None
                           ) -> Tuple[GaussianParams, torch.Tensor, int]:
    """(params, alive, step) from a JAX-format npz, on `device` (None:
    the card)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        params = params_from_numpy({f: z[f"params.{f}"] for f in FIELDS},
                                   device=dev)
        alive = torch.as_tensor(np.asarray(z["alive"], np.float32),
                                device=dev)
        step = int(z["step"])
    return params, alive, step
