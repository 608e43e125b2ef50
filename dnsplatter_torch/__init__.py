"""dnsplatter_torch: the PyTorch + CUDA port of dnsplatter_tpu.

The JAX package beside this one is the reference; every module here keeps
its counterpart's name and public layouts ((H, W, C) images, wxyz
quaternions, OpenGL c2w), so tests can feed both the same inputs. This
package never imports JAX or dnsplatter_tpu.

Entry points take `device=None`, which means "cuda". They run on the CPU
only when a caller passes `device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card; anything else is taken as given."""
    return torch.device("cuda" if device is None else device)
