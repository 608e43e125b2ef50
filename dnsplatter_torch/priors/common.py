"""What the prior networks share: TF-SAME padding, the resizes of the JAX
package's graphs, seeded weights, npz / checkpoint loading, and the float32
policy of their forwards.

Precision: the networks compute in float32, as the JAX package does. Their
forwards run inside `strict_fp32()`, which turns TF32 off for cuDNN's
convolutions for the length of the call and restores the caller's setting
after it; products follow the process's matmul precision, which PyTorch
leaves at full float32 unless a caller changes it. No global flag is left
changed.
"""

from __future__ import annotations

import contextlib
import math
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dnsplatter_torch import resolve_device


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF-SAME asymmetric padding (before, after) of one spatial dim."""
    pad = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return pad // 2, pad - pad // 2


def pad_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Zero-pad NCHW `x` for a TF-SAME window of size k and stride s."""
    pt, pb = same_pads(x.shape[2], k, s)
    pl, pr = same_pads(x.shape[3], k, s)
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb))
    return x


def resize_linear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """`jax.image.resize(..., "linear")` of NCHW `x`: half-pixel bilinear,
    antialiased (a triangle widened by the scale) along a dim that shrinks,
    the same weights as plain bilinear along one that grows."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[2:]) == size:
        return x
    shrink = size[0] < x.shape[2] or size[1] < x.shape[3]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=shrink)


def resize_align_corners(x: torch.Tensor, size: Tuple[int, int]
                         ) -> torch.Tensor:
    """Bilinear resize of NCHW `x` with align_corners=True."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=True)


@contextlib.contextmanager
def strict_fp32():
    """cuDNN convolutions in full float32 (no TF32) for the length of the
    block; the caller's flags are restored after it."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


@contextlib.contextmanager
def without_cudnn():
    """PyTorch's own CUDA convolution (im2col + cuBLAS) in place of cuDNN's
    for the length of the block; the caller's flags are restored after it.
    For the one float32 shape whose cuDNN algorithm choice is pathological
    (see dpt.DPTHybrid.head_forward)."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=False, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def init_random_(module: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> nn.Module:
    """Seeded weights in place: products and convolutions N(0, std) (the
    initializer range of the published configurations), biases 0, norm
    scales and running variances 1, running means 0, layer scales 0.1."""
    with torch.no_grad():
        for name, t in module.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if not t.is_floating_point():
                continue
            if leaf in ("bias", "running_mean"):
                t.zero_()
            elif leaf in ("lambda_1", "lambda_2"):
                t.fill_(0.1)
            elif leaf == "running_var" or t.ndim == 1:
                t.fill_(1.0)
            else:
                t.copy_(torch.randn(t.shape, generator=generator,
                                    device=t.device) * std)
    return module


def random_arrays(module: nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """Random float32 arrays for every key of `module.state_dict()`, drawn
    by numpy from `seed` (the parity tests' weights), scaled so that
    activations stay of order one: products and convolutions N(0,
    1 / fan_in), biases N(0, 0.1^2), norm scales 1 + N(0, 0.1^2), running
    means N(0, 0.1^2) and variances U(0.5, 1.5), layer scales 1 + N(0,
    0.02^2), tokens, position tables and biases N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in module.state_dict().items():
        shape = tuple(t.shape)
        leaf = name.rsplit(".", 1)[-1]
        z = rng.standard_normal(shape)
        if leaf == "running_var":
            a = rng.uniform(0.5, 1.5, shape)
        elif leaf in ("lambda_1", "lambda_2"):
            a = 1.0 + z * 0.02
        elif leaf in ("cls_token", "position_embeddings",
                      "relative_position_bias_table"):
            a = z * 0.5
        elif leaf in ("bias", "running_mean"):
            a = z * 0.1
        elif len(shape) == 1:
            a = 1.0 + z * 0.1
        else:
            a = z / np.sqrt(np.prod(shape[1:]))
        out[name] = a.astype(np.float32)
    return out


def params_from_numpy(module: nn.Module, arrays) -> nn.Module:
    """Load a flat {key: array} dict in the JAX package's format into
    `module`, strictly: a key that either side lacks raises."""
    dev = next(module.parameters()).device
    state = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                device=dev) for k, v in arrays.items()}
    module.load_state_dict(state, strict=True)
    return module


def state_arrays(module: nn.Module) -> Dict[str, np.ndarray]:
    """The module's persistent state as float32 numpy arrays (the JAX
    package's parameter dict)."""
    return {k: v.detach().cpu().numpy().astype(np.float32)
            for k, v in module.state_dict().items()}


def load_weights(path, convert_fn, convert_flag: str, checkpoint: str
                 ) -> Dict[str, np.ndarray]:
    """The arrays of a converted `.npz`, or of a published torch checkpoint
    (`.ckpt` / `.pt`) converted in-process by `convert_fn`. A missing file
    exits and names the convert command."""
    path = Path(path)
    if not path.exists():
        flag = f" {convert_flag}" if convert_flag else ""
        raise SystemExit(
            f"prior weights not found at {path}. Convert the published "
            f"checkpoint once with: python -m dnsplatter_torch.priors.convert"
            f"{flag} {checkpoint} weights.npz (or pass the checkpoint "
            "itself)")
    if path.suffix == ".npz":
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    return convert_fn(path)


def build(module: nn.Module, device=None, seed=None, arrays=None
          ) -> nn.Module:
    """`module` in eval mode on `device` (None: the card), with `arrays`
    loaded or, else, the seeded weights of `init_random_`, drawn there by a
    generator of that device."""
    dev = resolve_device(device)
    module = module.to(dev).eval()
    if arrays is not None:
        params_from_numpy(module, arrays)
    elif seed is not None:
        init_random_(module, torch.Generator(dev).manual_seed(seed))
    return module
