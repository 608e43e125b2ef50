"""tf_efficientnet_b5_ap feature encoder as an nn.Module (counterpart of
dnsplatter_tpu/priors/efficientnet.py):

  stem conv3x3/s2 (48) -> 7 MBConv stages
  [ds k3 s1 24 x3, ir k3 s2 40 x5, ir k5 s2 64 x5, ir k3 s2 128 x7,
   ir k5 s1 176 x7, ir k5 s2 304 x9, ir k3 s1 512 x3] -> conv_head 1x1 (2048)

with TF-"SAME" (asymmetric, input-size dependent) padding, BatchNorm eps
1e-3 in inference form, SiLU, and squeeze-excitation reduced to
int(0.25 * block input channels). The state-dict keys are geffnet's (the
JAX package's parameter keys without the `encoder.original_model.` prefix
that DSINE adds). The forward returns the five taps DSINE consumes, NCHW:
block0 (24, /2), block1 (40, /4), block2 (64, /8), block4 (176, /16),
conv_head (2048, /32).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dnsplatter_torch.priors.common import pad_same

# (block_type, kernel, stride, expand_ratio, out_ch, repeats) per stage.
B5_STAGES: Tuple[Tuple[str, int, int, int, int, int], ...] = (
    ("ds", 3, 1, 1, 24, 3),
    ("ir", 3, 2, 6, 40, 5),
    ("ir", 5, 2, 6, 64, 5),
    ("ir", 3, 2, 6, 128, 7),
    ("ir", 5, 1, 6, 176, 7),
    ("ir", 5, 2, 6, 304, 9),
    ("ir", 3, 1, 6, 512, 3),
)
B5_STEM = 48
B5_HEAD = 2048
BN_EPS = 1e-3  # tf_ variants
SE_RATIO = 0.25


class Conv2dSame(nn.Conv2d):
    """nn.Conv2d with TF-SAME zero padding set by the input's size."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pad_same(x, self.kernel_size[0], self.stride[0])
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, 1,
                        self.groups)


class FrozenBatchNorm(nn.Module):
    """BatchNorm in inference form: x * g / sqrt(var + eps) + (b - mean * g
    / sqrt(var + eps)), with geffnet's state-dict keys."""

    def __init__(self, channels: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


class SqueezeExcite(nn.Module):
    """Global mean -> reduce 1x1 -> SiLU -> expand 1x1 -> sigmoid gate."""

    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(channels, reduced, 1)
        self.conv_expand = nn.Conv2d(reduced, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.conv_expand(F.silu(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


class DepthwiseSeparable(nn.Module):
    """Stage 0: dw -> bn -> SiLU -> SE -> pw -> bn (+ residual)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.skip = stride == 1 and cin == cout
        self.conv_dw = Conv2dSame(cin, cin, k, stride, groups=cin, bias=False)
        self.bn1 = FrozenBatchNorm(cin)
        self.se = SqueezeExcite(cin, max(1, int(cin * SE_RATIO)))
        self.conv_pw = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn2 = FrozenBatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.se(F.silu(self.bn1(self.conv_dw(x))))
        h = self.bn2(self.conv_pw(h))
        return h + x if self.skip else h


class InvertedResidual(nn.Module):
    """pw-expand -> dw -> SE -> pw-linear (+ residual)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 expand: int):
        super().__init__()
        cexp = cin * expand
        self.skip = stride == 1 and cin == cout
        self.conv_pw = nn.Conv2d(cin, cexp, 1, bias=False)
        self.bn1 = FrozenBatchNorm(cexp)
        self.conv_dw = Conv2dSame(cexp, cexp, k, stride, groups=cexp,
                                  bias=False)
        self.bn2 = FrozenBatchNorm(cexp)
        self.se = SqueezeExcite(cexp, max(1, int(cin * SE_RATIO)))
        self.conv_pwl = nn.Conv2d(cexp, cout, 1, bias=False)
        self.bn3 = FrozenBatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.bn1(self.conv_pw(x)))
        h = F.silu(self.bn2(self.conv_dw(h)))
        h = self.bn3(self.conv_pwl(self.se(h)))
        return h + x if self.skip else h


class EfficientNetB5(nn.Module):
    """The B5 feature extractor; `forward` returns the five DSINE taps."""

    def __init__(self):
        super().__init__()
        self.conv_stem = Conv2dSame(3, B5_STEM, 3, 2, bias=False)
        self.bn1 = FrozenBatchNorm(B5_STEM)
        cin = B5_STEM
        stages = []
        for btype, k, s, e, cout, reps in B5_STAGES:
            blocks = []
            for bi in range(reps):
                stride = s if bi == 0 else 1
                blocks.append(DepthwiseSeparable(cin, cout, k, stride)
                              if btype == "ds" else
                              InvertedResidual(cin, cout, k, stride, e))
                cin = cout
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        self.conv_head = nn.Conv2d(cin, B5_HEAD, 1, bias=False)

    def forward(self, img: torch.Tensor) -> List[torch.Tensor]:
        x = F.silu(self.bn1(self.conv_stem(img)))
        taps = []
        for stage in self.blocks:
            x = stage(x)
            taps.append(x)
        return [taps[0], taps[1], taps[2], taps[4], self.conv_head(taps[6])]


def b5_param_shapes(prefix: str = "encoder.original_model."
                    ) -> Dict[str, Tuple[int, ...]]:
    """Expected state-dict tensor shapes of the B5 feature extractor (the
    JAX package's `b5_param_shapes`, written out independently of the
    module so that the two can be held against each other)."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def bn(name, c):
        for suf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{suf}"] = (c,)

    shapes["conv_stem.weight"] = (B5_STEM, 3, 3, 3)
    bn("bn1", B5_STEM)
    cin = B5_STEM
    for si, (btype, k, _, e, cout, reps) in enumerate(B5_STAGES):
        for bi in range(reps):
            name = f"blocks.{si}.{bi}"
            red = max(1, int(cin * SE_RATIO))
            cmid = cin if btype == "ds" else cin * e
            if btype == "ir":
                shapes[f"{name}.conv_pw.weight"] = (cmid, cin, 1, 1)
                bn(f"{name}.bn1", cmid)
            shapes[f"{name}.conv_dw.weight"] = (cmid, 1, k, k)
            bn(f"{name}.bn1" if btype == "ds" else f"{name}.bn2", cmid)
            shapes[f"{name}.se.conv_reduce.weight"] = (red, cmid, 1, 1)
            shapes[f"{name}.se.conv_reduce.bias"] = (red,)
            shapes[f"{name}.se.conv_expand.weight"] = (cmid, red, 1, 1)
            shapes[f"{name}.se.conv_expand.bias"] = (cmid,)
            last = "conv_pw" if btype == "ds" else "conv_pwl"
            shapes[f"{name}.{last}.weight"] = (cout, cmid, 1, 1)
            bn(f"{name}.bn2" if btype == "ds" else f"{name}.bn3", cout)
            cin = cout
    shapes["conv_head.weight"] = (B5_HEAD, cin, 1, 1)
    return {prefix + k: v for k, v in shapes.items()}


def encoder_features(model: nn.Module, img_nchw: torch.Tensor
                     ) -> List[torch.Tensor]:
    """[block0, block1, block2, block4, conv_head] of a normalized (B, 3, H,
    W) image; `model` is an EfficientNetB5 or a module holding one as
    `encoder.original_model` (DSINE)."""
    if not isinstance(model, EfficientNetB5):
        model = model.encoder.original_model
    return model(img_nchw)
