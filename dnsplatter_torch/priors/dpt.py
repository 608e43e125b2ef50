"""DPT-Hybrid (ViT-B/16 + BiT-R50 stem), Omnidata's monocular normal
network, as an nn.Module (counterpart of dnsplatter_tpu/priors/dpt.py):

  BiT-ResNet50v2 stem (weight-standardized convs, GroupNorm-32,
  TF-SAME dynamic padding, depths 3/4/9, non-preact bottlenecks)
    -> stage1 (256, /4) and stage2 (512, /8) feed the neck directly
    -> stage3 (1024, /16) is patch-embedded (1x1 conv) into ViT-B/16
  12 ViT layers; hidden states after layers 8 and 11 join the neck
  DPT neck: readout-projected reassembly + 4 RefineNet fusion blocks
  head: conv 3x3 -> 2x bilinear (align_corners) -> conv 3x3 -> ReLU
        -> conv 1x1 (out_channels) -> ReLU

NCHW inside; the state-dict keys are the HF-transformers DPT names the JAX
package reads (priors/convert.py maps the published omnidata / MiDaS
checkpoint names onto them). `dpt.layernorm` is kept, unused, because the
published checkpoints and HF's module carry it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dnsplatter_torch.priors.common import (
    build,
    load_weights,
    pad_same,
    resize_linear,
    strict_fp32,
    without_cudnn,
)

GN_EPS = 1e-5  # torch nn.GroupNorm default (BitGroupNormActivation)
WS_EPS = 1e-8  # WeightStandardizedConv2d eps
LN_EPS = 1e-12  # DPTConfig layer_norm_eps default


@dataclasses.dataclass(frozen=True)
class DPTHybridConfig:
    """vitb_rn50_384 defaults (the omnidata normal model)."""

    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    patch_size: int = 16
    bit_embedding: int = 64
    bit_depths: Tuple[int, ...] = (3, 4, 9)
    bit_hidden: Tuple[int, ...] = (256, 512, 1024)
    num_groups: int = 32
    neck_hidden: Tuple[int, ...] = (256, 512, 768, 768)
    reassemble_factors: Tuple[float, ...] = (1.0, 1.0, 1.0, 0.5)
    fusion_hidden: int = 256
    readout_layers: Tuple[int, ...] = (8, 11)  # post-layer indices
    out_channels: int = 1  # omnidata normals: 3
    pos_grid: int = 24  # position-embedding grid (384 / 16)


# The narrow configuration of the parity tests and of the card-vs-CPU check
# (the JAX package's tests/test_dpt.py shapes).
SMALL_CONFIG = DPTHybridConfig(
    hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
    bit_embedding=4, bit_depths=(1, 1, 2), bit_hidden=(8, 16, 32),
    num_groups=2, neck_hidden=(8, 16, 16, 16),
    reassemble_factors=(1.0, 1.0, 1.0, 0.5), fusion_hidden=12,
    readout_layers=(0, 1), pos_grid=6)


# --------------------------------------------------------------------------
# shared layers (ZoeDepth's neck and heads use them too)
# --------------------------------------------------------------------------


def upsample2_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear growth with align_corners=True."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


class SelfAttention(nn.Module):
    """query / key / value products and scaled dot-product attention, with
    an optional additive bias (B or 1, heads, T, T)."""

    def __init__(self, hidden: int, heads: int, key_bias: bool = True):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden, bias=key_bias)
        self.value = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, t, c = x.shape

        def split(y):
            return y.reshape(b, t, self.heads, c // self.heads).transpose(1, 2)

        ctx = F.scaled_dot_product_attention(
            split(self.query(x)), split(self.key(x)), split(self.value(x)),
            attn_mask=bias)
        return ctx.transpose(1, 2).reshape(b, t, c)


class _Dense(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.dense = nn.Linear(cin, cout)


class _Attention(nn.Module):
    def __init__(self, hidden: int, heads: int, key_bias: bool = True):
        super().__init__()
        self.attention = SelfAttention(hidden, heads, key_bias)
        self.output = _Dense(hidden, hidden)


class ViTLayer(nn.Module):
    """Pre-norm transformer layer with HF's key names; `layer_scale` adds
    BEiT's lambda_1 / lambda_2."""

    def __init__(self, hidden: int, heads: int, intermediate: int,
                 key_bias: bool = True, layer_scale: bool = False):
        super().__init__()
        self.attention = _Attention(hidden, heads, key_bias)
        self.intermediate = _Dense(hidden, intermediate)
        self.output = _Dense(intermediate, hidden)
        self.layernorm_before = nn.LayerNorm(hidden, eps=LN_EPS)
        self.layernorm_after = nn.LayerNorm(hidden, eps=LN_EPS)
        if layer_scale:
            self.lambda_1 = nn.Parameter(torch.ones(hidden))
            self.lambda_2 = nn.Parameter(torch.ones(hidden))
        self.layer_scale = layer_scale

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        ctx = self.attention.output.dense(
            self.attention.attention(self.layernorm_before(x), bias))
        x = x + (self.lambda_1 * ctx if self.layer_scale else ctx)
        h = F.gelu(self.intermediate.dense(self.layernorm_after(x)))
        h = self.output.dense(h)
        return x + (self.lambda_2 * h if self.layer_scale else h)


class ReassembleLayer(nn.Module):
    """1x1 projection to the stage's width, then the resize of its factor:
    a transposed conv (k = stride = factor) up, a strided 3x3 conv down."""

    def __init__(self, hidden: int, channels: int, factor: float):
        super().__init__()
        self.factor = factor
        self.projection = nn.Conv2d(hidden, channels, 1)
        if factor > 1:
            self.resize = nn.ConvTranspose2d(channels, channels, int(factor),
                                             stride=int(factor))
        elif factor == 0.5:
            self.resize = nn.Conv2d(channels, channels, 3, stride=2,
                                    padding=1)
        elif factor == 1.0:
            self.resize = nn.Identity()
        else:
            raise NotImplementedError(f"reassemble factor {factor}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resize(self.projection(x))


class ReassembleStage(nn.Module):
    """Tokens -> feature maps with the "project" readout: the class token
    joins each patch token, a Linear + GELU maps them back to the hidden
    width. Stages listed in `identity` carry no parameters (the hybrid's
    first two, which take the BiT features instead)."""

    def __init__(self, hidden: int, channels, factors, identity=()):
        super().__init__()
        self.readout_projects = nn.ModuleList(
            nn.Sequential(nn.Identity()) if i in identity else
            nn.Sequential(nn.Linear(2 * hidden, hidden), nn.GELU())
            for i in range(len(channels)))
        self.layers = nn.ModuleList(
            nn.Identity() if i in identity else
            ReassembleLayer(hidden, channels[i], factors[i])
            for i in range(len(channels)))

    def forward(self, tokens: torch.Tensor, idx: int, gh: int, gw: int
                ) -> torch.Tensor:
        cls, rest = tokens[:, :1], tokens[:, 1:]
        h = torch.cat([rest, cls.expand_as(rest)], dim=-1)
        h = self.readout_projects[idx](h)
        h = h.reshape(h.shape[0], gh, gw, -1).permute(0, 3, 1, 2)
        return self.layers[idx](h)


class ResidualUnit(nn.Module):
    """relu -> conv3x3 -> relu -> conv3x3, plus the input."""

    def __init__(self, c: int):
        super().__init__()
        self.convolution1 = nn.Conv2d(c, c, 3, padding=1)
        self.convolution2 = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.convolution2(F.relu(self.convolution1(F.relu(x))))
        return h + x


class FusionLayer(nn.Module):
    """RefineNet fusion: residual unit on the skip, residual unit, 2x
    align-corners growth, 1x1 projection."""

    def __init__(self, c: int):
        super().__init__()
        self.projection = nn.Conv2d(c, c, 1)
        self.residual_layer1 = ResidualUnit(c)
        self.residual_layer2 = ResidualUnit(c)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor]
                ) -> torch.Tensor:
        if residual is not None:
            residual = resize_linear(residual, x.shape[2:])
            x = x + self.residual_layer1(residual)
        x = upsample2_align_corners(self.residual_layer2(x))
        return self.projection(x)


class FusionStage(nn.Module):
    def __init__(self, c: int, n: int = 4):
        super().__init__()
        self.layers = nn.ModuleList(FusionLayer(c) for _ in range(n))

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        """Fine-to-coarse features -> the fusion outputs, coarse first."""
        fused, outs = None, []
        for layer, h in zip(self.layers, feats[::-1]):
            fused = layer(h, None) if fused is None else layer(fused, h)
            outs.append(fused)
        return outs


# --------------------------------------------------------------------------
# BiT backbone
# --------------------------------------------------------------------------


class WSConv2dSame(nn.Conv2d):
    """Weight-standardized conv (per-output-filter zero mean / unit
    variance, biased variance, eps 1e-8) with TF-SAME padding."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        m = w.mean(dim=(1, 2, 3), keepdim=True)
        v = w.var(dim=(1, 2, 3), keepdim=True, unbiased=False)
        w = (w - m) * torch.rsqrt(v + WS_EPS)
        x = pad_same(x, self.kernel_size[0], self.stride[0])
        return F.conv2d(x, w, self.bias, self.stride)


class GroupNormAct(nn.GroupNorm):
    def __init__(self, groups: int, c: int, relu: bool = True):
        super().__init__(groups, c, eps=GN_EPS)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        return F.relu(x) if self.relu else x


def make_div(v: float, divisor: int = 8) -> int:
    """HF BiT's channel rounding of the bottleneck width."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


class _Downsample(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, groups: int):
        super().__init__()
        self.conv = WSConv2dSame(cin, cout, 1, stride, bias=False)
        self.norm = GroupNormAct(groups, cout, relu=False)


class BitBottleneck(nn.Module):
    """Non-preactivation bottleneck; the first layer of a stage carries a
    downsample (projection) shortcut."""

    def __init__(self, cin: int, cout: int, stride: int, first: bool,
                 groups: int):
        super().__init__()
        mid = make_div(cout * 0.25)
        if first:
            self.downsample = _Downsample(cin, cout, stride, groups)
        self.first = first
        self.conv1 = WSConv2dSame(cin, mid, 1, bias=False)
        self.norm1 = GroupNormAct(groups, mid)
        self.conv2 = WSConv2dSame(mid, mid, 3, stride, bias=False)
        self.norm2 = GroupNormAct(groups, mid)
        self.conv3 = WSConv2dSame(mid, cout, 1, bias=False)
        self.norm3 = GroupNormAct(groups, cout, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.first:
            shortcut = self.downsample.norm(self.downsample.conv(x))
        h = self.norm1(self.conv1(x))
        h = self.norm2(self.conv2(h))
        h = self.norm3(self.conv3(h))
        return F.relu(h + shortcut)


class _Stage(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.Sequential(*layers)


class _Embedder(nn.Module):
    def __init__(self, cfg: DPTHybridConfig):
        super().__init__()
        self.convolution = WSConv2dSame(3, cfg.bit_embedding, 7, 2,
                                        bias=False)
        self.norm = GroupNormAct(cfg.num_groups, cfg.bit_embedding)


class _Encoder(nn.Module):
    def __init__(self, stages):
        super().__init__()
        self.stages = nn.ModuleList(stages)


class BiT(nn.Module):
    """NCHW image -> [stage1 (/4), stage2 (/8), stage3 (/16)] features."""

    def __init__(self, cfg: DPTHybridConfig):
        super().__init__()
        self.embedder = _Embedder(cfg)
        stages, cin = [], cfg.bit_embedding
        for si, (depth, cout) in enumerate(zip(cfg.bit_depths,
                                               cfg.bit_hidden)):
            stride = 1 if si == 0 else 2
            stages.append(_Stage([
                BitBottleneck(cin if li == 0 else cout, cout,
                              stride if li == 0 else 1, li == 0,
                              cfg.num_groups)
                for li in range(depth)]))
            cin = cout
        self.encoder = _Encoder(stages)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.embedder.norm(self.embedder.convolution(x))
        # dynamic-SAME max pool; zero padding equals -inf after the ReLU
        x = F.max_pool2d(pad_same(x, 3, 2), 3, 2)
        feats = []
        for stage in self.encoder.stages:
            x = stage.layers(x)
            feats.append(x)
        return feats


# --------------------------------------------------------------------------
# the network
# --------------------------------------------------------------------------


class _Backbone(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.bit = BiT(cfg)


class _Embeddings(nn.Module):
    def __init__(self, cfg: DPTHybridConfig):
        super().__init__()
        c = cfg.hidden_size
        self.backbone = _Backbone(cfg)
        self.projection = nn.Conv2d(cfg.bit_hidden[-1], c, 1)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, 1 + cfg.pos_grid * cfg.pos_grid, c))


class _ViTEncoder(nn.Module):
    def __init__(self, cfg: DPTHybridConfig):
        super().__init__()
        self.layer = nn.ModuleList(
            ViTLayer(cfg.hidden_size, cfg.num_heads, cfg.intermediate_size)
            for _ in range(cfg.num_layers))


class _DPTModel(nn.Module):
    def __init__(self, cfg: DPTHybridConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _ViTEncoder(cfg)
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)


class _Neck(nn.Module):
    def __init__(self, cfg: DPTHybridConfig):
        super().__init__()
        self.reassemble_stage = ReassembleStage(
            cfg.hidden_size, cfg.neck_hidden, cfg.reassemble_factors,
            identity=(0, 1))
        self.convs = nn.ModuleList(
            nn.Conv2d(c, cfg.fusion_hidden, 3, padding=1, bias=False)
            for c in cfg.neck_hidden)
        self.fusion_stage = FusionStage(cfg.fusion_hidden,
                                        len(cfg.neck_hidden))


class _Head(nn.Module):
    def __init__(self, cfg: DPTHybridConfig):
        super().__init__()
        f = cfg.fusion_hidden
        self.head = nn.Sequential(
            nn.Conv2d(f, f // 2, 3, padding=1), nn.Identity(),
            nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, cfg.out_channels, 1))


class DPTHybrid(nn.Module):
    """`forward` maps a (B, 3, H, W) image (H, W multiples of 32) to a
    (B, out_channels, H, W) prediction."""

    def __init__(self, cfg: DPTHybridConfig = DPTHybridConfig()):
        super().__init__()
        self.cfg = cfg
        self.dpt = _DPTModel(cfg)
        self.neck = _Neck(cfg)
        self.head = _Head(cfg)

    def vit_encoder(self, feats16: torch.Tensor) -> List[torch.Tensor]:
        """stage3 features -> token sequences after the readout layers."""
        emb = self.dpt.embeddings
        b, _, h, w = feats16.shape
        tokens = emb.projection(feats16).flatten(2).transpose(1, 2)
        cls = emb.cls_token.expand(b, 1, -1)
        tokens = torch.cat([cls, tokens], 1)
        tokens = tokens + _resize_pos_embed(emb.position_embeddings, h, w)
        outs = []
        for i, layer in enumerate(self.dpt.encoder.layer):
            tokens = layer(tokens)
            if i in self.cfg.readout_layers:
                outs.append(tokens)
        return outs

    def neck_forward(self, s1, s2, t8, t11, gh: int, gw: int
                     ) -> List[torch.Tensor]:
        """The four fusion outputs, coarse first."""
        rs = self.neck.reassemble_stage
        hidden = [s1, s2, rs(t8, 2, gh, gw), rs(t11, 3, gh, gw)]
        feats = [conv(h) for conv, h in zip(self.neck.convs, hidden)]
        return self.neck.fusion_stage(feats)

    def head_forward(self, fused: torch.Tensor) -> torch.Tensor:
        hd = self.head.head
        # cuDNN's float32 (no TF32) algorithm for this 3x3 conv at 192x192
        # (256 -> 128 channels, the omnidata operating point) takes most of
        # the network's time on an H100 (chip_smoke.py's dpt_head_conv_ms
        # times both routes); PyTorch's own convolution runs it
        with without_cudnn():
            h = hd[0](fused)
        h = upsample2_align_corners(h)
        h = F.relu(hd[2](h))
        return F.relu(hd[4](h))

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        s1, s2, s3 = self.dpt.embeddings.backbone.bit(image)
        gh, gw = s3.shape[2], s3.shape[3]
        t8, t11 = self.vit_encoder(s3)
        return self.head_forward(self.neck_forward(s1, s2, t8, t11, gh,
                                                   gw)[-1])


def _resize_pos_embed(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(1, 1 + g*g, C) -> (1, 1 + gh*gw, C), the grid resized as
    `jax.image.resize(..., "linear")` does."""
    g = int(round((pos.shape[1] - 1) ** 0.5))
    if (gh, gw) == (g, g):
        return pos
    grid = pos[0, 1:].reshape(g, g, -1).permute(2, 0, 1)[None]
    grid = resize_linear(grid, (gh, gw))[0].permute(1, 2, 0)
    return torch.cat([pos[:, :1], grid.reshape(1, gh * gw, -1)], 1)


def bit_backbone(model: DPTHybrid, x: torch.Tensor) -> List[torch.Tensor]:
    """NCHW image -> [stage1 (/4), stage2 (/8), stage3 (/16)]."""
    with strict_fp32():
        return model.dpt.embeddings.backbone.bit(x)


def vit_encoder(model: DPTHybrid, feats16: torch.Tensor
                ) -> List[torch.Tensor]:
    with strict_fp32():
        return model.vit_encoder(feats16)


def dpt_forward(model: DPTHybrid, image: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) -> (B, out_channels, H, W)."""
    with strict_fp32():
        return model(image)


@torch.inference_mode()
def run_normals(model: DPTHybrid, image: np.ndarray) -> np.ndarray:
    """(H, W, 3) rgb in [0, 1] -> (H, W, 3) omnidata-convention normal
    map in [0, 1] (the raw model output, clamped)."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(image, np.float32), device=dev)
    out = dpt_forward(model, x.permute(2, 0, 1)[None])
    return torch.clamp(out[0], 0.0, 1.0).permute(1, 2, 0).cpu().numpy()


def load_params(path) -> dict:
    """The arrays of a DPT npz, or of omnidata_dpt_normal_v2.ckpt converted
    in-process."""
    from dnsplatter_torch.priors.convert import load_dpt_checkpoint

    return load_weights(path, load_dpt_checkpoint, "--dpt",
                        "omnidata_dpt_normal_v2.ckpt")


def load_model(path=None, cfg: DPTHybridConfig | None = None, device=None,
               seed=None) -> DPTHybrid:
    """DPT-Hybrid (default: the omnidata normal configuration) on `device`
    (None: the card) from `path`, or with seeded weights when it is None."""
    cfg = cfg or DPTHybridConfig(out_channels=3)
    arrays = load_params(path) if path is not None else None
    return build(DPTHybrid(cfg), device, seed, arrays)
