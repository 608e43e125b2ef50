"""ZoeDepth-NYU (ZoeD_N), the metric monocular depth network, as an
nn.Module (counterpart of dnsplatter_tpu/priors/zoedepth.py):

  BEiT-Large/16 @384: patch conv + cls token, 24 pre-norm layers with
    per-layer RELATIVE position bias (bilinearly resized for off-grid
    windows, MiDaS v3.1 style), layer scale (lambda_1/2), no absolute
    positions; hidden states after layers 6/12/18/24 feed the neck
  DPT neck: readout-projected reassembly at factors 4/2/1/0.5
    (transposed convs up, strided conv down) + 4 RefineNet fusions
  relative head: conv3x3 -> 2x up (align_corners) -> conv3x3 -> ReLU
    -> conv1x1 -> ReLU  => relative depth + 32-ch conditioning features
  metric head (single NYU configuration, bin_centers_type="softplus"):
    seed bin regressor (softplus bins) + seed projector, then per-scale
    projector + attractor layers (inverse attractor dx/(1+300 dx^2),
    mean over attractor points), and a conditional log-binomial softmax
    over 64 bins conditioned on [relative features, relative depth];
    depth = sum p_k * c_k.

NCHW inside; the state-dict keys are the HF-transformers ZoeDepth names the
JAX package reads. Each layer's `relative_position_index` for the training
window is a non-persistent buffer (the JAX parameters leave it out); other
windows build their index on the fly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dnsplatter_torch.priors.common import (
    build,
    load_weights,
    resize_align_corners,
    resize_linear,
    strict_fp32,
)
from dnsplatter_torch.priors.dpt import (
    FusionStage,
    ReassembleStage,
    ViTLayer,
    upsample2_align_corners,
)


@dataclasses.dataclass(frozen=True)
class ZoeDepthNYUConfig:
    """ZoeD_N defaults (BEiT-L/16-384 + single NYU bins head). The fields
    after `attractor_kind` are widths the JAX package reads from the
    parameters' shapes; here they build the module."""

    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 16
    train_image_size: int = 384  # rel-pos tables are shaped for this
    out_layers: Tuple[int, ...] = (6, 12, 18, 24)  # 1-based, post-layer
    reassemble_factors: Tuple[float, ...] = (4.0, 2.0, 1.0, 0.5)
    fusion_hidden: int = 256
    num_relative_features: int = 32
    n_bins: int = 64
    min_depth: float = 1e-3
    max_depth: float = 10.0
    min_temp: float = 0.0212
    max_temp: float = 50.0
    attractor_kind: str = "mean"
    neck_hidden: Tuple[int, ...] = (256, 512, 1024, 1024)
    bin_embedding_dim: int = 128
    num_attractors: Tuple[int, ...] = (16, 8, 4, 1)
    seed_mlp: int = 256
    projector_mlp: int = 128
    attractor_mlp: int = 128


# The narrow configuration of the parity tests and of the card-vs-CPU check
# (the JAX package's tests/test_zoedepth.py shapes).
SMALL_CONFIG = ZoeDepthNYUConfig(
    hidden_size=32, num_layers=4, num_heads=2, intermediate_size=64,
    train_image_size=96, out_layers=(1, 2, 3, 4), fusion_hidden=24,
    num_relative_features=8, n_bins=16, neck_hidden=(8, 16, 24, 24),
    bin_embedding_dim=8, num_attractors=(4, 3, 2, 1))


# --------------------------------------------------------------------------
# BEiT backbone
# --------------------------------------------------------------------------


def _rel_pos_index(wh: int, ww: int) -> np.ndarray:
    """(wh*ww+1, wh*ww+1) table row of each (query, key) token pair, for
    any window (BeitRelativePositionBias.generate_relative_position_index)."""
    num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing="ij"))  # (2, wh, ww)
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).copy()
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    area = wh * ww
    idx = np.zeros((area + 1, area + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, :] = num_rel - 3
    idx[:, 0] = num_rel - 2
    idx[0, 0] = num_rel - 1
    return idx


class RelativePositionBias(nn.Module):
    def __init__(self, window: int, heads: int):
        super().__init__()
        self.window = window
        n = (2 * window - 1) ** 2 + 3
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(n, heads))
        self.register_buffer(
            "relative_position_index",
            torch.as_tensor(_rel_pos_index(window, window)), persistent=False)

    def forward(self, gh: int, gw: int, index: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """(1, heads, T+1, T+1) bias for a (gh, gw) patch grid; the trained
        grid is resized bilinearly for another window, reshaped as (width,
        height) first (HF / timm's quirk, kept for weight compatibility).
        `index` is that window's `_rel_pos_index` on the table's device
        (built here when not given)."""
        table = self.relative_position_bias_table
        o = 2 * self.window - 1
        if (gh, gw) == (self.window, self.window):
            idx = self.relative_position_index
        else:
            nh, nw = 2 * gh - 1, 2 * gw - 1
            grid = table[:o * o].reshape(o, o, -1).permute(2, 0, 1)[None]
            grid = resize_linear(grid, (nh, nw))[0].permute(1, 2, 0)
            table = torch.cat([grid.reshape(nh * nw, -1), table[o * o:]], 0)
            idx = index if index is not None else torch.as_tensor(
                _rel_pos_index(gh, gw), device=table.device)
        bias = table[idx.reshape(-1)].reshape(idx.shape[0], idx.shape[1], -1)
        return bias.permute(2, 0, 1)[None]


class BeitLayer(ViTLayer):
    """ViT layer with no key bias, layer scale and a relative position
    bias of its own."""

    def __init__(self, cfg: ZoeDepthNYUConfig):
        super().__init__(cfg.hidden_size, cfg.num_heads,
                         cfg.intermediate_size, key_bias=False,
                         layer_scale=True)
        self.attention.attention.relative_position_bias = \
            RelativePositionBias(cfg.train_image_size // cfg.patch_size,
                                 cfg.num_heads)

    def forward(self, x: torch.Tensor, gh: int, gw: int,
                index: Optional[torch.Tensor] = None) -> torch.Tensor:
        bias = self.attention.attention.relative_position_bias(gh, gw, index)
        return super().forward(x, bias)


class _PatchEmbeddings(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.projection = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                    stride=cfg.patch_size)


class _BeitEmbeddings(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.patch_embeddings = _PatchEmbeddings(cfg)


class _BeitEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layer = nn.ModuleList(BeitLayer(cfg)
                                   for _ in range(cfg.num_layers))


class Beit(nn.Module):
    def __init__(self, cfg: ZoeDepthNYUConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _BeitEmbeddings(cfg)
        self.encoder = _BeitEncoder(cfg)
        # (gh, gw, device) -> the off-grid window's index, built once on
        # the host and shared by every layer
        self._indices: Dict[tuple, torch.Tensor] = {}

    def window_index(self, gh: int, gw: int, device) -> torch.Tensor:
        key = (gh, gw, str(device))
        if key not in self._indices:
            self._indices[key] = torch.as_tensor(_rel_pos_index(gh, gw),
                                                 device=device)
        return self._indices[key]

    def forward(self, image: torch.Tensor):
        """(B, 3, H, W) -> token sequences (B, 1 + hw, C) after the
        out_layers (cls first), and the patch grid (gh, gw)."""
        b = image.shape[0]
        x = self.embeddings.patch_embeddings.projection(image)
        gh, gw = x.shape[2], x.shape[3]
        tokens = torch.cat([self.embeddings.cls_token.expand(b, 1, -1),
                            x.flatten(2).transpose(1, 2)], 1)
        index = self.window_index(gh, gw, tokens.device)
        outs = []
        for i, layer in enumerate(self.encoder.layer):
            tokens = layer(tokens, gh, gw, index)
            if (i + 1) in self.cfg.out_layers:
                outs.append(tokens)
        return outs, (gh, gw)


# --------------------------------------------------------------------------
# neck and heads
# --------------------------------------------------------------------------


class _Neck(nn.Module):
    def __init__(self, cfg: ZoeDepthNYUConfig):
        super().__init__()
        self.reassemble_stage = ReassembleStage(
            cfg.hidden_size, cfg.neck_hidden, cfg.reassemble_factors)
        self.convs = nn.ModuleList(
            nn.Conv2d(c, cfg.fusion_hidden, 3, padding=1, bias=False)
            for c in cfg.neck_hidden)
        self.fusion_stage = FusionStage(cfg.fusion_hidden,
                                        len(cfg.neck_hidden))


class RelativeHead(nn.Module):
    def __init__(self, cfg: ZoeDepthNYUConfig):
        super().__init__()
        f = cfg.fusion_hidden
        self.conv1 = nn.Conv2d(f, f // 2, 3, padding=1)
        self.conv2 = nn.Conv2d(f // 2, cfg.num_relative_features, 3,
                               padding=1)
        self.conv3 = nn.Conv2d(cfg.num_relative_features, 1, 1)

    def forward(self, fused_fine: torch.Tensor):
        """-> (relative depth (B, H, W), the 32-ch features)."""
        h = upsample2_align_corners(self.conv1(fused_fine))
        feats = F.relu(self.conv2(h))
        return F.relu(self.conv3(feats))[:, 0], feats


class _MLPConv(nn.Module):
    """1x1 conv -> ReLU -> 1x1 conv (keys conv1 / conv2)."""

    def __init__(self, cin: int, hidden: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, hidden, 1)
        self.conv2 = nn.Conv2d(hidden, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class _ConditionalLogBinomial(nn.Module):
    def __init__(self, cin: int, cond: int):
        super().__init__()
        bottleneck = (cin + cond) // 2
        self.mlp = nn.Sequential(nn.Conv2d(cin + cond, bottleneck, 1),
                                 nn.GELU(), nn.Conv2d(bottleneck, 4, 1))


def _inv_attractor(dx: torch.Tensor, alpha: float = 300.0,
                   gamma: int = 2) -> torch.Tensor:
    # called with its defaults (alpha 300) by every attractor layer,
    # whatever the configuration's attractor_alpha
    return dx / (1.0 + alpha * dx ** gamma)


def _log_binomial(prob: torch.Tensor, temperature: torch.Tensor,
                  n_bins: int) -> torch.Tensor:
    """LogBinomialSoftmax over the channel dim: (B, 1, H, W) probabilities
    -> (B, n_bins, H, W)."""
    eps = 1e-4
    k = torch.arange(n_bins, dtype=torch.float32,
                     device=prob.device)[None, :, None, None]
    km1 = float(n_bins - 1)

    def log_binom(n, kk, e=1e-7):
        n = n + e
        kk = kk + e
        return n * torch.log(n) - kk * torch.log(kk) \
            - (n - kk) * torch.log(n - kk + e)

    p = torch.clamp(prob, eps, 1.0)
    omp = torch.clamp(1.0 - prob, eps, 1.0)
    y = (log_binom(torch.full_like(k, km1), k) + k * torch.log(p)
         + (km1 - k) * torch.log(omp))
    return torch.softmax(y / temperature, dim=1)


class MetricHead(nn.Module):
    """Single-configuration metric head, bin_centers_type='softplus'."""

    def __init__(self, cfg: ZoeDepthNYUConfig):
        super().__init__()
        self.cfg = cfg
        f, e = cfg.fusion_hidden, cfg.bin_embedding_dim
        self.conv2 = nn.Conv2d(f, f, 1)
        self.seed_bin_regressor = _MLPConv(f, cfg.seed_mlp, cfg.n_bins)
        self.seed_projector = _MLPConv(f, cfg.projector_mlp, e)
        self.projectors = nn.ModuleList(
            _MLPConv(f, cfg.projector_mlp, e) for _ in cfg.num_attractors)
        self.attractors = nn.ModuleList(
            _MLPConv(e, cfg.attractor_mlp, a) for a in cfg.num_attractors)
        self.conditional_log_binomial = _ConditionalLogBinomial(
            cfg.num_relative_features + 1, e)

    def forward(self, outconv_activation, bottleneck, feature_blocks,
                relative_depth) -> torch.Tensor:
        cfg = self.cfg
        x = self.conv2(bottleneck)
        prev_bin = F.softplus(self.seed_bin_regressor(x))
        prev_emb = self.seed_projector(x)
        bin_centers, bin_emb = prev_bin, prev_emb
        for proj, attr, feature in zip(self.projectors, self.attractors,
                                       feature_blocks):
            bin_emb = proj(feature)
            hw = bin_emb.shape[2:]
            attractors = F.softplus(attr(bin_emb
                                         + resize_align_corners(prev_emb,
                                                                hw)))
            centers = resize_align_corners(prev_bin, hw)
            dx = attractors[:, :, None] - centers[:, None]
            delta = torch.sum(_inv_attractor(dx), dim=1)
            if cfg.attractor_kind == "mean":
                delta = delta / attractors.shape[1]
            bin_centers = prev_bin = centers + delta
            prev_emb = bin_emb

        last = outconv_activation
        rel = resize_align_corners(relative_depth[:, None], last.shape[2:])
        last = torch.cat([last, rel], 1)
        bin_emb = resize_align_corners(bin_emb, last.shape[2:])
        h = self.conditional_log_binomial.mlp(torch.cat([last, bin_emb], 1))
        h = F.softplus(h)
        p01 = h[:, 0:2] + 1e-4
        prob = p01[:, 0:1] / (p01[:, 0:1] + p01[:, 1:2])
        t01 = h[:, 2:4] + 1e-4
        temp = t01[:, 0:1] / (t01[:, 0:1] + t01[:, 1:2])
        temp = (cfg.max_temp - cfg.min_temp) * temp + cfg.min_temp
        probs = _log_binomial(prob, temp, cfg.n_bins)
        bin_centers = resize_align_corners(bin_centers, probs.shape[2:])
        return torch.sum(probs * bin_centers, dim=1)


class ZoeDepth(nn.Module):
    """`forward` maps a normalized (B, 3, H, W) image (H, W multiples of
    32) to (B, H, W) metric depth."""

    def __init__(self, cfg: ZoeDepthNYUConfig = ZoeDepthNYUConfig()):
        super().__init__()
        self.cfg = cfg
        self.backbone = Beit(cfg)
        self.neck = _Neck(cfg)
        self.relative_head = RelativeHead(cfg)
        self.metric_head = MetricHead(cfg)

    def neck_forward(self, hidden: List[torch.Tensor], gh: int, gw: int):
        """Token stages -> (fusion outputs coarse first, bottleneck)."""
        rs = self.neck.reassemble_stage
        feats = [conv(rs(t, i, gh, gw))
                 for i, (conv, t) in enumerate(zip(self.neck.convs, hidden))]
        return self.neck.fusion_stage(feats), feats[-1]

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        hidden, (gh, gw) = self.backbone(image)
        fused, bottleneck = self.neck_forward(hidden, gh, gw)
        rel_depth, rel_feats = self.relative_head(fused[-1])
        return self.metric_head(rel_feats, bottleneck, fused, rel_depth)


def beit_backbone(model: ZoeDepth, image: torch.Tensor):
    with strict_fp32():
        return model.backbone(image)


def zoedepth_neck(model: ZoeDepth, hidden, gh: int, gw: int):
    with strict_fp32():
        return model.neck_forward(hidden, gh, gw)


def zoedepth_forward(model: ZoeDepth, image: torch.Tensor) -> torch.Tensor:
    with strict_fp32():
        return model(image)


# --------------------------------------------------------------------------
# inference (isl-org ZoeDepth .infer protocol)
# --------------------------------------------------------------------------

_MEAN = 0.5
_STD = 0.5
NET_HW = (384, 512)


@torch.inference_mode()
def predict_depth(model: ZoeDepth, rgb01: np.ndarray,
                  flip_aug: bool = True) -> np.ndarray:
    """(H, W, 3) rgb in [0, 1] -> (H, W) metric depth: resized (linear,
    antialiased where it shrinks) to the trained 384x512, normalized,
    forwarded (averaged with the horizontal flip), resized back."""
    h, w = rgb01.shape[:2]
    dev = next(model.parameters()).device
    img = torch.as_tensor(np.asarray(rgb01, np.float32), device=dev)
    x = resize_linear(img.permute(2, 0, 1)[None], NET_HW)
    x = (x - _MEAN) / _STD
    d = zoedepth_forward(model, x)
    if flip_aug:
        d = 0.5 * (d + zoedepth_forward(model, x.flip(-1)).flip(-1))
    d = resize_linear(d[:, None], (h, w))
    return d[0, 0].cpu().numpy()


def load_params(path) -> dict:
    """The arrays of a ZoeDepth npz, or of ZoeD_M12_N.pt converted
    in-process."""
    from dnsplatter_torch.priors.convert import load_zoedepth_checkpoint

    return load_weights(path, load_zoedepth_checkpoint, "--zoe",
                        "ZoeD_M12_N.pt")


def load_model(path=None, cfg: ZoeDepthNYUConfig | None = None, device=None,
               seed=None) -> ZoeDepth:
    """ZoeD_N on `device` (None: the card) from `path`, or with seeded
    weights when it is None."""
    arrays = load_params(path) if path is not None else None
    return build(ZoeDepth(cfg or ZoeDepthNYUConfig()), device, seed, arrays)


