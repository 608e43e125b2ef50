"""DSINE surface-normal network as an nn.Module (counterpart of
dnsplatter_tpu/priors/dsine.py):

  EfficientNet-B5 encoder (priors/efficientnet.py)
  -> Decoder: 1x1 bottleneck conv + two UpSampleGN blocks
     (weight-standardized conv + GroupNorm(8) + LeakyReLU) + three
     prediction heads (initial normal / feature / hidden state)
  -> 5 iterations of neighborhood rotation refinement (NRN): a ConvGRU
     (ks=5) updates the hidden state; per-pixel heads predict 5x5
     neighbor probabilities, rotation axes (projected into the image
     plane through the camera rays) and angles; neighbor normals are
     rotated by the axis-angle matrices, ray-ReLU'd, probability-averaged
     and convex-upsampled (x8) with a softmax-weighted 3x3 kernel.

NCHW throughout, float32, with the JAX package's numerics: GroupNorm eps
1e-5, weight standardization by the UNBIASED std plus 1e-5 after the sqrt,
F.normalize eps 1e-12, cosine eps 1e-8, replicate-pad unfolds, bilinear
align_corners=False growth. The state-dict keys are the reference DSINE's
(`encoder.original_model.*`, `decoder.*`, `gru.*`, `*_head.*`); the default
widths are the published model's (bottleneck 2048, feature and hidden
state 64, decoder heads 128 wide, refinement heads 64).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dnsplatter_torch.priors.common import build, load_weights, strict_fp32
from dnsplatter_torch.priors.efficientnet import EfficientNetB5
from dnsplatter_torch.utils import profiling

PS = 5  # NRN patch size
NUM_ITER = 5
DOWN = 8  # downsample ratio of the coarse prediction
B5_TAPS = (24, 40, 64, 176, 2048)  # channels of the encoder's five taps


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _normalize(x, dim=1, eps=1e-12):
    """F.normalize: x / max(||x||_2, eps)."""
    n = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(n, min=eps)


class Conv2dWS(nn.Conv2d):
    """Conv2d_WS: per-output-channel mean removed, divided by the UNBIASED
    std over (in, kh, kw) plus 1e-5."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        wc = w - w.mean(dim=(1, 2, 3), keepdim=True)
        n = w.shape[1] * w.shape[2] * w.shape[3]
        var = torch.sum(wc * wc, dim=(1, 2, 3), keepdim=True) / (n - 1)
        return F.conv2d(x, wc / (torch.sqrt(var) + 1e-5), self.bias,
                        self.stride, self.padding)


def prediction_head(cin: int, hidden: int, cout: int) -> nn.Sequential:
    """conv3x3 + ReLU -> conv1x1 + ReLU -> conv1x1 (keys .0 .2 .4)."""
    return nn.Sequential(nn.Conv2d(cin, hidden, 3, padding=1), nn.ReLU(),
                         nn.Conv2d(hidden, hidden, 1), nn.ReLU(),
                         nn.Conv2d(hidden, cout, 1))


class UpSampleGN(nn.Module):
    """Bilinear growth to the skip's size, concat, two [WS-conv3x3 ->
    GroupNorm(8) -> LeakyReLU] layers (keys _net.0 _net.1 _net.3 _net.4)."""

    def __init__(self, skip_input: int, output_features: int):
        super().__init__()
        self._net = nn.Sequential(
            Conv2dWS(skip_input, output_features, 3, padding=1),
            nn.GroupNorm(8, output_features), nn.LeakyReLU(),
            Conv2dWS(output_features, output_features, 3, padding=1),
            nn.GroupNorm(8, output_features), nn.LeakyReLU())

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = F.interpolate(x, size=skip.shape[2:], mode="bilinear",
                           align_corners=False)
        return self._net(torch.cat([up, skip], 1))


class ConvGRU(nn.Module):
    """ConvGRU with 5x5 gates."""

    def __init__(self, hidden: int, cin: int, ks: int = 5):
        super().__init__()
        self.convz = nn.Conv2d(hidden + cin, hidden, ks, padding=ks // 2)
        self.convr = nn.Conv2d(hidden + cin, hidden, ks, padding=ks // 2)
        self.convq = nn.Conv2d(hidden + cin, hidden, ks, padding=ks // 2)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], 1)))
        return (1 - z) * h + z * q


def _unfold_replicate(x: torch.Tensor, ps: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, ps*ps, H, W) patches with replicate padding,
    patch index = ky * ps + kx."""
    pad = (ps - 1) // 2
    xp = F.pad(x, (pad, pad, pad, pad), mode="replicate")
    h, w = x.shape[2], x.shape[3]
    return torch.stack([xp[:, :, ky:ky + h, kx:kx + w]
                        for ky in range(ps) for kx in range(ps)], dim=2)


def _ray_relu(pred_norm, ray, eps=1e-2):
    """Clamp the component of the normal along the viewing ray to >= eps of
    its cosine (torch cosine_similarity with eps 1e-8, then normalize)."""
    na = torch.clamp(torch.sqrt(torch.sum(pred_norm ** 2, 1, keepdim=True)),
                     min=1e-8)
    nb = torch.clamp(torch.sqrt(torch.sum(ray ** 2, 1, keepdim=True)),
                     min=1e-8)
    cos = torch.sum(pred_norm * ray, 1, keepdim=True) / (na * nb)
    norm_along_view = ray * cos
    relu_along_view = ray * (F.relu(cos - eps) + eps)
    return _normalize(pred_norm + (relu_along_view - norm_along_view))


def _axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> quaternion -> rotation matrix, with the small-angle
    series branch."""
    angles = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half = angles * 0.5
    small = torch.abs(angles) < 1e-6
    safe = torch.where(small, torch.ones_like(angles), angles)
    sin_half_over = torch.where(small, 0.5 - angles * angles / 48.0,
                                torch.sin(half) / safe)
    quat = torch.cat([torch.cos(half), axis_angle * sin_half_over], -1)
    r, i, j, k = quat.unbind(-1)
    two_s = 2.0 / torch.sum(quat * quat, dim=-1)
    o = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j),
    ], dim=-1)
    return o.reshape(axis_angle.shape[:-1] + (3, 3))


def _convex_upsample(out: torch.Tensor, up_mask: torch.Tensor, k: int
                     ) -> torch.Tensor:
    """Replicate-pad 3x3 neighbourhood, softmax over the 9 weights,
    pixel-shuffle by k."""
    b, c, h, w = out.shape
    mask = torch.softmax(up_mask.reshape(b, 1, 9, k, k, h, w), dim=2)
    nb = _unfold_replicate(out, 3)  # (B, C, 9, H, W)
    up = torch.sum(mask * nb[:, :, :, None, None], dim=2)  # (B,C,k,k,H,W)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(b, c, k * h, k * w)


def _pixel_coords(h: int, w: int, device) -> torch.Tensor:
    """(1, 3, H, W) homogeneous pixel centers (x+0.5, y+0.5, 1)."""
    x = torch.arange(w, dtype=torch.float32, device=device)[None, :] + 0.5
    y = torch.arange(h, dtype=torch.float32, device=device)[:, None] + 0.5
    return torch.stack([x.expand(h, w), y.expand(h, w),
                        torch.ones(h, w, device=device)], 0)[None]


def _get_ray(intrins, h, w, orig_h, orig_w, return_uv=False):
    """Rays through downsampled pixel centers with resolution-rescaled
    intrinsics."""
    fu = intrins[:, 0, 0][:, None, None] * (w / orig_w)
    cu = intrins[:, 0, 2][:, None, None] * (w / orig_w)
    fv = intrins[:, 1, 1][:, None, None] * (h / orig_h)
    cv = intrins[:, 1, 2][:, None, None] * (h / orig_h)
    pc = _pixel_coords(h, w, intrins.device)
    rx = (pc[:, 0] - cu) / fu
    ry = (pc[:, 1] - cv) / fv
    ray = torch.stack([rx, ry, pc[:, 2].expand_as(rx)], 1)
    return ray[:, :2] if return_uv else _normalize(ray)


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------


class Decoder(nn.Module):
    """Bottleneck conv, two UpSampleGN blocks, three prediction heads."""

    def __init__(self, nf: int = 2048, feature_dim: int = 64,
                 hidden_dim: int = 64, head_hidden: int = 128):
        super().__init__()
        c2, c4, c32 = B5_TAPS[2], B5_TAPS[3], B5_TAPS[4]
        self.conv2 = nn.Conv2d(c32 + 2, nf, 1)
        self.up1 = UpSampleGN(nf + c4 + 2, nf // 2)
        self.up2 = UpSampleGN(nf // 2 + c2 + 2, nf // 4)
        i_dim = nf // 4 + 2
        self.normal_head = prediction_head(i_dim, head_hidden, 3)
        self.feature_head = prediction_head(i_dim, head_hidden, feature_dim)
        self.hidden_head = prediction_head(i_dim, head_hidden, hidden_dim)

    def forward(self, feats, uvs):
        x_block2, x_block3, x_block4 = feats[2], feats[3], feats[4]
        uv_32, uv_16, uv_8 = uvs
        b = x_block4.shape[0]

        def bc(uv):
            return uv.expand((b,) + uv.shape[1:])

        x_d0 = self.conv2(torch.cat([x_block4, bc(uv_32)], 1))
        x_d1 = self.up1(x_d0, torch.cat([x_block3, bc(uv_16)], 1))
        x_feat = self.up2(x_d1, torch.cat([x_block2, bc(uv_8)], 1))
        x_feat = torch.cat([x_feat, bc(uv_8)], 1)
        normal = _normalize(self.normal_head(x_feat))
        return normal, self.feature_head(x_feat), self.hidden_head(x_feat)


class Encoder(nn.Module):
    """The B5 under DSINE's `encoder.original_model` key prefix."""

    def __init__(self):
        super().__init__()
        self.original_model = EfficientNetB5()

    def forward(self, img):
        return self.original_model(img)


class DSINE(nn.Module):
    """The whole network; `forward(img, intrins)` returns one (B, 3, H, W)
    normal map per refinement stage (use [-1])."""

    def __init__(self, nf: int = 2048, feature_dim: int = 64,
                 hidden_dim: int = 64, head_hidden: int = 128,
                 nrn_hidden: int = 64):
        super().__init__()
        self.encoder = Encoder()
        self.decoder = Decoder(nf, feature_dim, hidden_dim, head_hidden)
        self.gru = ConvGRU(hidden_dim, feature_dim + 2, ks=5)
        h2 = hidden_dim + 2
        self.prob_head = prediction_head(h2, nrn_hidden, PS * PS)
        self.xy_head = prediction_head(h2, nrn_hidden, PS * PS * 2)
        self.angle_head = prediction_head(h2, nrn_hidden, PS * PS)
        self.up_prob_head = prediction_head(h2, nrn_hidden, DOWN * DOWN * 9)

    def refine(self, h, feat_map, pred_norm, intrins, orig_h, orig_w, uv_8,
               ray_8):
        """One NRN iteration."""
        b, _, hh, ww = pred_norm.shape
        fu = intrins[:, 0, 0][:, None, None, None] * (ww / orig_w)
        cu = intrins[:, 0, 2][:, None, None, None] * (ww / orig_w)
        fv = intrins[:, 1, 1][:, None, None, None] * (hh / orig_h)
        cv = intrins[:, 1, 2][:, None, None, None] * (hh / orig_h)

        h_new = self.gru(h, feat_map)
        huv = torch.cat([h_new, uv_8.expand((b,) + uv_8.shape[1:])], 1)
        nghbr_prob = torch.sigmoid(self.prob_head(huv))[:, None]
        nghbr_normals = _unfold_replicate(pred_norm, PS)  # (B,3,25,h,w)
        xys = self.xy_head(huv)
        nghbr_xys = _normalize(torch.stack([xys[:, :PS * PS],
                                            xys[:, PS * PS:]], 1), dim=1)
        nghbr_angle = torch.sigmoid(self.angle_head(huv))[:, None] * np.pi
        nghbr_pixel = _unfold_replicate(_pixel_coords(hh, ww, h.device), PS)

        du_over_fu = nghbr_xys[:, 0] / fu  # (B, 25, h, w)
        dv_over_fv = nghbr_xys[:, 1] / fv
        term_u = (nghbr_pixel[:, 0] + nghbr_xys[:, 0] - cu) / fu
        term_v = (nghbr_pixel[:, 1] + nghbr_xys[:, 1] - cv) / fv
        nx, ny, nz = nghbr_normals[:, 0], nghbr_normals[:, 1], \
            nghbr_normals[:, 2]
        num = -(du_over_fu * nx + dv_over_fv * ny)
        denom = term_u * nx + term_v * ny + nz
        # |denom| < 1e-8 becomes 1e-8 * sign(denom); a zero denominator
        # yields inf/nan axes that the invalid mask below zeroes
        denom = torch.where(torch.abs(denom) < 1e-8,
                            1e-8 * torch.sign(denom), denom)
        delta_z = num / denom

        axes = _normalize(torch.stack([du_over_fu + delta_z * term_u,
                                       dv_over_fv + delta_z * term_v,
                                       delta_z], 1), dim=1)
        invalid = torch.sum((torch.isnan(axes) | torch.isinf(axes)).float(),
                            dim=1) > 0.5
        axes = torch.where(invalid[:, None], torch.zeros_like(axes), axes)
        axes = torch.nan_to_num(axes, nan=0.0, posinf=0.0, neginf=0.0)

        rot = _axis_angle_to_matrix(torch.movedim(axes * nghbr_angle, 1, -1))
        n_in = torch.movedim(nghbr_normals, 1, -1)[..., None]
        n_rot = _normalize(torch.movedim(torch.matmul(rot, n_in)[..., 0],
                                         -1, 1), dim=1)  # (B,3,25,h,w)
        n_rot = _ray_relu(n_rot, ray_8[:, :, None])

        pred = _normalize(torch.sum(nghbr_prob * n_rot, dim=2))
        up_mask = self.up_prob_head(huv)
        return h_new, pred, _normalize(_convex_upsample(pred, up_mask, DOWN))

    def forward(self, img: torch.Tensor, intrins: torch.Tensor,
                num_iter: int = NUM_ITER) -> List[torch.Tensor]:
        """img (B, 3, H, W) ImageNet-normalized, H and W multiples of 32;
        intrins (B, 3, 3) pixel intrinsics of that image (top-left (0, 0)
        convention; +0.5 is added here)."""
        with profiling.span("prior.encoder"):
            feats = self.encoder(img)
        with profiling.span("prior.decoder"):
            b, _, orig_h, orig_w = img.shape
            intrins = intrins.clone()
            intrins[:, 0, 2] += 0.5
            intrins[:, 1, 2] += 0.5
            uv_32 = _get_ray(intrins, orig_h // 32, orig_w // 32, orig_h,
                             orig_w, True)
            uv_16 = _get_ray(intrins, orig_h // 16, orig_w // 16, orig_h,
                             orig_w, True)
            uv_8 = _get_ray(intrins, orig_h // 8, orig_w // 8, orig_h,
                            orig_w, True)
            ray_8 = _get_ray(intrins, orig_h // 8, orig_w // 8, orig_h,
                             orig_w)

            pred_norm, feat_map, h = self.decoder(feats, (uv_32, uv_16, uv_8))
            pred_norm = _ray_relu(pred_norm, ray_8)
            uv_b = uv_8.expand((b,) + uv_8.shape[1:])
            feat_map = torch.cat([feat_map, uv_b], 1)
            up_mask = self.up_prob_head(torch.cat([h, uv_b], 1))
            preds = [_normalize(_convex_upsample(pred_norm, up_mask, DOWN))]
        for _ in range(num_iter):
            with profiling.span("prior.refine"):
                h, pred_norm, up = self.refine(h, feat_map, pred_norm,
                                               intrins, orig_h, orig_w, uv_8,
                                               ray_8)
            profiling.count("prior.refine_iters")
            preds.append(up)
        return preds


def dsine_forward(model: DSINE, img: torch.Tensor, intrins: torch.Tensor,
                  num_iter: int = NUM_ITER) -> List[torch.Tensor]:
    """The JAX package's `dsine_forward`: one normal map per stage."""
    with strict_fp32():
        return model(img, intrins, num_iter)


# ---------------------------------------------------------------------------
# predictor
# ---------------------------------------------------------------------------

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def pad_input(h: int, w: int) -> Tuple[int, int, int, int]:
    """Zero-pad sizes (left, right, top, bottom) so both dims are
    multiples of 32."""
    left = right = top = bottom = 0
    if w % 32:
        nw = 32 * (w // 32 + 1)
        left = (nw - w) // 2
        right = nw - w - left
    if h % 32:
        nh = 32 * (h // 32 + 1)
        top = (nh - h) // 2
        bottom = nh - h - top
    return left, right, top, bottom


def intrins_from_fov(fov_deg: float, h: int, w: int) -> np.ndarray:
    f = (max(w, h) / 2.0) / np.tan(np.deg2rad(fov_deg / 2.0))
    return np.array([[f, 0, w / 2.0 - 0.5], [0, f, h / 2.0 - 0.5], [0, 0, 1]],
                    np.float32)


@torch.inference_mode()
def predict_normals(model: DSINE, rgb_u8: np.ndarray,
                    K: np.ndarray | None = None) -> np.ndarray:
    """uint8 (H, W, 3) -> (H, W, 3) unit camera-space normals: pad to /32,
    ImageNet-normalize, run on the model's device, crop. Recorded as the
    span `prior.frame` around `prior.prepare` (the host pre-pass and the
    upload), the network's spans and `prior.readback` (the crop and the
    copy to the host)."""
    with profiling.span("prior.frame"):
        with profiling.span("prior.prepare"):
            h, w = rgb_u8.shape[:2]
            img = rgb_u8.astype(np.float32) / 255.0
            left, right, top, bottom = pad_input(h, w)
            img = np.pad(img, ((top, bottom), (left, right), (0, 0)))
            img = (img - IMAGENET_MEAN) / IMAGENET_STD
            dev = next(model.parameters()).device
            x = torch.as_tensor(
                np.ascontiguousarray(img.transpose(2, 0, 1)[None]),
                device=dev)
            K = (intrins_from_fov(60.0, h, w) if K is None
                 else K.astype(np.float32))
            K = K.copy()
            K[0, 2] += left
            K[1, 2] += top
            Kt = torch.as_tensor(K[None], device=dev)
        profiling.count("prior.frames")
        profiling.count("prior.pixels", x.shape[2] * x.shape[3])
        out = dsine_forward(model, x, Kt)[-1]
        with profiling.span("prior.readback"):
            out = out[0].permute(1, 2, 0).cpu().numpy()
            return out[top:top + h, left:left + w]


def load_params(path) -> dict:
    """The arrays of a DSINE npz, or of the published `dsine.pt` converted
    in-process."""
    from dnsplatter_torch.priors.convert import load_dsine_checkpoint

    return load_weights(path, load_dsine_checkpoint, "", "dsine.pt")


def widths_of(arrays) -> dict:
    """DSINE's constructor widths read from a parameter dict's shapes."""
    return {"nf": arrays["decoder.conv2.weight"].shape[0],
            "feature_dim": arrays["decoder.feature_head.4.weight"].shape[0],
            "hidden_dim": arrays["decoder.hidden_head.4.weight"].shape[0],
            "head_hidden": arrays["decoder.normal_head.0.weight"].shape[0],
            "nrn_hidden": arrays["prob_head.0.weight"].shape[0]}


def load_model(path=None, device=None, seed=None, **widths) -> DSINE:
    """DSINE on `device` (None: the card) from `path` (npz or checkpoint,
    its widths read from the shapes), or with the seeded weights of
    `init_random_` at `widths` (default: the published ones) when `path` is
    None."""
    if path is None:
        return build(DSINE(**widths), device, seed)
    arrays = load_params(path)
    return build(DSINE(**widths_of(arrays)), device, arrays=arrays)
