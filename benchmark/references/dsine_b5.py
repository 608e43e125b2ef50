"""DSINE with its EfficientNet-B5 encoder: a plain float32 reference of the
surface-normal prior, for the benchmark's check of `dsine_b5` cells.

Written from the published equations (Bae & Davison, "Rethinking
Inductive Biases for Surface Normal Estimation", CVPR 2024; DSINE's
`dsine.py`, `submodules.py` and `rotations.py`; geffnet's
`tf_efficientnet_b5_ap`), as restated in the JAX package's
`priors/dsine.py` and `priors/efficientnet.py`. Plain functional torch over
the flat state-dict arrays (the DSINE state-dict keys), float32 unless
asked otherwise, with TF32 off for cuDNN and cuBLAS for the length of a
forward and the caller's flags restored after it. No cache, no batching.
It imports nothing of the program.

Routes of its own, apart from the program's:

* the B5's stage widths and repeats derived from geffnet's base
  EfficientNet definition and the B5 multipliers (channels x1.6 rounded
  to 8, repeats x2.2 rounded up), not written out;
* BatchNorm as `(x - mean) / sqrt(var + 1e-3) * w + b`, not folded;
* SiLU as `x * sigmoid(x)`; GroupNorm by its group statistics;
* weight standardisation with `torch.var(unbiased=True)`;
* neighbourhoods with `F.unfold` over a replicate pad;
* the axis-angle rotation by Rodrigues' formula on the rotation vector,
  with its own small-angle series (sin t / t and (1 - cos t) / t^2), not
  through a quaternion and a matrix;
* the cosine of the ray-ReLU by `F.cosine_similarity`, unit vectors by
  `F.normalize`;
* the x8 convex upsample as unfold, a softmax over the 9 weights, an
  einsum and a reshape to pixels.

Numerics as the program states them (its `priors/dsine.py` docstring),
each a departure from, or a choice the published code leaves to, the
framework:

* eps values: BatchNorm 1e-3 (the tf_ variants), GroupNorm 1e-5, weight
  standardisation's std plus 1e-5 after the square root, normalisation
  1e-12, the cosine's 1e-8;
* the ray-ReLU floor eps 1e-2;
* the intrinsics in the top-left (0, 0) pixel convention, +0.5 added to
  the principal point inside the forward;
* the frame zero-padded in [0, 1] to a multiple of 32, centred, before the
  ImageNet normalisation, and the map cropped back;
* a neighbour rotation whose axis is not finite is the identity (the NaN
  and inf axes are zeroed); a denominator below 1e-8 in magnitude keeps
  its sign at 1e-8;
* float32 throughout: the published code leaves cuDNN's TF32 at
  PyTorch's default.

`predict(arrays, rgb_u8, K)` has the contract of the program's
`predict_normals` and returns the last stage's (H, W, 3) map;
`forward(arrays, img, K)` returns every stage; `flops(h, w)` counts the
work of one padded frame at the published widths.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# geffnet's EfficientNet base: (block, repeats, kernel, stride, expansion,
# channels) per stage, every stage with squeeze-excitation 0.25; stem 32,
# head 1280. tf_efficientnet_b5: channels x1.6, depth x2.2.
BASE_STAGES = (("ds", 1, 3, 1, 1, 16), ("ir", 2, 3, 2, 6, 24),
               ("ir", 2, 5, 2, 6, 40), ("ir", 3, 3, 2, 6, 80),
               ("ir", 3, 5, 1, 6, 112), ("ir", 4, 5, 2, 6, 192),
               ("ir", 1, 3, 1, 6, 320))
BASE_STEM, BASE_HEAD = 32, 1280
WIDTH_MULT, DEPTH_MULT = 1.6, 2.2
SE_RATIO = 0.25
BN_EPS = 1e-3
GN_GROUPS, GN_EPS = 8, 1e-5
WS_EPS = 1e-5
RAY_RELU_EPS = 1e-2
PATCH = 5
NUM_ITER = 5
UP = 8
# The published decoder and refinement widths.
PUBLISHED = {"nf": 2048, "feature_dim": 64, "hidden_dim": 64,
             "head_hidden": 128, "nrn_hidden": 64}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
ENC = "encoder.original_model."


def round_channels(c: float, divisor: int = 8) -> int:
    """geffnet's `round_channels`: to the nearest multiple of 8, never
    below 90% of `c`."""
    out = max(divisor, int(c + divisor / 2) // divisor * divisor)
    return out + divisor if out < 0.9 * c else out


def b5_stages() -> List[Tuple[str, int, int, int, int, int]]:
    """(block, repeats, kernel, stride, expansion, channels) of the B5."""
    return [(b, int(math.ceil(r * DEPTH_MULT)), k, s, e,
             round_channels(c * WIDTH_MULT))
            for b, r, k, s, e, c in BASE_STAGES]


@contextlib.contextmanager
def tf32(allow: bool):
    """cuDNN's and cuBLAS's TF32 set to `allow` for the block, restored
    after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _silu(x):
    return x * torch.sigmoid(x)


def _same_conv(x, w, stride=1, groups=1):
    """A convolution with TensorFlow's SAME padding: the output has
    ceil(n / stride) rows and columns, the padding split with the odd
    one after."""
    k = w.shape[-1]
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w, None, stride, 0, 1, groups)


def _bn(p, name, x):
    """BatchNorm in inference, unfolded."""
    def v(leaf):
        return p[f"{name}.{leaf}"][None, :, None, None]

    return ((x - v("running_mean")) / torch.sqrt(v("running_var") + BN_EPS)
            * v("weight") + v("bias"))


def _se(p, name, x):
    s = x.mean(dim=(2, 3), keepdim=True)
    s = _silu(F.conv2d(s, p[f"{name}.conv_reduce.weight"],
                       p[f"{name}.conv_reduce.bias"]))
    s = F.conv2d(s, p[f"{name}.conv_expand.weight"],
                 p[f"{name}.conv_expand.bias"])
    return x * torch.sigmoid(s)


def encoder(p, img) -> List[torch.Tensor]:
    """The B5's five taps DSINE reads: blocks 0, 1, 2 and 4, and the 1x1
    head (without its norm), NCHW."""
    x = _silu(_bn(p, ENC + "bn1",
                  _same_conv(img, p[ENC + "conv_stem.weight"], 2)))
    cin, outs = round_channels(BASE_STEM * WIDTH_MULT), []
    for si, (kind, reps, _, stride, _, cout) in enumerate(b5_stages()):
        for bi in range(reps):
            n = f"{ENC}blocks.{si}.{bi}"
            s = stride if bi == 0 else 1
            if kind == "ds":
                h = _silu(_bn(p, n + ".bn1", _same_conv(
                    x, p[n + ".conv_dw.weight"], s, groups=cin)))
                h = _bn(p, n + ".bn2", F.conv2d(_se(p, n + ".se", h),
                                                p[n + ".conv_pw.weight"]))
            else:
                h = _silu(_bn(p, n + ".bn1",
                              F.conv2d(x, p[n + ".conv_pw.weight"])))
                h = _silu(_bn(p, n + ".bn2", _same_conv(
                    h, p[n + ".conv_dw.weight"], s, groups=h.shape[1])))
                h = _bn(p, n + ".bn3", F.conv2d(_se(p, n + ".se", h),
                                                p[n + ".conv_pwl.weight"]))
            x = x + h if (s == 1 and cin == cout) else h
            cin = cout
        outs.append(x)
    head = F.conv2d(x, p[ENC + "conv_head.weight"])
    return [outs[0], outs[1], outs[2], outs[4], head]


def _ws_conv(p, name, x):
    """A weight-standardised 3x3 convolution: each output channel's weights
    less their mean, over their unbiased std plus 1e-5."""
    w = p[name + ".weight"]
    flat = w.reshape(w.shape[0], -1)
    std = torch.sqrt(torch.var(flat, dim=1, unbiased=True))
    ws = (flat - flat.mean(dim=1, keepdim=True)) / (std[:, None] + WS_EPS)
    return F.conv2d(x, ws.reshape(w.shape), p[name + ".bias"], 1, 1)


def _group_norm(p, name, x):
    b, c, h, w = x.shape
    g = x.reshape(b, GN_GROUPS, -1)
    mean = g.mean(dim=2, keepdim=True)
    var = ((g - mean) ** 2).mean(dim=2, keepdim=True)
    x = ((g - mean) / torch.sqrt(var + GN_EPS)).reshape(b, c, h, w)
    return (x * p[name + ".weight"][None, :, None, None]
            + p[name + ".bias"][None, :, None, None])


def _leaky(x):
    return torch.where(x >= 0, x, 0.01 * x)


def _up_block(p, name, x, skip):
    x = F.interpolate(x, size=skip.shape[2:], mode="bilinear",
                      align_corners=False)
    x = torch.cat([x, skip], 1)
    for conv, norm in (("0", "1"), ("3", "4")):
        x = _leaky(_group_norm(p, f"{name}._net.{norm}",
                               _ws_conv(p, f"{name}._net.{conv}", x)))
    return x


def _head(p, name, x):
    """conv3x3 + ReLU, conv1x1 + ReLU, conv1x1."""
    x = F.relu(F.conv2d(x, p[name + ".0.weight"], p[name + ".0.bias"], 1, 1))
    x = F.relu(F.conv2d(x, p[name + ".2.weight"], p[name + ".2.bias"]))
    return F.conv2d(x, p[name + ".4.weight"], p[name + ".4.bias"])


def _unfold(x, k):
    """(B, C, H, W) -> (B, C, k*k, H, W): each pixel's k x k neighbourhood
    over a replicate pad, row by row."""
    b, c, h, w = x.shape
    r = k // 2
    cols = F.unfold(F.pad(x, (r, r, r, r), mode="replicate"), k)
    return cols.reshape(b, c, k * k, h, w)


def _rays(K, h, w, full_h, full_w, dtype, device):
    """Rays through the pixel centres of an (h, w) grid, the intrinsics
    scaled from the (full_h, full_w) frame: (uv (1, 2, h, w), unit ray
    (1, 3, h, w)), and the pixel centres (1, 2, h, w)."""
    sx, sy = w / full_w, h / full_h
    fx, cx = K[0][0] * sx, K[0][2] * sx
    fy, cy = K[1][1] * sy, K[1][2] * sy
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=device) + 0.5,
        torch.arange(w, dtype=torch.float64, device=device) + 0.5,
        indexing="ij")
    uv = torch.stack([(xs - cx) / fx, (ys - cy) / fy])[None]
    ray = torch.cat([uv, torch.ones_like(uv[:, :1])], 1)
    pix = torch.stack([xs, ys])[None]
    return (uv.to(dtype), F.normalize(ray, dim=1).to(dtype), pix.to(dtype))


def _ray_relu(n, ray):
    """The component of a normal along the viewing ray floored at eps of
    its cosine, the result renormalised."""
    cos = F.cosine_similarity(n, ray, dim=1, eps=1e-8).unsqueeze(1)
    floor = ray * (F.relu(cos - RAY_RELU_EPS) + RAY_RELU_EPS)
    return F.normalize(n + floor - ray * cos, dim=1)


def _rotate(v, n):
    """Rodrigues' rotation of the vectors `n` by the rotation vectors `v`
    (both (..., 3, ...) along dim 1): n cos t + (v x n) sin t / t
    + v (v . n) (1 - cos t) / t^2, with t = |v|; below t = 1e-3 the two
    ratios by their series, 1 - t^2 / 6 and 1 / 2 - t^2 / 24."""
    t2 = (v * v).sum(1, keepdim=True)
    t = torch.sqrt(t2)
    small = t < 1e-3
    safe = torch.where(small, torch.ones_like(t), t)
    sinc = torch.where(small, 1 - t2 / 6, torch.sin(safe) / safe)
    versc = torch.where(small, 0.5 - t2 / 24,
                        2 * torch.sin(safe / 2) ** 2 / (safe * safe))
    cross = torch.linalg.cross(v, n, dim=1)
    dot = (v * n).sum(1, keepdim=True)
    return n * torch.cos(t) + cross * sinc + v * dot * versc


def _convex_up(x, mask, k):
    """Each of the k x k output pixels of a coarse pixel a softmax-weighted
    sum of its 3 x 3 replicate-padded neighbourhood."""
    b, c, h, w = x.shape
    wts = torch.softmax(mask.reshape(b, 9, k * k, h * w), dim=1)
    nb = F.unfold(F.pad(x, (1, 1, 1, 1), mode="replicate"), 3)
    up = torch.einsum("bcnp,bnsp->bcsp", nb.reshape(b, c, 9, h * w), wts)
    up = up.reshape(b, c, k, k, h, w).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(b, c, h * k, w * k)


def _gru(p, h, x):
    def conv(name, t):
        return F.conv2d(t, p[f"gru.{name}.weight"], p[f"gru.{name}.bias"],
                        1, 2)

    hx = torch.cat([h, x], 1)
    z = torch.sigmoid(conv("convz", hx))
    r = torch.sigmoid(conv("convr", hx))
    q = torch.tanh(conv("convq", torch.cat([r * h, x], 1)))
    return (1 - z) * h + z * q


def _refine(p, h, feat, n, K, full_h, full_w, uv, ray, pix):
    """One neighbourhood-rotation iteration at 1/8: the hidden state, the
    coarse map and its x8 upsample."""
    _, _, hh, ww = n.shape
    fx, cx = K[0][0] * ww / full_w, K[0][2] * ww / full_w
    fy, cy = K[1][1] * hh / full_h, K[1][2] * hh / full_h
    h = _gru(p, h, feat)
    huv = torch.cat([h, uv], 1)
    prob = torch.sigmoid(_head(p, "prob_head", huv))[:, None]
    xy = _head(p, "xy_head", huv)
    dxy = F.normalize(torch.stack([xy[:, :PATCH ** 2], xy[:, PATCH ** 2:]],
                                  1), dim=1)  # (B, 2, 25, h, w)
    angle = torch.sigmoid(_head(p, "angle_head", huv))[:, None] * math.pi
    nb = _unfold(n, PATCH)  # (B, 3, 25, h, w)
    nb_pix = _unfold(pix, PATCH)  # (1, 2, 25, h, w)
    # the axis: the neighbour's offset in the image plane, lifted onto the
    # neighbour's tangent plane through the camera rays
    du, dv = dxy[:, 0] / fx, dxy[:, 1] / fy
    tu = (nb_pix[:, 0] + dxy[:, 0] - cx) / fx
    tv = (nb_pix[:, 1] + dxy[:, 1] - cy) / fy
    den = tu * nb[:, 0] + tv * nb[:, 1] + nb[:, 2]
    den = torch.where(den.abs() < 1e-8, 1e-8 * torch.sign(den), den)
    dz = -(du * nb[:, 0] + dv * nb[:, 1]) / den
    axis = F.normalize(torch.stack([du + dz * tu, dv + dz * tv, dz], 1),
                       dim=1)
    axis = torch.where(torch.isfinite(axis).all(1, keepdim=True), axis,
                       torch.zeros_like(axis))
    rot = F.normalize(_rotate(axis * angle, nb), dim=1)
    rot = _ray_relu(rot, ray[:, :, None])
    n = F.normalize((prob * rot).sum(2), dim=1)
    up = F.normalize(_convex_up(n, _head(p, "up_prob_head", huv), UP),
                     dim=1)
    return h, n, up


def forward(arrays: Dict, img: torch.Tensor, K,
            num_iter: int = NUM_ITER) -> Dict:
    """The network on an ImageNet-normalised (1, 3, H, W) image, H and W
    multiples of 32, and its (3, 3) pixel intrinsics (top-left (0, 0)):
    {"taps": the encoder's five, "decoder": (normal, feature, hidden),
    "maps": the 1 + num_iter normal maps, (1, 3, H, W) each}. `arrays`
    are converted to `img`'s device and dtype."""
    p = {k: torch.as_tensor(v).to(img.device, img.dtype)
         for k, v in arrays.items()}
    K = [[float(K[i][j]) for j in range(3)] for i in range(3)]
    K[0][2] += 0.5
    K[1][2] += 0.5
    _, _, H, W = img.shape
    taps = encoder(p, img)
    uv32, _, _ = _rays(K, H // 32, W // 32, H, W, img.dtype, img.device)
    uv16, _, _ = _rays(K, H // 16, W // 16, H, W, img.dtype, img.device)
    uv8, ray8, pix8 = _rays(K, H // 8, W // 8, H, W, img.dtype, img.device)
    x = F.conv2d(torch.cat([taps[4], uv32], 1), p["decoder.conv2.weight"],
                 p["decoder.conv2.bias"])
    x = _up_block(p, "decoder.up1", x, torch.cat([taps[3], uv16], 1))
    x = _up_block(p, "decoder.up2", x, torch.cat([taps[2], uv8], 1))
    x = torch.cat([x, uv8], 1)
    normal = F.normalize(_head(p, "decoder.normal_head", x), dim=1)
    feat = _head(p, "decoder.feature_head", x)
    hidden = _head(p, "decoder.hidden_head", x)
    n = _ray_relu(normal, ray8)
    feat_uv = torch.cat([feat, uv8], 1)
    maps = [F.normalize(_convex_up(
        n, _head(p, "up_prob_head", torch.cat([hidden, uv8], 1)), UP),
        dim=1)]
    h = hidden
    for _ in range(num_iter):
        h, n, up = _refine(p, h, feat_uv, n, K, H, W, uv8, ray8, pix8)
        maps.append(up)
    return {"taps": taps, "decoder": (normal, feat, hidden), "maps": maps}


def pad_to_32(h: int, w: int) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) zero padding to the next multiples of
    32, centred, the odd row or column after."""
    ph, pw = -h % 32, -w % 32
    return ph // 2, ph - ph // 2, pw // 2, pw - pw // 2


def default_K(h: int, w: int) -> np.ndarray:
    """The program's intrinsics without a K: a 60 degree field of view
    over the longer side, the principal point at the centre."""
    f = (max(h, w) / 2.0) / math.tan(math.radians(30.0))
    return np.array([[f, 0, w / 2.0 - 0.5], [0, f, h / 2.0 - 0.5],
                     [0, 0, 1]])


def predict(arrays: Dict, rgb_u8: np.ndarray, K: Optional[np.ndarray] = None,
            dtype: torch.dtype = torch.float32, allow_tf32: bool = False
            ) -> np.ndarray:
    """uint8 (H, W, 3) -> the last stage's (H, W, 3) float32 unit normals,
    on the device of `arrays` (torch tensors) or the CPU (numpy)."""
    first = next(iter(arrays.values()))
    dev = first.device if isinstance(first, torch.Tensor) else "cpu"
    h, w = rgb_u8.shape[:2]
    top, bottom, left, right = pad_to_32(h, w)
    x = torch.as_tensor(rgb_u8, device=dev).permute(2, 0, 1)[None]
    x = F.pad(x.to(torch.float32) / 255.0, (left, right, top, bottom))
    mean = torch.tensor(IMAGENET_MEAN, device=dev)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=dev)[None, :, None, None]
    x = ((x - mean) / std).to(dtype)
    K = np.array(default_K(h, w) if K is None else K, np.float64)
    K[0, 2] += left
    K[1, 2] += top
    with torch.no_grad(), tf32(allow_tf32):
        out = forward(arrays, x, K)["maps"][-1]
    out = out[0, :, top:top + h, left:left + w].permute(1, 2, 0)
    return out.to(torch.float32).cpu().numpy()


def flops(h: int, w: int) -> float:
    """Two times the multiply-adds of every convolution and product of one
    frame padded from (h, w) to multiples of 32, at the published widths:
    the B5 (stem, 39 blocks with squeeze-excitation, head), the decoder's
    bottleneck, two blocks and three heads, the up-mask head of the first
    stage, and each of `NUM_ITER` iterations' ConvGRU, four heads,
    Rodrigues' rotation (its cross product and dot, 9 a neighbour), the
    probability-weighted sum over 25 neighbours and the convex upsample
    (9 a channel and output pixel)."""
    H, W = h + sum(pad_to_32(h, w)[:2]), w + sum(pad_to_32(h, w)[2:])
    tot = 0

    def conv(cin, cout, k, ho, wo, groups=1):
        nonlocal tot
        tot += 2 * cout * (cin // groups) * k * k * ho * wo

    ho, wo = -(-H // 2), -(-W // 2)
    cin = round_channels(BASE_STEM * WIDTH_MULT)
    conv(3, cin, 3, ho, wo)
    for kind, reps, k, stride, e, cout in b5_stages():
        for bi in range(reps):
            s = stride if bi == 0 else 1
            cmid = cin if kind == "ds" else cin * e
            if kind == "ir":
                conv(cin, cmid, 1, ho, wo)
            ho, wo = -(-ho // s), -(-wo // s)
            conv(cmid, cmid, k, ho, wo, groups=cmid)
            red = max(1, int(cin * SE_RATIO))
            conv(cmid, red, 1, 1, 1)
            conv(red, cmid, 1, 1, 1)
            conv(cmid, cout, 1, ho, wo)
            cin = cout
    head = round_channels(BASE_HEAD * WIDTH_MULT)
    conv(cin, head, 1, ho, wo)
    nf, fd, hd = PUBLISHED["nf"], PUBLISHED["feature_dim"], \
        PUBLISHED["hidden_dim"]
    hh, hw = H // 8, W // 8
    taps = [c for _, _, _, _, _, c in b5_stages()]
    conv(head + 2, nf, 1, H // 32, W // 32)
    conv(nf + taps[4] + 2, nf // 2, 3, H // 16, W // 16)
    conv(nf // 2, nf // 2, 3, H // 16, W // 16)
    conv(nf // 2 + taps[2] + 2, nf // 4, 3, hh, hw)
    conv(nf // 4, nf // 4, 3, hh, hw)

    def head3(cin_, hidden, cout_):
        conv(cin_, hidden, 3, hh, hw)
        conv(hidden, hidden, 1, hh, hw)
        conv(hidden, cout_, 1, hh, hw)

    for cout_ in (3, fd, hd):
        head3(nf // 4 + 2, PUBLISHED["head_hidden"], cout_)
    nrn = PUBLISHED["nrn_hidden"]
    nb, px = PATCH * PATCH, hh * hw
    head3(hd + 2, nrn, 9 * UP * UP)  # the first stage's up mask
    tot += 2 * 3 * 9 * UP * UP * px  # its convex upsample
    for _ in range(NUM_ITER):
        for _ in range(3):
            conv(hd + fd + 2, hd, 5, hh, hw)
        for cout_ in (nb, 2 * nb, nb, 9 * UP * UP):
            head3(hd + 2, nrn, cout_)
        tot += 2 * 9 * nb * px  # Rodrigues: cross product and dot
        tot += 2 * 3 * nb * px  # the probability-weighted sum
        tot += 2 * 3 * 9 * UP * UP * px  # the convex upsample
    return float(tot)
