"""The work a frame or a training step needs, and the chip's peaks.

Counts come from the benchmark's own reference (its binning and its
compositing, `reference.rasterize(..., stats=True)`), never from the
program, so a roofline reads the same work whatever implements a kernel.
Each input byte is counted read once and each output byte written once.

Peaks: NVIDIA H100 SXM5 80 GB data sheet, dense, at the 700 W limit:
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores. The
rasterizer's arithmetic is float32 outside the tensor cores, so that is
the peak its shares are taken against.
"""

from __future__ import annotations

from typing import Dict

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

N_FEATS = 7  # composited channels: rgb, camera normal, depth
# forward_tiles per (pixel, pair) visit: offsets, the conic quadratic, the
# opacity product, the clamp and the four tests (~20 float32 operations),
# plus one exp on the special-function units, which run at 1/8 of the
# float32 rate.
FWD_OPS_PER_VISIT = 20 + 8
# backward_tiles per composited (pixel, pair): the reciprocal (8), the
# transmittance, weight and suffix-sum updates, g_alpha, g_sigma and the
# six geometry products (~37); per channel 4 more; one add per field for
# the sum over the tile's pixels.
BWD_OPS_PER_HIT = 45
# Per Gaussian and camera, forward: quaternion to rotation (~30), the 3D
# covariance and its rotation into the camera (~110), the Jacobian and
# the 2D covariance with its inverse (~40), SH degree 3 (16 bases, ~40 for
# the basis and 96 for the products) and the normal (~30). The backward of
# that graph costs about twice the forward.
GAUSS_FWD_OPS = 30 + 110 + 40 + 136 + 30
GAUSS_BWD_OPS = 2 * GAUSS_FWD_OPS
# Per pixel, forward: SSIM's five separable 11-tap blurs of 3 channels
# (5 * 3 * 22 * 2) and its ratio (~20 x 3), L1 (3 x 2), the edge-aware
# log-L1 depth term (~20), the normal L1 and TV (~20) and the image
# finishing (~20); the backward about twice that.
PIXEL_LOSS_FWD_OPS = 660 + 60 + 6 + 20 + 20 + 20
PIXEL_LOSS_BWD_OPS = 2 * PIXEL_LOSS_FWD_OPS
# Adam per parameter element: two moments (5), bias corrections, sqrt,
# divide and update (~7), the alive mask (1).
ADAM_OPS_PER_ELEM = 13
PARAMS_PER_GAUSSIAN = 3 + 3 + 4 + 3 + 45 + 1 + 3


def forward_tiles(w: Dict, n_tiles: int, tile_px: int = 256) -> Dict:
    """forward_tiles' least work: every pixel evaluates its list up to the
    Gaussian that ends it (`fwd_visits`), composites `accepted` pairs, and
    a tile reads the pairs up to its deepest pixel's need (`fwd_needed`)."""
    ops = w["fwd_visits"] * FWD_OPS_PER_VISIT + w["accepted"] * 2 * N_FEATS
    nbytes = (w["fwd_needed"] * (6 + N_FEATS) * 4 + (2 * n_tiles + 1) * 4
              + n_tiles * tile_px * (N_FEATS + 2) * 4)
    return {"ops": ops, "bytes": nbytes}


def backward_tiles(w: Dict, n_tiles: int, tile_px: int = 256) -> Dict:
    """backward_tiles' least work: every pixel replays its list up to its
    last composited pair (`bwd_visits`) and does the gradient arithmetic
    for the composited ones; a tile reads, and writes gradient words for,
    its pairs up to its deepest contributor (`bwd_replayed`)."""
    ops = (w["bwd_visits"] * FWD_OPS_PER_VISIT
           + w["accepted"] * (BWD_OPS_PER_HIT + 4 * N_FEATS + 6 + N_FEATS))
    ru = (6 + N_FEATS + 1) // 2
    nbytes = (w["bwd_replayed"] * (6 + N_FEATS + ru) * 4
              + (2 * n_tiles + 1) * 4
              + n_tiles * tile_px * (N_FEATS + 3) * 4)
    return {"ops": ops, "bytes": nbytes}


def least_s(work: Dict) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(work["ops"] / FP32_OPS_PER_S,
               work["bytes"] / HBM_BYTES_PER_S)


def frame_ops(w: Dict, n_gauss: int) -> float:
    """Float32 operations of one served frame."""
    return forward_tiles(w, 1)["ops"] + n_gauss * GAUSS_FWD_OPS


def step_ops(w: Dict, n_gauss: int, pixels: int) -> float:
    """Float32 operations of one training step."""
    return (forward_tiles(w, 1)["ops"] + backward_tiles(w, 1)["ops"]
            + n_gauss * (GAUSS_FWD_OPS + GAUSS_BWD_OPS)
            + pixels * (PIXEL_LOSS_FWD_OPS + PIXEL_LOSS_BWD_OPS)
            + n_gauss * PARAMS_PER_GAUSSIAN * ADAM_OPS_PER_ELEM)
