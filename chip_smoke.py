#!/usr/bin/env python3
"""Serve and train scenes with dnsplatter_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Prints the card's name and power limit, builds every CUDA kernel of
   `dnsplatter_torch/csrc` with nvcc (one process per source, in
   parallel) and prints the build time.
2. Serving, for two synthetic scenes at 1024x576, SH degree 3, seven
   composited channels: 100k Gaussians (pair capacity 1,441,792: the
   resident `expand_segments` entry) and 1M Gaussians (scale shift
   -ln(10)/3, extent 1.5, capacity 5,242,880: the streamed entry). Each
   scene's perturbed Gaussians go through a checkpoint in the JAX
   package's npz format, `load_checkpoint_arrays` and `evaluate` over four
   ring cameras, with every launch counter set to 0 just before and read
   just after. Metrics must be finite, LPIPS among them (the seeded random
   VGG, `lpips_kind` "random-vgg(relative-only)", where no weights file is
   found), every camera's pair list must fit the capacity, and each kernel
   of the path must have launched once per rendered frame. The 100k scene
   is rendered once more with `exact_cull`: the same image within 1e-5
   from fewer listed pairs.
3. Serving a scene of 2^24 = 16,777,216 Gaussians built on the card
   (extent 6, scale shift -1, so that most lie outside any frustum; pair
   capacity 12,582,912): `evaluate` over two ring cameras under
   `sort_scheme="auto"`, which resolves to `tilekey` there, with the
   per-pair binning rows built by `cumsum_lanes_i32` (once a frame). Every
   tile's list must run front to back.
4. Training, through `Trainer(...).train` at the Trainer's defaults
   (depthq keys, the bf16-packed gradient reduction by key with
   compaction, audited pair capacity, state capacity 1.25 x the seeds):
   targets (rgb, sensor depth, normals) rendered by the port from each
   scene's ground truth, seed points perturbed from its means, depth and
   normal losses on, SH degree 3 from step 3. 1M seeds: 3 warm-up steps,
   then 20 timed steps with the launch counters set to 0 just before and
   read just after; every loss and parameter finite, the mean loss of the
   last four steps below that of the first four timed ones (each round of
   four visits every camera), the audited pair capacity holding every
   camera, all four kernels launched once a step. 100k seeds: 60 steps
   with a refinement cadence short enough to hold densify-and-cull events
   and an opacity reset; the alive count must change.
5. Training under the three other gradient reductions, each counted the
   same way (its kernel once a step) and each with the gradients of one
   frame held against the reduction by key on that frame (rtol 2e-2 / atol
   2e-3 of each array's largest magnitude; D, which rounds nothing to
   bf16 while the reduction by key does, atol 5e-3):
   B. `Trainer(..., TrainConfig(sort_scheme="auto", compact_frac=0.0))` on
      the 1M scene: `packed32` keys, the whole slab sorted by id,
      `reduce_segments_packed`;
   C. `train_step` on that Trainer's state with `reduce_pieces=4`:
      `reduce_segments_packed_multi`;
   D. `train_step` on the 100k Trainer's state with `packed` keys and
      `grad_reduce="segsum"`: the float32 slab, `reduce_segments`.
6. Each kernel against its plain PyTorch version, on the card, at the
   inputs the main path gives it (serving: camera 0; training: one more
   step after the timed ones, the cotangents those of the real loss;
   expand_segments and forward_tiles both in serving and in that training
   step, where the expansion covers the audited pair capacity):
   expand_segments bit-equal with int32 and float32 rows; forward_tiles
   image / t_final within 1e-4 (image: of its max) on every pixel whose
   `last` agrees (see `compare_forward`); backward_tiles decoded within
   2^-7 relative plus 1e-4 of the field's largest value, at most 0.1% of
   elements beyond one bf16 ulp, integer zeros where the plain version
   has them, two runs bit-equal (see `compare_backward`); the four
   reductions rtol 1e-5 / atol 1e-5 of the row's scale, exact zeros for
   Gaussians without pairs, two runs bit-equal (`reduce_segments_bykey`
   and `reduce_segments` own a block of ids a CTA and add by a segmented
   scan in a fixed tree order, the packed two walk each range in lane
   order); cumsum_lanes_i32 (one pass over 12,288-lane tiles with
   decoupled look-back) bit-equal to the plain version and between two
   runs, timed beside torch.cumsum along dim 1 (`library_ms`) and one
   1-D torch.cumsum a row (`library_rowwise_ms`, a library device scan).
   The SH colour pair (`sh_colors`, `sh_colors_backward`) at the benchmark
   configurations' state capacities, 1,253,376 and 3,751,936 rows, degree
   3: colours and the three gradients through autograd against the plain
   version (`eval_sh` on the concatenated coefficients) within 1e-5 of each
   array's largest magnitude, 1e-4 for the direction's gradient (see
   `check_sh_colors`); in phase 4 each trained step launches the backward
   once and the forward at least once. The screen-space pair
   (`project_screen`, `project_screen_backward`) at the same row counts, the
   benchmark configurations' frames: radii, radii_xy and valid equal to the
   plain version, the other outputs within 1e-6 and the five gradients
   through autograd within 1e-5 of each array's largest magnitude (see
   `check_project_screen`); in phase 4 each trained step launches its
   backward once and its forward at least once. The SSIM pair (`ssim`,
   `ssim_backward`) at the benchmark configurations' frames, 1024x576 and
   1600x1200: the per-pixel map bit-equal to `losses.ssim_map_plain`, the
   mean within 1e-6 of `ssim_plain`'s, d img1 through autograd within 1e-5
   of its largest magnitude, two runs bit for bit (see `check_ssim`); in
   phase 4 each trained step launches its backward once and its forward at
   least once. Times: device time per call, from a batch of calls queued back to back
   behind a spin kernel between one pair of CUDA events (median of three
   batches), so the host's per-call cost is not in it. The bound is the
   larger of the bytes the function must move / 3.35 TB/s and its FP32
   work / 67 TFLOP/s (H100 SXM data sheet), counted on this run's data.
7. The kernel path against the port's dense oracle on small scenes: the
   forward, and the gradients of the autograd function (rtol 2e-2 / atol
   2e-3 of each array's largest magnitude) under depthq and packed keys;
   under `segsum`, which rounds nothing to bf16, rtol 1e-4 / atol 1e-5.
8. File-backed MuSHRoom: twelve ring views of the 1M scene, rendered by
   the port at 1024x576 and written as a MuSHRoom iphone capture (images,
   16-bit depth, transformations.json; ten in the long capture with a
   test.txt naming two, two in the short one; no normals, masks or seed
   cloud). `get_parser("mushroom")` at the parser's defaults (1,000,000
   seed points) with confidence masks and both protocols parses the train
   and test splits, making the normals, the consistency masks and the seed
   cloud. `Trainer` on the train split with depth and normal losses: 3
   warm-up steps, then 10 timed ones with the counters set to 0 just before
   and read just after, the four kernels of the step once each a step.
   `evaluate` of the test split with the default LPIPS, point clouds from
   the rendered depths against the seed cloud with ICP, and the with /
   within protocols, counted the same way (the expansion and forward_tiles
   once a frame plus one warm-up); every metric finite, `within_*`,
   `with_*` and `pd_*` present. LPIPS of one frame on the card against the
   same module on the CPU within 1e-4 relative. Its JSON line carries the
   parse, frame-load and ICP seconds, the step times, the eval time per
   frame with LPIPS and with a stub in its place, and the pair capacity.

9. The CLI and the mesh chain, on phase 8's capture, through the command
   functions of `dnsplatter_torch.cli` called in-process: `train
   dn-splatter mushroom` for 13 steps at the parser's defaults (1,000,000
   seeds) with depth and normal losses and TensorBoard on (a `ckpt_*.npz`,
   finite losses read back from `tb/`, the four step kernels once a
   step); `eval` of the val split with both protocols at the audited pair
   capacity (`metrics.json` finite, the expansion and `forward_tiles`
   once a frame plus one warm-up); `export` in all seven modes at that
   capacity, every export frame's pair list checked to fit (`tsdf` and
   `o3dtsdf` sparse at 1 cm, `dn` with FFT Poisson at 192 and its TSDF,
   `gaussians` with CG Poisson at 256, `sugar-coarse`, `isofusion` on the
   adaptive octree, `marching` at 128 and level 0.1; every marching
   native), each mesh's vertices finite and its faces indexing them, the
   renders' launches exact, the seconds split into named host work (KD-trees, brick
   hashing and extraction, marching, clustering, smoothing, the octree)
   and the rest; then a reference mesh fused from the capture's own depth
   frames in the parser's frame by `mesh/tsdf.py` (the route of
   `tsdf_fused_cloud`, which runs too, in the capture's frame),
   the `tsdf`, `dn` and `isofusion` meshes scored by `evaluate_mesh`
   and the `dn` mesh by `evaluate_mesh_mushroom`, every metric finite.

10. Monocular priors on the same capture, with phase 9's checkpoint and
   reference mesh (written as a PLY): DPT-Hybrid (`DPTHybridConfig(
   out_channels=3)`), DSINE with B5 and ZoeDepth-NYU (`ZoeDepthNYUConfig()`)
   at their published widths with seeded weights (N(0, 0.02) products,
   zero biases), each profiled on the card at the scripts' shapes (median
   of five forwards between CUDA events, FLOPs of its products and
   convolutions by torch.utils.flop_counter, the bound at 67 TFLOP/s
   float32, peak memory) and written as an npz; then, through the
   scripts' `main`, `normals_from_pretrain` (omnidata into
   normals_from_pretrain/, `--hd` and `--model-type dsine` into folders of
   their own), `depth_from_pretrain` with the sensor depths and
   `align_depth` over the long capture's ten frames: every map finite at
   1024x576, the HD and DSINE normals unit within 1e-3, the omnidata maps
   in [0, 1], the depths in [min_depth, max_depth]. Each network at a
   narrow width with the same weights on the card and on the CPU (within
   1e-4 of the output's largest magnitude; twice on the card, the spread
   reported). The capture re-parsed (normals from normals_from_pretrain/)
   and trained on with depth and normal losses, 3 + 5 counted steps, the
   four step kernels once a step. `cli render` of phase 9's checkpoint at
   its audited pair capacity (the expansion and forward_tiles once a frame
   plus one warm-up), its tree and depth colormaps checked, `vis_errors`
   and `compare_normals` on it; `render_gt_normals` and
   `render_faro_depth` of the reference mesh along the train cameras, and
   `compare_normals` between the priors and those normals. One JSON line
   per network.

11. The baseline methods, the live viewer and batch runs, on the same
   capture. `cli train gnerfacto|gdepthfacto|gneusfacto mushroom` at the
   methods' own widths (nerfacto: 1024 rays, 64 + 64 samples, 12 levels
   of 2^17 x 2, hidden 64; NeuS: 512 rays, 96 samples, 10 levels), 30
   steps each with the seed cloud off (the baselines read none): ms a step
   (host clock ended by the loss's read-back; median and min), steps/s,
   peak memory, the losses (all finite; the nerfacto variants' last five
   below their first five), one step under `utils/profiling.trace` (its
   kernels, launch calls and device ms; a trace file written), the
   checkpoint reloaded by `load_baseline` equal to the trained module and
   the history read back, no rasterizer kernel launched. Each method's
   step on the card against the CPU from the same weights, pixel draws and
   sample distances: loss within 1e-5 relative, each parameter's gradient
   within 1e-3 in relative L2. A Trainer with `TrainConfig(viewer=True,
   viewer_port=0)` on the capture at the parser's defaults takes 5 steps
   while a client thread fetches /render.png at three poses and three
   scales (nine distinct renders) and /stats.json; then /, /rgb.png and
   /depth.png: HTTP 200 (a 503 fails the phase), PNGs of the expected
   sizes, the counters set to 0 just before the steps and read after:
   forward_tiles and the expansion once a step, once for the eval image
   and once an orbit render, the other step kernels once a step; the
   orbit frames' pair counts against the render's capacity and the JAX
   package's 2^20. `dispatch_jobs` over two copies of the capture on one
   device slot (`dn-splatter`, 2 steps, 20,000 seeds): every job 0, both
   on slot 0, one after the other.

12. Multi-device training on torch.distributed (`dnsplatter_torch/
   parallel/`), in two parts. 12a, right after phase 4's 1m training, in
   the script's process: a process group of one under NCCL, and from the
   1m Trainer's state one step each through `train_step`,
   `make_dp_train_step` (dp 1), `make_sharded_train_step` and
   `make_tile_train_step` (one shard), black background, each after one
   warm-up step on a copy: loss, parameters and statistics against
   `train_step` within 1e-6 of each array's largest magnitude (expected
   bit-equal), the four step kernels once each, ms a step and the
   collective log's calls and bytes; the group is destroyed after. 12b,
   after phase 11: two ranks of this script (`--parallel-rank`) on the one
   card over gloo (NCCL refuses two ranks on one card), on the train 100k
   inputs: 3 steps each of the dp step (dp 2, frames 2s and 2s + 1), the
   gspmd and the tile step (two shards), the last state held against
   single-device references computed here first (3 `train_step`s; 3 Adam
   steps on the two frames' averaged gradients): losses within 1e-5,
   every array within 1e-3 of its largest magnitude on all but 0.01% of
   its elements and within 2e-2 on all; then a 2-rank
   `Trainer(TrainConfig(devices=2))` through the densify event of step
   20, its alive count equal to a single-process Trainer's and only rank 0
   writing its checkpoint. Each rank's launches join the totals. Last, `scaling_statement` of phase
   4's median 1m step at that state's capacity and frame: the multi-GPU
   projection from the accounted collective bytes and the H100 SXM5's
   fabric figures.

Prints one JSON line per kernel and scene, one per scene (the MuSHRoom
path's, the CLI's, the priors' and the baselines' among them), the
script's seconds, a `kernels` line whose launch counts sum the main paths
of phases 2-5 and 8-12, the card's name and power limit, and last
{"ok": true, "device": {...}}. Needs CUDA: without it, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
WIDTH, HEIGHT = 1024, 576
N_CAMERAS = 4
SCENES = (
    # name, Gaussians, log-scale shift, extent, pair capacity
    ("100k", 100_000, 0.0, 1.5, 1_441_792),
    ("1m", 1_000_000, -math.log(10.0) / 3.0, 1.5, 5_242_880),
)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
# forward_tiles work per (pixel, pair) visit: offsets, the conic quadratic,
# the opacity product, the clamp and the four tests (~20 FP32 ops), plus one
# exp on the special-function units, which run at 1/8 of the FP32 rate.
FWD_OPS_PER_VISIT = 20 + 8
# backward_tiles per composited (pixel, pair): the reciprocal (8), the
# transmittance, weight and suffix-sum updates, g_alpha, g_sigma and the
# six geometry products (~37); per channel 4 more (fg, g_feat); and one add
# per field for the sum over the tile's pixels.
BWD_OPS_PER_HIT = 45
FWD_TOL = 1e-4
BWD_REL = 2.0 ** -7  # one bf16 ulp at the top of a binade
BWD_ATOL = 1e-4  # x the field row's largest magnitude (cancelling sums)
BWD_ULP_FRAC = 1e-3  # share of elements that may differ by > 1 bf16 ulp
REDUCE_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-2, 2e-3
TRAIN_WARMUP = 3
TRAIN_STEPS_1M = 20
PATH_STEPS = 4  # timed steps of each other reduction: one per camera
# The 2^24 scene: Gaussians, extent, log-scale shift, pair capacity, cameras.
BIG_SCENE = (1 << 24, 6.0, -1.0, 12_582_912, 2)
BIG_PAIRS = (6_000_000, 11_000_000)  # each camera must list this many
CULL_TOL = 1e-5
SEGSUM_RTOL, SEGSUM_ATOL = 1e-4, 1e-5
# segsum against the bf16-packed reduction by key on a training frame: the
# per-pair bf16 rounding under sums that cancel reaches 1.9e-3 of an array's
# scale on the 100k scene (H100), too near the 2e-3 of GRAD_ATOL to gate on
SEGSUM_VS_BF16_ATOL = 5e-3
TRAIN_STEPS_100K = 60
# A cadence short enough that 60 steps hold densify-and-cull events (steps
# 20 and 50) and an opacity reset (step 40).
REFINE_KW = dict(warmup_length=10, refine_every=10, reset_alpha_every=3)
MAX_LAST_FLIPS = 20  # pixels per frame that may stop one splat apart
CUTOFF_REL = 1e-3  # how near 1e-4 such a pixel's transmittance must end
# The file-backed MuSHRoom capture: ring views of the 1m scene, rendered by
# the port and written in the dataset's layout (long capture, test.txt
# naming two of its frames, short capture).
MUSHROOM_LONG, MUSHROOM_SHORT, MUSHROOM_TEST = 10, 2, ("0002", "0007")
MUSHROOM_STEPS = 10
MUSHROOM_SEEDS = 1_000_000  # the parser's default, the dataset's own
LPIPS_CPU_RTOL = 1e-4
# the SH colour pair at the benchmark configurations' state capacities
SH_ROWS = (("room_1m", 1_253_376), ("big_3m", 3_751_936))
SH_TOL = 1e-5  # colours, d_features_dc, d_features_rest: x the array's max
SH_DIRS_TOL = 1e-4  # d_dirs: x the array's max (cancelling basis terms)
SH_BYTES_PER_ROW = 216 + 420  # forward + backward at degree 3, K = 16
# the screen-space pair at the benchmark configurations' capacities and
# frames (width, height, focal)
PS_ROWS = (("room_1m", 1_253_376, 1024, 576, 700.0),
           ("big_3m", 3_751_936, 1600, 1200, 1093.75))
PS_TOL = 1e-6  # the forward's values: x the array's max
PS_GRAD_TOL = 1e-5  # the five gradients: x the array's max
# forward: 60 B read, 69 B written; backward: 13 gradient words, the four
# parameter rows again, five gradient rows written
PS_BYTES_PER_ROW = (60 + 69) + (52 + 44 + 56)
# the SSIM pair at the benchmark configurations' frames (height, width)
SSIM_FRAMES = (("room_1m", 576, 1024), ("big_3m", 1200, 1600))
SSIM_MEAN_TOL = 1e-6  # the mean: relative
SSIM_GRAD_TOL = 1e-5  # d img1: x its largest magnitude
# a pixel and channel: x and y read forward; x, y read and dx written
# backward
SSIM_BYTES_PER_ELEM = 8 + 12
# FP32 operations an output pixel and channel besides the blurs: the SSIM
# from its five moments (19) and its share of the mean (1) forward; the
# SSIM again and the partials A, B and C (19 + 18) backward
SSIM_PIXEL_OPS = (20, 37)


def ssim_ops(h: int, w: int, c: int, k: int) -> int:
    """The FP32 operations of the SSIM pair at an (h, w, c) frame and a
    k-tap window, each multiply and add counted once: the products x x,
    y y, x y of every input (both ways), the two passes of the five moment
    blurs (both ways), the per-pixel terms, the two passes of the transposed
    blur of A, B, C, and dx = g / M (bA + 2 x bB + y bC) of every input."""
    oh, ow = h - k + 1, w - k + 1
    moments = 3 * h * w + 5 * 2 * k * (oh * w + oh * ow)
    fwd = moments + SSIM_PIXEL_OPS[0] * oh * ow
    bwd = (moments + SSIM_PIXEL_OPS[1] * oh * ow
           + 3 * 2 * k * (oh * w + h * w) + 6 * h * w)
    return c * (fwd + bwd)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def gpu_name_and_power() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int, batches: int = 3) -> float:
    """Device time per call of `fn`: `reps` calls queued back to back
    behind a spin kernel long enough for the host to enqueue them all, so
    the events around them time the device, not the host's per-call cost.
    Median over `batches`. A function that synchronizes inside (the plain
    versions do) includes its host time all the same."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    # spin for twice the host time of the batch at <= 2 GHz
    cycles = int(min(2e9 * 2 * reps * host_s + 1e6, 4e9))
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def compare_forward(got, want, payload, n_feats: int) -> dict:
    """Hold forward_tiles' kernel outputs `got` against the plain
    version's `want` (both (image, t_final, last)); raise on disagreement.

    Pixels whose `last` agrees: image within FWD_TOL of the image's max,
    t_final within FWD_TOL. Pixels whose `last` differs (at most
    MAX_LAST_FLIPS): the version that composited further must have ended
    with T within CUTOFF_REL of the 1e-4 cutoff, i.e. the two stopped one
    splat apart at the cutoff, and the image may differ by that splat's
    weight |dT| times the largest feature, plus FWD_TOL."""
    import torch

    img_k, t_k, last_k = got
    img_p, t_p, last_p = want
    scale = max(float(img_p.abs().max()), 1e-6)
    fmax = float(payload[6:6 + n_feats].abs().max())
    flip = last_k != last_p  # (T, 1, P)
    img_err = (img_k - img_p).abs()  # (T, F, P)
    t_err = (t_k - t_p).abs()
    n_flip = int(flip.sum())
    img_agree = float(torch.where(flip, 0.0, img_err).max())
    t_agree = float(torch.where(flip, 0.0, t_err).max())
    t_further = torch.where(last_k > last_p, t_k, t_p)
    cutoff_off = float(torch.where(
        flip, (t_further / 1e-4 - 1.0).abs(), 0.0).max())
    excess = float(torch.where(
        flip, img_err - t_err * fmax - FWD_TOL * scale, 0.0).max())
    report = {"max_abs_err": img_agree, "t_final_err": t_agree,
              "max_abs_err_all_pixels": float(img_err.max()),
              "image_max": scale, "last_flips": n_flip,
              "flip_cutoff_rel": cutoff_off, "flip_excess": excess}
    if (img_agree > FWD_TOL * scale or t_agree > FWD_TOL
            or n_flip > MAX_LAST_FLIPS or cutoff_off > CUTOFF_REL
            or excess > 0.0):
        raise AssertionError(f"forward_tiles disagrees with its plain "
                             f"version: {report}")
    return report


def _composited_chunks(payload, starts, counts, n_tiles: int, tile: int,
                       tiles_x: int, last, k: int = 128):
    """The forward's hit test over every tile's list, K in-tile indices at
    a time: yields (jj (K,), hit (T, P, K), composited (T, P, K)), where
    `hit` is the test on pairs the tile owns and `composited` the hits at
    or before the pixel's `last`."""
    import torch

    dev = payload.device
    p = tile * tile
    st = starts[:n_tiles].long()
    cnt = counts[:n_tiles].long()
    t_ids = torch.arange(n_tiles, device=dev)
    lid = torch.arange(p, device=dev)
    px = ((t_ids % tiles_x)[:, None] * tile + lid % tile).float() + 0.5
    py = ((t_ids // tiles_x)[:, None] * tile + lid // tile).float() + 0.5
    px, py = px[..., None], py[..., None]  # (T, P, 1)
    last = last.reshape(n_tiles, p, 1).long()
    jrow = torch.arange(k, device=dev)
    for c0 in range(0, int(cnt.max()) if n_tiles else 0, k):
        jj = c0 + jrow  # (K,) in-tile index
        col = (st[:, None] + jj).clamp_max(payload.shape[1] - 1)  # (T, K)
        mx, my, ca, cb, cc, op = (payload[i][col][:, None, :]
                                  for i in range(6))
        dx = px - mx
        dy = py - my
        sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        alpha = op * torch.exp(-sigma)
        hit = ((sigma >= 0.0) & (alpha >= 1.0 / 255.0)
               & (jj[None, :] < cnt[:, None])[:, None, :])
        yield jj, hit, hit & (jj <= last)


def forward_work(payload, starts, counts, n_tiles: int, tile: int,
                 tiles_x: int, last, k: int = 128):
    """The least work of forward_tiles on these inputs, per pixel as (T, P)
    tensors, from the plain version's `last`: (evaluated, composited).

    A pixel composites every hit up to `last`. The first hit past `last`,
    if any, is the Gaussian that ended it: the pixel must evaluate its
    list up to and including it, else the whole list. A tile needs its
    pairs up to the largest `evaluated` of its pixels."""
    import torch

    p = tile * tile
    cnt = counts[:n_tiles].long()
    evaluated = cnt[:, None].expand(n_tiles, p).clone()
    composited = torch.zeros((n_tiles, p), dtype=torch.int64,
                             device=payload.device)
    for jj, hit, comp in _composited_chunks(payload, starts, counts, n_tiles,
                                            tile, tiles_x, last, k):
        composited += comp.sum(dim=2)
        # the first hit past `last` ended the pixel
        ender = torch.where(hit & ~comp, jj, 1 << 30).amin(dim=2)
        evaluated = torch.minimum(evaluated, ender + 1)
    return evaluated, composited


def write_jax_checkpoint(path: Path, params, alive, step: int) -> None:
    """The JAX Trainer's checkpoint keys (params.<field>, alive, step)."""
    import numpy as np

    from dnsplatter_torch.models.gaussians import FIELDS

    flat = {f"params.{f}": getattr(params, f).cpu().numpy() for f in FIELDS}
    np.savez(path, alive=alive.cpu().numpy(), step=np.asarray(step), **flat)


def make_scene(n, scale_shift, extent, seed, dev):
    """Ground-truth Gaussians with real higher-order SH, a perturbed copy
    to serve, and the ring cameras."""
    import dataclasses

    import numpy as np
    import torch

    from dnsplatter_torch.data.synthetic import make_gt_gaussians, ring_cameras

    rng = np.random.default_rng(seed)
    gt, alive = make_gt_gaussians(rng, n, extent=extent, sh_degree=3,
                                  scale_shift=scale_shift, device=dev)
    rest = rng.normal(0.0, 0.1, tuple(gt.features_rest.shape))
    gt = dataclasses.replace(
        gt, features_rest=torch.as_tensor(rest.astype(np.float32), device=dev))
    noise = rng.normal(0.0, 0.002, (n, 3)).astype(np.float32)
    served = dataclasses.replace(
        gt, means=gt.means + torch.as_tensor(noise, device=dev),
        features_dc=gt.features_dc + 0.05)
    cams = ring_cameras(N_CAMERAS, width=WIDTH, img_height=HEIGHT,
                        focal=700.0, device=dev)
    return gt, served, alive, cams


def project_frame(params, alive, cam):
    """(projection, validf, opacities): what `render` hands the rasterizer
    for this camera."""
    import torch

    from dnsplatter_torch.ops.projection import project_gaussians

    with torch.no_grad():
        opac = torch.sigmoid(params.opacities)
        proj = project_gaussians(
            params.means, params.quats, torch.exp(params.scales),
            cam.viewmat(), cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
            cam.height, opacities=opac)
        return proj, (proj.valid & (alive > 0.5)).float(), opac


def bin_frame(params, alive, cam, cfg):
    """The port's bin_gaussians on exactly the inputs `render` hands the
    rasterizer for this camera."""
    import torch

    from dnsplatter_torch.ops.rasterize import bin_gaussians

    proj, validf, opac = project_frame(params, alive, cam)
    with torch.no_grad():
        return bin_gaussians(cfg, proj.means2d, proj.depths, proj.radii_xy,
                             validf, conics=proj.conics, opacities=opac)


def pair_totals(params, alive, cams, cfg):
    """total_pairs of the port's bin_gaussians for each camera."""
    return [int(bin_frame(params, alive, cam, cfg).total_pairs)
            for cam in cams]


def expand_entry(rc, n_segments: int):
    """The wrapper the expansion of `n_segments` goes through: the streamed
    entry above 2^18 segments, as `rc.expand_segments` routes it."""
    return (rc.expand_segments_stream if n_segments + 1 > (1 << 18)
            else rc.expand_segments)


def check_expand(rc, args, scene, gpu):
    """Kernel vs plain, int32 and float32 rows, through the entry the main
    path took; returns the report."""
    import torch

    vals, starts, out_len = args
    entry = expand_entry(rc, vals.shape[1])
    name = entry.__name__
    rows = {"int32": vals, "float32": vals.float() * 0.5 + 0.25}
    for kind, v in rows.items():
        k = entry(v, starts, out_len, out_dtype=v.dtype)
        p = rc.expand_segments_plain(v, starts, out_len, out_dtype=v.dtype)
        torch.cuda.synchronize()
        if not torch.equal(k.view(torch.int32), p.view(torch.int32)):
            bad = int((k.view(torch.int32) != p.view(torch.int32)).sum())
            raise AssertionError(f"{name} ({scene}, {kind} rows): {bad} "
                                 "words differ from the plain version")
    r, n = vals.shape
    seg = (starts[1:] - starts[:-1]).long()
    total = int(starts[-1])
    ms = device_ms(lambda: entry(vals, starts, out_len), 50)
    plain_ms = device_ms(
        lambda: rc.expand_segments_plain(vals, starts, out_len), 10)
    library_ms = device_ms(lambda: torch.repeat_interleave(
        vals, seg, dim=1, output_size=total), 50)
    nbytes = r * out_len * 4 + (r + 1) * n * 4
    return {"scene": scene, "kernel": name, "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes, "rows": r, "segments": n, "out_len": out_len,
            "gpu": gpu}


def check_forward(rc, args, scene, gpu):
    import torch

    payload, starts, counts, n_tiles, n_feats, tile, tiles_x, chunk = args
    got = rc.forward_tiles(*args)
    want = rc.forward_tiles_plain(*args)
    torch.cuda.synchronize()
    try:
        cmp = compare_forward(got, want, payload, n_feats)
    except AssertionError as e:
        raise AssertionError(f"({scene}) {e}") from None
    evaluated, composited = forward_work(payload, starts, counts, n_tiles,
                                         tile, tiles_x, want[2])
    visits, accepted = int(evaluated.sum()), int(composited.sum())
    needed = int(evaluated.amax(dim=1).sum())  # pairs the tiles must read
    ops = visits * FWD_OPS_PER_VISIT + accepted * 2 * n_feats
    nbytes = (needed * (6 + n_feats) * 4 + (2 * n_tiles + 1) * 4
              + n_tiles * tile * tile * (n_feats + 2) * 4)
    t_ops = ops / FP32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms = device_ms(lambda: rc.forward_tiles(*args), 50)
    plain_ms = device_ms(lambda: rc.forward_tiles_plain(*args), 1)
    return {"scene": scene, "kernel": "forward_tiles", **cmp,
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": nbytes, "ops": ops, "visits": visits,
            "accepted": accepted, "pairs": int(starts[n_tiles]),
            "pairs_needed": needed,
            "max_pairs_per_tile": int(counts[:n_tiles].max()), "gpu": gpu}


def run_scene(name, n, shift, extent, capacity, seed, dev, gpu, tmp):
    import numpy as np
    import torch

    from dnsplatter_torch.data.synthetic import render_batches
    from dnsplatter_torch.eval.evaluator import eval_raster_config, evaluate
    from dnsplatter_torch.models.dn_model import ModelConfig, get_outputs
    from dnsplatter_torch.ops import rasterize_cuda as rc
    from dnsplatter_torch.train.trainer import load_checkpoint_arrays

    t0 = time.perf_counter()
    gt, served, alive, cams = make_scene(n, shift, extent, seed, dev)
    cfg = eval_raster_config(WIDTH, HEIGHT, capacity)
    batches = render_batches(gt, alive, cams, lambda cam: cfg, sh_degree=3)
    ckpt = tmp / f"ckpt_{name}.npz"
    write_jax_checkpoint(ckpt, served, alive, step=30_000)
    params, alive_l, _ = load_checkpoint_arrays(ckpt)
    if params.means.device.type != dev.type:
        raise AssertionError("load_checkpoint_arrays did not default to the "
                             "card")
    log(f"[{name}] scene, ground truth and checkpoint: "
        f"{time.perf_counter() - t0:.1f} s")

    # -- the main path, counted --
    rc.LAUNCHES.clear()
    metrics = evaluate(params, alive_l, Frames(cams, batches),
                       pair_capacity=capacity)
    launches = {k: rc.LAUNCHES[k] for k in
                ("expand_segments", "expand_segments_stream",
                 "forward_tiles")}
    frames = 1 + len(cams)  # one warm-up render, then one per camera
    want = {"expand_segments": 0, "expand_segments_stream": 0,
            "forward_tiles": frames}
    want[expand_entry(rc, n).__name__] = frames
    if launches != want:
        raise AssertionError(f"[{name}] launches {launches}, expected {want}")
    for k, v in metrics.items():
        if k == "lpips_kind":
            continue
        if not (isinstance(v, (int, float)) and math.isfinite(v)):
            raise AssertionError(f"[{name}] metric {k} = {v}")
    if metrics.get("lpips_kind") != "random-vgg(relative-only)":
        raise AssertionError(
            f"[{name}] lpips_kind {metrics.get('lpips_kind')}")
    totals = pair_totals(params, alive_l, cams, cfg)
    if max(totals) > capacity:
        raise AssertionError(f"[{name}] pair totals {totals} overflow the "
                             f"capacity {capacity}")

    # -- frame time, outside the counted run --
    bg = torch.zeros(3, device=dev)
    times = []
    with torch.no_grad():
        for cam in cams:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            get_outputs(params, alive_l, cam, ModelConfig(), cfg,
                        sh_degree=3, background=bg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    ms_frame = statistics.median(times)

    # -- kernels against their plain versions at this scene's shapes --
    with torch.no_grad(), \
            mock.patch.object(rc, "expand_segments",
                              wraps=rc.expand_segments) as expand, \
            mock.patch.object(rc, "forward_tiles",
                              wraps=rc.forward_tiles) as fwd:
        get_outputs(params, alive_l, cams[0], ModelConfig(), cfg,
                    sh_degree=3, background=bg)
    reports = [check_expand(rc, expand.call_args.args, name, gpu),
               check_forward(rc, fwd.call_args.args, name, gpu)]
    for rep in reports:
        rep["launches_per_frame"] = 1
        rep["launches_main_path"] = launches[rep["kernel"]]
    cull = check_exact_cull(params, alive_l, cams[0], cfg, bg) \
        if name == "100k" else None
    summary = {
        "scene": name, "n_gaussians": n, "width": WIDTH, "height": HEIGHT,
        "pair_capacity": capacity, "pair_totals": totals,
        "exact_cull": cull,
        "ms_per_frame": ms_frame,
        "mpix_per_s": WIDTH * HEIGHT / (ms_frame * 1e3),
        "eval_fps": metrics["fps"], "psnr": metrics["rgb_psnr"],
        "ssim": metrics["rgb_ssim"], "depth_abs_rel":
            metrics["depth_abs_rel"], "normal_mae": metrics["normal_mae"],
        "lpips": metrics["rgb_lpips"], "launches": launches, "gpu": gpu,
    }
    return summary, reports, launches


def check_exact_cull(params, alive, cam, cfg, bg) -> dict:
    """One frame with and without `exact_cull`: the same image within
    CULL_TOL from fewer listed pairs (the culled pairs could never pass the
    kernels' hit test), through the float32 rows of `expand_segments`."""
    import dataclasses

    import torch

    from dnsplatter_torch.models.dn_model import ModelConfig, get_outputs
    from dnsplatter_torch.ops import rasterize_cuda as rc

    cfg_cull = dataclasses.replace(cfg, exact_cull=True)
    with torch.no_grad(), mock.patch.object(
            rc, "expand_segments", wraps=rc.expand_segments) as expand:
        plain, _ = get_outputs(params, alive, cam, ModelConfig(), cfg,
                               sh_degree=3, background=bg)
        culled, _ = get_outputs(params, alive, cam, ModelConfig(), cfg_cull,
                                sh_degree=3, background=bg)
    if expand.call_args.kwargs.get("out_dtype") != torch.float32:
        raise AssertionError("exact_cull did not expand float32 rows")
    errs = {k: float((plain[k] - culled[k]).abs().max())
            for k in ("rgb", "depth", "normal")}
    listed = int(bin_frame(params, alive, cam, cfg).counts.sum())
    kept = int(bin_frame(params, alive, cam, cfg_cull).counts.sum())
    report = {"pairs_listed": listed, "pairs_after_cull": kept,
              "max_abs_err": errs}
    if max(errs.values()) > CULL_TOL or not 0 < kept < listed:
        raise AssertionError(f"exact_cull: {report}")
    return report


def make_big_scene(dev):
    """The 2^24 scene, made on the card from a seed: (ground truth, the
    served Gaussians, alive, the ring cameras, the serving
    RasterizeConfig)."""
    import dataclasses

    import torch

    from dnsplatter_torch.data.synthetic import ring_cameras
    from dnsplatter_torch.eval.evaluator import eval_raster_config
    from dnsplatter_torch.models.gaussians import GaussianParams
    from dnsplatter_torch.ops.sh import num_sh_bases, rgb_to_sh

    n, extent, shift, capacity, n_cams = BIG_SCENE
    gen = torch.Generator(dev).manual_seed(24)

    def uniform(lo, hi, *shape):
        return torch.rand(*shape, device=dev, generator=gen) * (hi - lo) + lo

    quats = torch.randn(n, 4, device=dev, generator=gen)
    gt = GaussianParams(
        means=uniform(-extent, extent, n, 3),
        scales=uniform(-4.2 + shift, -2.8 + shift, n, 3),
        quats=quats / torch.linalg.norm(quats, dim=-1, keepdim=True),
        features_dc=rgb_to_sh(uniform(0.05, 0.95, n, 3)),
        features_rest=torch.randn(n, num_sh_bases(3) - 1, 3, device=dev,
                                  generator=gen) * 0.1,
        opacities=uniform(1.0, 3.0, n),
        normals=torch.zeros((n, 3), device=dev))
    alive = torch.ones(n, device=dev)
    served = dataclasses.replace(gt, features_dc=gt.features_dc + 0.05)
    cams = ring_cameras(n_cams, width=WIDTH, img_height=HEIGHT, focal=700.0,
                        device=dev)
    return gt, served, alive, cams, eval_raster_config(WIDTH, HEIGHT,
                                                       capacity)


def run_big_scene(dev, gpu):
    """Path A: serve 2^24 Gaussians made on the card. `auto` resolves to
    `tilekey` and binning builds its rows by prefix sum."""
    import torch

    from dnsplatter_torch.data.synthetic import render_batches
    from dnsplatter_torch.eval.evaluator import evaluate
    from dnsplatter_torch.models.dn_model import ModelConfig, get_outputs
    from dnsplatter_torch.ops import rasterize as rz
    from dnsplatter_torch.ops import rasterize_cuda as rc

    n, extent, shift, capacity, n_cams = BIG_SCENE
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gt, served, alive, cams, cfg = make_big_scene(dev)
    if rz._resolve_scheme(cfg, n)[0] != "tilekey":
        raise AssertionError("auto did not resolve to tilekey at 2^24")
    batches = render_batches(gt, alive, cams, lambda cam: cfg, sh_degree=3)
    log(f"[2p24] scene and ground truth: {time.perf_counter() - t0:.1f} s")

    names = ("cumsum_lanes_i32", "forward_tiles", "expand_segments",
             "expand_segments_stream")
    rc.LAUNCHES.clear()
    metrics = evaluate(served, alive, Frames(cams, batches),
                       pair_capacity=capacity)
    launches = {k: rc.LAUNCHES[k] for k in names}
    frames = 1 + n_cams
    want = {"cumsum_lanes_i32": frames, "forward_tiles": frames,
            "expand_segments": 0, "expand_segments_stream": 0}
    if launches != want:
        raise AssertionError(f"[2p24] launches {launches}, expected {want}")
    for k in ("rgb_psnr", "rgb_ssim", "depth_abs_rel", "normal_mae", "fps"):
        if not math.isfinite(metrics[k]):
            raise AssertionError(f"[2p24] metric {k} = {metrics[k]}")

    # the layout at this size: no overflow, and the depths of each tile's
    # ids do not decrease
    totals, visible = [], []
    for cam in cams:
        proj, validf, opac = project_frame(served, alive, cam)
        with torch.no_grad():
            b = rz.bin_gaussians(cfg, proj.means2d, proj.depths,
                                 proj.radii_xy, validf, conics=proj.conics,
                                 opacities=opac)
        total = int(b.total_pairs)
        totals.append(total)
        visible.append(int((b.gauss_starts[1:] > b.gauss_starts[:-1]).sum()))
        if total > capacity or int(b.starts[-1]) != total:
            raise AssertionError(f"[2p24] {total} pairs overflow {capacity}")
        d = proj.depths[b.pair_orig[:total].long()]
        slot = torch.arange(1, total, device=dev)
        tile = torch.searchsorted(b.starts.long(), slot, right=True)
        prev = torch.searchsorted(b.starts.long(), slot - 1, right=True)
        if bool(((d[1:] < d[:-1]) & (tile == prev)).any()):
            raise AssertionError("[2p24] a tile's list is out of depth order")
        del proj, validf, opac, b, d, slot, tile, prev
    if not BIG_PAIRS[0] <= min(totals) <= max(totals) <= BIG_PAIRS[1]:
        raise AssertionError(f"[2p24] pair totals {totals} outside "
                             f"{BIG_PAIRS}")

    bg = torch.zeros(3, device=dev)
    with torch.no_grad(), mock.patch.object(
            rc, "cumsum_lanes_i32", wraps=rc.cumsum_lanes_i32) as scan:
        times = []
        for cam in cams:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            get_outputs(served, alive, cam, ModelConfig(), cfg, sh_degree=3,
                        background=bg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    (table,) = scan.call_args.args
    rep = check_cumsum(rc, table, "2p24", gpu)
    rep["launches_per_frame"] = 1
    rep["launches_main_path"] = launches["cumsum_lanes_i32"]
    ms_frame = statistics.median(times)
    summary = {
        "scene": "2p24", "n_gaussians": n, "extent": extent,
        "scale_shift": shift, "width": WIDTH, "height": HEIGHT,
        "sort_scheme": "tilekey (auto)", "pair_capacity": capacity,
        "pair_totals": totals, "gaussians_with_pairs": visible,
        "ms_per_frame": ms_frame, "eval_fps": metrics["fps"],
        "psnr": metrics["rgb_psnr"], "ssim": metrics["rgb_ssim"],
        "depth_abs_rel": metrics["depth_abs_rel"],
        "normal_mae": metrics["normal_mae"],
        "max_memory_allocated_gb": peak / 1e9, "launches": launches,
        "gpu": gpu,
    }
    return summary, [rep], launches


def check_cumsum(rc, table, scene, gpu):
    import torch

    got = rc.cumsum_lanes_i32(table)
    again = rc.cumsum_lanes_i32(table)
    want = rc.cumsum_lanes_i32_plain(table)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(got, again)):
        raise AssertionError(
            f"({scene}) cumsum_lanes_i32: {int((got != want).sum())} words "
            f"differ from the plain version, {int((got != again).sum())} "
            "between two runs")
    ms = device_ms(lambda: rc.cumsum_lanes_i32(table), 20)
    plain_ms = device_ms(lambda: rc.cumsum_lanes_i32_plain(table), 20)
    library_ms = device_ms(
        lambda: torch.cumsum(table, dim=1, dtype=torch.int32), 20)
    # A second yardstick, timed only: one 1-D torch.cumsum a row, which
    # runs a library device scan (torch.cumsum along dim 1 of a few long
    # rows does not).
    library_rowwise_ms = device_ms(lambda: [
        torch.cumsum(row, 0, dtype=torch.int32) for row in table], 20)
    r, c = table.shape
    nbytes = 2 * r * c * 4
    ops = r * c
    t_ops = ops / FP32_OPS_PER_S * 1e3  # one 32-bit add a word
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"scene": scene, "kernel": "cumsum_lanes_i32", "max_abs_err": 0.0,
            "runs_bit_equal": True, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": "torch.cumsum",
            "library_rowwise_ms": library_rowwise_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": nbytes, "ops": ops, "rows": r, "lanes": c,
            "max_value": int(want.max()), "gpu": gpu}


def oracle_check(dev):
    """The kernel path against the port's dense oracle on a small scene."""
    import numpy as np
    import torch

    from dnsplatter_torch.ops import rasterize_cuda as rc
    from dnsplatter_torch.ops.projection import project_gaussians
    from dnsplatter_torch.ops.rasterize import RasterizeConfig, rasterize
    from dnsplatter_torch.ops.rasterize_ref import rasterize_pixels_ref
    from dnsplatter_torch.data.synthetic import make_gt_gaussians, ring_cameras

    gt, alive = make_gt_gaussians(np.random.default_rng(7), 1500,
                                  device=dev)
    cam = ring_cameras(1, width=160, img_height=120, focal=150.0,
                       device=dev)[0]
    proj = project_gaussians(gt.means, gt.quats, torch.exp(gt.scales),
                             cam.viewmat(), cam.fx, cam.fy, cam.cx, cam.cy,
                             160, 120)
    feats = torch.rand(1500, 7, device=dev,
                       generator=torch.Generator(dev).manual_seed(0))
    op = torch.sigmoid(gt.opacities)
    cfg = RasterizeConfig(width=160, height=120, chunk=128,
                          pair_capacity=1 << 16)
    before = rc.LAUNCHES["forward_tiles"]
    img, a = rasterize(proj.means2d, proj.conics, proj.depths, op, feats,
                       proj.valid, cfg, radii=proj.radii)
    if rc.LAUNCHES["forward_tiles"] != before + 1:
        raise AssertionError("rasterize did not launch forward_tiles")
    ri, ra = rasterize_pixels_ref(proj.means2d, proj.conics, proj.depths,
                                  op, feats, proj.valid, 160, 120,
                                  radii=proj.radii)
    err = (img - ri).abs().amax(dim=-1)
    bad = float((err > 1e-4).float().mean())
    if bad > 1e-3 or float((a - ra).abs().max()) > 1e-3:
        raise AssertionError(f"kernel path vs oracle: {bad:.5f} of pixels "
                             f"off by > 1e-4")
    return {"oracle_check": "kernel path vs dense oracle, 160x120, 1500 "
            "Gaussians", "pixels_off": bad,
            "max_abs_err": float(err.max()), "alpha_mean": float(a.mean())}


def decode_slab(slab, n_feats: int):
    """The 6 + F float32 field rows of a packed gradient slab."""
    import torch

    from dnsplatter_torch.ops import rasterize_cuda as rc

    rows = []
    for r in range(rc.packed_rows(n_feats)):
        rows += list(rc.unpack_bf16_2(slab[r]))
    return torch.stack(rows[:6 + n_feats])


def compare_backward(got, want, n_feats: int) -> dict:
    """Hold backward_tiles' packed slab `got` against the plain version's
    `want` on the same inputs; raise on disagreement.

    Compared decoded, not as words: the kernel adds a pair's up to 256
    per-pixel terms warp by warp, the plain version in torch.sum's order,
    so a sum can land on the other side of a bf16 rounding boundary. Per
    element |a - b| <= BWD_REL * max(|a|, |b|) + BWD_ATOL * (largest
    magnitude of its field row), and at most BWD_ULP_FRAC of the non-zero
    elements may differ by more than one bf16 ulp. The absolute term is for
    sums that cancel: two float32 orders of up to 256 terms differ by up
    to about 256 * 2^-24 * sum|terms|, which for terms of opposite sign is
    far above an ulp of the small result (measured on the 1M training
    scene: 5 of 14.7M elements moved by more than 2^-7 relative, the
    largest by 3.8e-6 absolute). Where the plain slab holds an integer-zero
    word the kernel's must too (slots no tile replays)."""
    import torch

    nz_bad = int(((want == 0) & (got != 0)).sum())
    a = decode_slab(got, n_feats)
    b = decode_slab(want, n_feats)
    diff = (a - b).abs()
    mag = torch.maximum(a.abs(), b.abs())
    row_max = b.abs().amax(dim=1, keepdim=True)
    excess = diff - (BWD_REL * mag + BWD_ATOL * row_max)
    n_bad = int((excess > 0).sum())
    nonzero = mag > 0
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-38))) - 7.0)
    beyond = (diff > ulp) & nonzero
    frac = float(beyond.sum()) / max(int(nonzero.sum()), 1)
    rel = torch.where(nonzero, diff / mag.clamp_min(1e-38), 0.0)
    report = {"max_abs_err": float(diff.max()),
              "max_rel_err": float(rel.max()),
              "elements": int(nonzero.sum()),
              "beyond_one_ulp_frac": frac, "out_of_tolerance": n_bad,
              "zero_words_broken": nz_bad,
              "row_max": [float(v) for v in row_max[:, 0]]}
    if n_bad or nz_bad or frac > BWD_ULP_FRAC:
        raise AssertionError(f"backward_tiles disagrees with its plain "
                             f"version: {report}")
    return report


def backward_work(payload, starts, counts, n_tiles: int, tile: int,
                  tiles_x: int, last, n_feats: int) -> dict:
    """The least work of backward_tiles on these inputs. A pixel replays
    its list up to its own `last` (one geometry evaluation per pair, to
    know which were hits) and does the gradient arithmetic for the hits; a
    tile reads the payload of, and writes slab words for, its pairs up to
    its deepest contributor. Also counts, for groups of 32 and of 128
    consecutive pixels (a warp at one and at four pixels a thread), the
    (group, pair) steps in which some pixel of the group composited the
    pair: each costs the kernel one warp-wide sum."""
    p = tile * tile
    accepted = 0
    steps = {32: 0, 128: 0}
    for _, _, comp in _composited_chunks(payload, starts, counts, n_tiles,
                                         tile, tiles_x, last):
        accepted += int(comp.sum())
        for g in steps:  # a group is at most the tile
            gp = min(g, p)
            steps[g] += int(comp.reshape(n_tiles, p // gp, gp, -1)
                            .any(dim=2).sum())
    lastp = last.reshape(n_tiles, p).long()
    visits = int((lastp + 1).sum())
    replayed = int((lastp.amax(dim=1) + 1).sum())
    ops = (visits * FWD_OPS_PER_VISIT
           + accepted * (BWD_OPS_PER_HIT + 4 * n_feats + (6 + n_feats)))
    ru = (6 + n_feats + 1) // 2
    nbytes = (replayed * (6 + n_feats + ru) * 4 + (2 * n_tiles + 1) * 4
              + n_tiles * p * (n_feats + 3) * 4)
    return {"visits": visits, "accepted": accepted, "replayed": replayed,
            "warp_pair_steps_32": steps[32],
            "warp_pair_steps_128": steps[128],
            "ops": ops, "bytes": nbytes}


def check_backward(rc, args, scene, gpu):
    """Kernel vs plain on the inputs one training step gave it."""
    import torch

    (payload, starts, counts, g_out, g_alpha, t_final, last, n_tiles,
     n_feats, tile, tiles_x, chunk) = args
    got = rc.backward_tiles(*args, pack_grads=True)
    again = rc.backward_tiles(*args, pack_grads=True)
    want = rc.backward_tiles_plain(*args, pack_grads=True)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"({scene}) backward_tiles: two runs differ in "
                             f"{int((got != again).sum())} words")
    try:
        cmp = compare_backward(got, want, n_feats)
    except AssertionError as e:
        raise AssertionError(f"({scene}) {e}") from None
    work = backward_work(payload, starts, counts, n_tiles, tile, tiles_x,
                         last, n_feats)
    t_ops = work["ops"] / FP32_OPS_PER_S * 1e3
    t_bytes = work["bytes"] / HBM_BYTES_PER_S * 1e3
    ms = device_ms(lambda: rc.backward_tiles(*args, pack_grads=True), 20)
    plain_ms = device_ms(
        lambda: rc.backward_tiles_plain(*args, pack_grads=True), 1, 1)
    return {"scene": scene, "kernel": "backward_tiles", **cmp, **work,
            "runs_bit_equal": True, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "pairs": int(starts[n_tiles]), "gpu": gpu}


def compare_reduce(got, want, kernel: str = "reduce_segments_bykey") -> dict:
    """A reduction kernel's output against its plain version's: rtol
    REDUCE_TOL, atol REDUCE_TOL x the row's largest magnitude (each kernel
    adds a Gaussian's lanes in one fixed order of its own, lane order or a
    segmented scan's tree order, index_add_ in any order), and exact zeros
    where the plain version has them (Gaussians without pairs)."""
    scale = want.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    diff = (got - want).abs()
    excess = diff - (REDUCE_TOL * want.abs() + REDUCE_TOL * scale)
    n_bad = int((excess > 0).sum())
    zero_bad = int(((want == 0) & (got != 0)).sum())
    report = {"max_abs_err": float(diff.max()),
              "max_scaled_err": float((diff / scale).max()),
              "out_of_tolerance": n_bad, "zero_sums_broken": zero_bad}
    if n_bad or zero_bad:
        raise AssertionError(f"{kernel} disagrees with its plain version: "
                             f"{report}")
    return report


def check_reduce(rc, args, scene, gpu):
    import torch

    slab, ru, n = args
    got = rc.reduce_segments_bykey(slab, ru, n)
    again = rc.reduce_segments_bykey(slab, ru, n)
    want = rc.reduce_segments_bykey_plain(slab, ru, n)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"({scene}) reduce_segments_bykey: two runs "
                             "differ")
    try:
        cmp = compare_reduce(got, want)
    except AssertionError as e:
        raise AssertionError(f"({scene}) {e}") from None
    # The library call, timed only: index_add_ of the rows decoded
    # beforehand (the decode is not in its time).
    keys = slab[ru].long()
    ok = (keys >= 0) & (keys < n)
    rows = []
    for i in range(ru):
        rows += list(rc.unpack_bf16_2(slab[i]))
    rows += [rows[0].abs(), rows[1].abs()]
    vals = torch.stack(rows)[:, ok].contiguous()
    kk = keys[ok].contiguous()
    out = torch.zeros((2 * ru + 2, n), device=slab.device)
    library_ms = device_ms(lambda: out.zero_().index_add_(1, kk, vals), 10)
    ms = device_ms(lambda: rc.reduce_segments_bykey(slab, ru, n), 20)
    plain_ms = device_ms(
        lambda: rc.reduce_segments_bykey_plain(slab, ru, n), 1)
    length = slab.shape[1]
    nbytes = (ru + 1) * length * 4 + (2 * ru + 2) * n * 4
    ops = 2 * ru * length + 2 * length
    t_ops = ops / FP32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"scene": scene, "kernel": "reduce_segments_bykey", **cmp,
            "runs_bit_equal": True, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": "index_add_ of the "
            "decoded rows", "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": nbytes, "ops": ops, "lanes": length, "ids": n,
            "gpu": gpu}


def check_boundary_reduce(rc, kernel, args, scene, gpu):
    """`reduce_segments_packed`, `reduce_segments_packed_multi` or
    `reduce_segments` against its plain version on the inputs one training
    step gave it."""
    import torch

    fn = getattr(rc, kernel)
    slab, starts, n = args
    got = fn(slab, starts, n)
    again = fn(slab, starts, n)
    want = getattr(rc, kernel + "_plain")(slab, starts, n)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"({scene}) {kernel}: two runs differ")
    try:
        cmp = compare_reduce(got, want, kernel)
    except AssertionError as e:
        raise AssertionError(f"({scene}) {e}") from None
    # Per piece: the lanes below the piece's last boundary, their ids and
    # their rows as float32. The library call, timed only, is index_add_ of
    # those rows (decoded beforehand: the decode is not in its time).
    pieces = slab if slab.ndim == 3 else slab[None]
    bounds = starts if starts.ndim == 2 else starts[None]
    ids, vals = [], []
    for piece, st in zip(pieces, bounds):
        lens = (st[1:] - st[:-1]).long()
        live = int(st[-1])
        ids.append(torch.repeat_interleave(
            torch.arange(n, device=slab.device), lens, output_size=live))
        rows = piece[:, :live]
        vals.append(rows if rows.dtype == torch.float32
                    else rc._decode_packed(rows))
    ids, vals = torch.cat(ids), torch.cat(vals, dim=1).contiguous()
    out = torch.zeros((vals.shape[0], n), device=slab.device)
    library_ms = device_ms(lambda: out.zero_().index_add_(1, ids, vals), 10)
    ms = device_ms(lambda: fn(slab, starts, n), 20)
    plain_ms = device_ms(
        lambda: getattr(rc, kernel + "_plain")(slab, starts, n), 1)
    lanes = int(ids.shape[0])
    rows_in = pieces.shape[1]
    nbytes = (rows_in * lanes * 4 + bounds.numel() * 4
              + got.shape[0] * n * 4)
    ops = got.shape[0] * lanes  # one add per output row and lane
    t_ops = ops / FP32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"scene": scene, "kernel": kernel, **cmp, "runs_bit_equal": True,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "index_add_ of the decoded rows",
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": nbytes, "ops": ops, "lanes": lanes,
            "slab_shape": list(slab.shape), "ids": n,
            "ids_with_gradient": int((got[-2:].sum(dim=0) > 0).sum()),
            "gpu": gpu}


class Frames:
    """A scene source: cameras with their batches."""

    def __init__(self, cams, batches):
        self.cams, self.batches = cams, batches

    def __len__(self):
        return len(self.cams)

    def get(self, i):
        return self.cams[i], self.batches[i]


def training_inputs(n, shift, extent, capacity, seed, dev, model_kw):
    """A scene's training set: targets (rgb, sensor depth, normals)
    rendered by the port from the ground truth, seed points perturbed from
    its means, and the model configuration."""
    import numpy as np

    from dnsplatter_torch.data.synthetic import render_batches
    from dnsplatter_torch.eval.evaluator import eval_raster_config
    from dnsplatter_torch.models.dn_model import ModelConfig
    from dnsplatter_torch.ops.sh import sh_to_rgb

    gt, _, alive, cams = make_scene(n, shift, extent, seed, dev)
    cfg = eval_raster_config(WIDTH, HEIGHT, capacity)
    data = Frames(cams, render_batches(gt, alive, cams, lambda cam: cfg,
                                       sh_degree=3))
    rng = np.random.default_rng(seed + 100)
    pts = (gt.means.cpu().numpy()
           + rng.normal(0.0, 0.002, (n, 3)).astype(np.float32))
    cols = np.clip(sh_to_rgb(gt.features_dc).cpu().numpy(), 0.0, 1.0)
    model_cfg = ModelConfig(use_depth_loss=True, depth_lambda=0.2,
                            use_normal_loss=True, sh_degree=3,
                            sh_degree_interval=1, **model_kw)
    return {"n": n, "cams": cams, "data": data, "seeds": (pts, cols),
            "model_cfg": model_cfg}


def timed_steps(step_fn, warmup: int, steps: int, names):
    """`warmup` then `steps` calls of `step_fn() -> loss`, each ended by a
    synchronisation; the launch counters of `names` are set to 0 just
    before the timed calls and read just after. Returns (ms, losses,
    launches)."""
    import torch

    from dnsplatter_torch.ops import rasterize_cuda as rc

    def one():
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = float(step_fn())
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, loss

    for _ in range(warmup):
        one()
    rc.LAUNCHES.clear()
    timed = [one() for _ in range(steps)]
    launches = {k: rc.LAUNCHES[k] for k in names}
    losses = [v for _, v in timed]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    return [t for t, _ in timed], losses, launches


STEP_KERNELS = ("expand_segments", "expand_segments_stream", "forward_tiles",
                "backward_tiles")
REDUCERS = ("reduce_segments_bykey", "reduce_segments_packed",
            "reduce_segments_packed_multi", "reduce_segments")
SH_KERNELS = ("sh_colors", "sh_colors_backward")
PS_KERNELS = ("project_screen", "project_screen_backward")
SSIM_KERNELS = ("ssim", "ssim_backward")


def expected_step_launches(steps: int, capacity: int, reducer: str) -> dict:
    """Once a step: one expand entry (by the state's capacity), the two
    tile kernels and the configuration's reduction; the others never."""
    want = dict.fromkeys(STEP_KERNELS + REDUCERS, 0)
    stream = capacity + 1 > (1 << 18)
    want["expand_segments_stream" if stream else "expand_segments"] = steps
    want["forward_tiles"] = want["backward_tiles"] = want[reducer] = steps
    return want


def sh_inputs(n: int, dev, seed: int):
    """features_dc, features_rest (K = 16), dirs and a colour gradient of n
    rows, on the card. Rows whose degree-3 colour lies within 1e-3 of the
    clamp at 0 are moved 0.01 above it, so that rounding cannot put the
    kernel and the plain version of one row on different sides of it."""
    import torch

    from dnsplatter_torch.ops.sh import C0, sh_basis

    g = torch.Generator(dev).manual_seed(seed)
    dc = torch.randn(n, 3, device=dev, generator=g)
    rest = 0.5 * torch.randn(n, 15, 3, device=dev, generator=g)
    dirs = 3.0 * torch.randn(n, 3, device=dev, generator=g)
    dcolors = torch.randn(n, 3, device=dev, generator=g)
    d64 = dirs.double()
    u = d64 / d64.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    coeffs = torch.cat([dc[:, None], rest], 1).double()
    raw = (sh_basis(3, u)[..., None] * coeffs).sum(1) + 0.5
    dc = dc + torch.where(raw.abs() < 1e-3, 0.01 / C0, 0.0).float()
    return dc, rest, dirs, dcolors


def check_sh_colors(rc, n: int, scene: str, gpu: str) -> dict:
    """The SH colour pair (`sh_colors` forward, `sh_colors_backward`) at n
    rows, degree 3, K = 16, against the plain version through autograd:
    colours and the three gradients within SH_TOL / SH_DIRS_TOL of each
    array's largest magnitude. Times each kernel, the pair's plain version
    (eval_sh on the concatenated coefficients, forward and autograd's
    backward) and the bound: 636 bytes a row / 3.35 TB/s."""
    import torch

    dev = torch.device("cuda")
    dc, rest, dirs, dcolors = sh_inputs(n, dev, seed=n)
    lk = [t.clone().requires_grad_(True) for t in (dc, rest, dirs)]
    lp = [t.clone().requires_grad_(True) for t in (dc, rest, dirs)]
    got = rc.sh_colors(3, *lk)
    gk = torch.autograd.grad(got, lk, dcolors)
    want = rc.sh_colors_plain(3, *lp)
    gp = torch.autograd.grad(want, lp, dcolors)
    torch.cuda.synchronize()
    got, want = got.detach(), want.detach()
    errs = {}
    for name, a, b, tol in (("colors", got, want, SH_TOL),
                            ("d_features_dc", gk[0], gp[0], SH_TOL),
                            ("d_features_rest", gk[1], gp[1], SH_TOL),
                            ("d_dirs", gk[2], gp[2], SH_DIRS_TOL)):
        err = float((a - b).abs().max() / b.abs().max())
        if not err <= tol:
            raise AssertionError(f"sh_colors ({scene}): {name} differs by "
                                 f"{err} of its largest value, over {tol}")
        errs[name] = err
    del got, gk, want, gp
    with torch.no_grad():
        fwd_ms = device_ms(lambda: rc.sh_colors(3, dc, rest, dirs), 50)
        bwd_ms = device_ms(lambda: rc.sh_colors_backward(
            3, dc, rest, dirs, dcolors), 50)

    def plain_pair():
        torch.autograd.grad(rc.sh_colors_plain(3, *lp), lp, dcolors)

    plain_ms = device_ms(plain_pair, 5)
    nbytes = n * SH_BYTES_PER_ROW
    return {"scene": scene, "kernel": "sh_colors", "rows": n,
            "max_rel_err": errs, "max_abs_err": max(errs.values()),
            "ms": fwd_ms + bwd_ms, "forward_ms": fwd_ms,
            "backward_ms": bwd_ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes, "gpu": gpu}


def project_inputs(n: int, dev, seed: int, width: int, height: int,
                   focal: float):
    """A camera, the screen-space entry's five differentiable inputs (means,
    quats, log-scales, opacity logits, colors), alive, and the incoming
    gradients of means2d, conics, opacities and features as strided columns
    of one (n, 15) array, as the rasterizer's backward hands them over: n
    random Gaussians around a view of a room-sized box, on the card."""
    import numpy as np
    import torch

    from dnsplatter_torch.data.synthetic import make_gt_gaussians
    from dnsplatter_torch.ops.camera import Camera, look_at

    gt, alive = make_gt_gaussians(np.random.default_rng(seed), n, extent=3.0,
                                  scale_shift=-1.0, device=dev)
    c2w = look_at((0.5, 1.4, 4.5), (0.0, 0.3, 0.0), device=dev)
    cam = Camera.create(focal, focal, width / 2, height / 2, c2w, width,
                        height, device=dev)
    g = torch.Generator(dev).manual_seed(seed)
    colors = torch.rand(n, 3, device=dev, generator=g)
    slab = torch.randn(n, 15, device=dev, generator=g)
    gin = (slab[:, 0:2], slab[:, 2:5], slab[:, 5], slab[:, 6:13])
    return cam, (gt.means, gt.quats, gt.scales, gt.opacities, colors), \
        alive, gin


def check_project_screen(rc, n: int, scene: str, width: int, height: int,
                         focal: float, gpu: str) -> dict:
    """The screen-space pair (`project_screen` forward,
    `project_screen_backward`) at n rows and the configuration's frame,
    against the plain version through autograd: radii, radii_xy and valid
    equal, the other outputs within PS_TOL and the five gradients within
    PS_GRAD_TOL of each array's largest magnitude. Times each kernel, the
    plain version (forward and autograd's backward) and the bound:
    PS_BYTES_PER_ROW bytes a row / 3.35 TB/s."""
    import torch

    cam, arrays, alive, gin = project_inputs(n, torch.device("cuda"), n,
                                             width, height, focal)
    view = cam.viewmat()
    args = (alive, view, cam.c2w, cam.fx, cam.fy, cam.cx, cam.cy, width,
            height)
    lk = [t.clone().requires_grad_(True) for t in arrays]
    lp = [t.clone().requires_grad_(True) for t in arrays]
    diff = (0, 1, 3, 4)  # means2d, conics, opacities, features
    got = rc.project_screen(*lk, *args)
    gk = torch.autograd.grad([got[i] for i in diff], lk, gin)
    want = rc.project_screen_plain(*lp, *args)
    gp = torch.autograd.grad([want[i] for i in diff], lp, gin)
    torch.cuda.synchronize()
    got, want = [t.detach() for t in got], [t.detach() for t in want]
    errs = {}
    names = ("means2d", "conics", "depths", "opacities", "features")
    for name, a, b in zip(names, got, want):
        errs[name] = float((a - b).abs().max() / b.abs().max())
    for name, a, b in zip(("d_means", "d_quats", "d_scales", "d_opacities",
                           "d_colors"), gk, gp):
        errs[name] = float((a - b).abs().max() / b.abs().max())
    for name, err in errs.items():
        tol = PS_GRAD_TOL if name.startswith("d_") else PS_TOL
        if not err <= tol:
            raise AssertionError(f"project_screen ({scene}): {name} differs "
                                 f"by {err} of its largest value, over {tol}")
    for name, a, b in zip(("valid", "radii_xy", "radii"), got[5:], want[5:]):
        if not torch.equal(a, b):
            raise AssertionError(f"project_screen ({scene}): {name} differs "
                                 f"in {int((a != b).sum())} elements")
    visible = int(got[5].sum())
    del got, gk, want, gp
    means, quats, scales, opac = (t.contiguous() for t in arrays[:4])
    colors = arrays[4]
    with torch.no_grad():
        fwd_ms = device_ms(lambda: rc.project_screen(
            means, quats, scales, opac, colors, *args), 50)
        bwd_ms = device_ms(lambda: rc.project_screen_backward(
            False, width, height, means, quats, scales, opac, view, cam.c2w,
            cam.fx, cam.fy, cam.cx, cam.cy, gin[0], gin[1], None, gin[2],
            gin[3]), 50)

    def plain_pair():
        outs = rc.project_screen_plain(*lp, *args)
        torch.autograd.grad([outs[i] for i in diff], lp, gin)

    plain_ms = device_ms(plain_pair, 5)
    nbytes = n * PS_BYTES_PER_ROW
    return {"scene": scene, "kernel": "project_screen", "rows": n,
            "visible": visible, "max_rel_err": errs,
            "max_abs_err": max(errs.values()), "ms": fwd_ms + bwd_ms,
            "forward_ms": fwd_ms, "backward_ms": bwd_ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes, "gpu": gpu}


def ssim_inputs(h: int, w: int, dev, seed: int):
    """A target image in [0, 1] and a prediction near it, (h, w, 3) on the
    card, and the window and constants `losses.ssim` uses."""
    import torch

    from dnsplatter_torch.models.losses import _gaussian_window

    g = torch.Generator(dev).manual_seed(seed)
    gt = torch.rand(h, w, 3, device=dev, generator=g)
    noise = torch.randn(h, w, 3, device=dev, generator=g)
    pred = torch.clamp(gt + 0.05 * noise, 0.0, 1.0)
    return pred, gt, _gaussian_window(11, 1.5, device=dev), 1e-4, 9e-4


def check_ssim(rc, scene: str, h: int, w: int, gpu: str) -> dict:
    """The SSIM pair (`ssim` forward, `ssim_backward`) at an (h, w, 3) frame
    against `losses.ssim_plain` and its autograd: the per-pixel map bit for
    bit, the mean within SSIM_MEAN_TOL, d img1 within SSIM_GRAD_TOL of its
    largest magnitude, two runs bit for bit. Times each entry, the plain
    version (forward and autograd's backward) and the bound: the larger of
    SSIM_BYTES_PER_ELEM bytes a pixel and channel / 3.35 TB/s and
    `ssim_ops` / 67 TFLOP/s."""
    import torch

    from dnsplatter_torch.models import losses as L

    dev = torch.device("cuda")
    pred, gt, win, c1, c2 = ssim_inputs(h, w, dev, seed=h)
    mean, smap = rc.ssim_forward(pred, gt, win, c1, c2, per_pixel=True)
    want_map = L.ssim_map_plain(pred, gt)
    differ = int((smap.view(torch.int32) != want_map.view(torch.int32)).sum())
    lk = pred.clone().requires_grad_(True)
    lp = pred.clone().requires_grad_(True)
    got = L.ssim(lk, gt)
    gk = torch.autograd.grad(got, lk)[0]
    want = L.ssim_plain(lp, gt)
    gp = torch.autograd.grad(want, lp)[0]
    again = L.ssim(lk, gt)
    gk2 = torch.autograd.grad(again, lk)[0]
    torch.cuda.synchronize()
    got, want = got.detach(), want.detach()
    errs = {"mean": abs(float(got) - float(want)) / abs(float(want)),
            "d_img1": float((gk - gp).abs().max() / gp.abs().max())}
    if differ:
        raise AssertionError(f"ssim ({scene}): {differ} pixels of the map "
                             "differ from the plain map")
    for name, tol in (("mean", SSIM_MEAN_TOL), ("d_img1", SSIM_GRAD_TOL)):
        if not errs[name] <= tol:
            raise AssertionError(f"ssim ({scene}): {name} differs by "
                                 f"{errs[name]}, over {tol}")
    if not (torch.equal(got, again.detach()) and torch.equal(gk, gk2)
            and torch.equal(got, mean)):
        raise AssertionError(f"ssim ({scene}): two runs differ")
    g = torch.ones((), device=dev)
    with torch.no_grad():
        fwd_ms = device_ms(lambda: rc.ssim_forward(pred, gt, win, c1, c2),
                           50)
        bwd_ms = device_ms(lambda: rc.ssim_backward(pred, gt, win, c1, c2,
                                                    g), 50)

    def plain_pair():
        torch.autograd.grad(L.ssim_plain(lp, gt), lp)

    plain_ms = device_ms(plain_pair, 5)
    nbytes = h * w * 3 * SSIM_BYTES_PER_ELEM
    ops = ssim_ops(h, w, 3, win.shape[0])
    t_ops = ops / FP32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"scene": scene, "kernel": "ssim", "frame": [h, w, 3],
            "ssim": float(got), "map_bit_equal": True,
            "runs_bit_equal": True, "max_rel_err": errs,
            "max_abs_err": max(errs.values()), "ms": fwd_ms + bwd_ms,
            "forward_ms": fwd_ms, "backward_ms": bwd_ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": nbytes, "ops": ops, "gpu": gpu}


def run_training(label, inputs, dev, gpu, steps, expect_refinement,
                 train_cfg=None, reducer="reduce_segments_bykey"):
    """Train the scene through `Trainer.train` and check the run; then hold
    the step's kernels (under the reduction by key: the expansion,
    forward_tiles, backward_tiles and the reduction; else the reduction)
    against their plain versions at the inputs one more step gives them.
    Returns (summary, reports, launches, trainer)."""
    import contextlib

    import torch

    from dnsplatter_torch.models.gaussians import FIELDS
    from dnsplatter_torch.ops import rasterize as rz
    from dnsplatter_torch.ops import rasterize_cuda as rc
    from dnsplatter_torch.train.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    cams = inputs["cams"]
    with contextlib.redirect_stdout(sys.stderr):
        trainer = Trainer(inputs["data"], inputs["seeds"],
                          model_cfg=inputs["model_cfg"],
                          train_cfg=train_cfg or TrainConfig())
    if trainer.params.means.device.type != dev.type:
        raise AssertionError("Trainer did not default to the card")
    log(f"[{label}] Trainer: {time.perf_counter() - t0:.1f} s")
    cap0 = trainer.params.capacity
    alive0 = int(trainer.alive.sum())

    def one_step():
        with contextlib.redirect_stdout(sys.stderr):
            return trainer.train(1, log_every=1 << 30)[-1]["loss"]

    ms, losses, launches = timed_steps(one_step, TRAIN_WARMUP, steps,
                                       STEP_KERNELS + REDUCERS + SH_KERNELS
                                       + PS_KERNELS + SSIM_KERNELS)
    want = expected_step_launches(steps, trainer.params.capacity, reducer)
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"[{label}] launches {launches}, "
                             f"expected {want}")
    # the SH colours once a step each way (and once more a rendered frame)
    if (launches["sh_colors_backward"] != steps
            or launches["sh_colors"] < steps):
        raise AssertionError(f"[{label}] SH launches {launches}, expected "
                             f"{steps} backward and at least as many forward")
    if (launches["project_screen_backward"] != steps
            or launches["project_screen"] < steps):
        raise AssertionError(f"[{label}] screen-space launches {launches}, "
                             f"expected {steps} backward and at least as "
                             "many forward")
    if (launches["ssim_backward"] != steps or launches["ssim"] < steps):
        raise AssertionError(f"[{label}] SSIM launches {launches}, expected "
                             f"{steps} backward and at least as many forward")
    for f in FIELDS:
        if not bool(torch.isfinite(getattr(trainer.params, f)).all()):
            raise AssertionError(f"[{label}] {f} is not finite")
    # every camera is visited once in four steps: compare like with like
    first = statistics.mean(losses[:N_CAMERAS])
    final = statistics.mean(losses[-N_CAMERAS:])
    if (not expect_refinement and steps >= 2 * N_CAMERAS
            and not final < first):
        raise AssertionError(f"[{label}] loss did not fall: first "
                             f"four steps {first}, last four {final}")
    rcfg = trainer._raster_cfg(cams[0])
    totals = pair_totals(trainer.params, trainer.alive, cams, rcfg)
    if max(totals) > rcfg.pair_capacity:
        raise AssertionError(f"[{label}] pair totals {totals} overflow "
                             f"the audited capacity {rcfg.pair_capacity}")
    alive1 = int(trainer.alive.sum())
    grown = trainer.params.capacity != cap0
    if expect_refinement and alive1 == alive0:
        raise AssertionError(f"[{label}] {steps} steps with the "
                             "shortened cadence left the alive count at "
                             f"{alive0}: no refinement event ran")

    # -- one more step, the kernels' inputs captured --
    with mock.patch.object(rc, "expand_segments",
                           wraps=rc.expand_segments) as expand, \
            mock.patch.object(rc, "forward_tiles",
                              wraps=rc.forward_tiles) as fwd, \
            mock.patch.object(rc, "backward_tiles",
                              wraps=rc.backward_tiles) as bwd, \
            mock.patch.object(rc, reducer,
                              wraps=getattr(rc, reducer)) as red, \
            mock.patch.object(rz, "live_pair_slots",
                              wraps=rz.live_pair_slots) as live:
        one_step()
    if bwd.call_args.kwargs != {"pack_grads": True}:
        raise AssertionError("the training path did not ask for packed "
                             "gradients")
    reduced_lanes = int(red.call_args.args[0].shape[1])
    grads_vs_bykey = None
    if reducer == "reduce_segments_bykey":
        if live.call_count != 1:
            raise AssertionError("the training path did not compact the "
                                 "slab")
        reports = [check_expand(rc, expand.call_args.args, label, gpu),
                   check_forward(rc, fwd.call_args.args, label, gpu),
                   check_backward(rc, bwd.call_args.args, label, gpu),
                   check_reduce(rc, red.call_args.args, label, gpu)]
    else:
        if live.call_count != 0:
            raise AssertionError(f"[{label}] compact_frac = 0 compacted")
        reports = [check_boundary_reduce(rc, reducer, red.call_args.args,
                                         label, gpu)]
        grads_vs_bykey = compare_frame_grads(
            label, frame_grads(trainer, rcfg, 0),
            frame_grads(trainer, bykey_config(rcfg), 0))
    for rep in reports:
        rep["launches_per_step"] = 1
        rep["launches_main_path"] = launches[rep["kernel"]]
    med = statistics.median(ms)
    summary = {
        "scene": label, "seed_gaussians": inputs["n"], "alive": alive1,
        "capacity": trainer.params.capacity, "capacity_grown": grown,
        "width": WIDTH, "height": HEIGHT, "steps": steps,
        "ms_per_step": med, "ms_per_step_min": min(ms),
        "ms_per_step_max": max(ms), "steps_per_s": 1e3 / med,
        "loss_first4": first, "loss_last4": final,
        "pair_capacity": rcfg.pair_capacity,
        "audited_pairs": trainer.audited_pairs, "pair_totals": totals,
        "lanes_reduced": reduced_lanes, "reducer": reducer,
        "grads_vs_bykey_max_scaled_err": grads_vs_bykey,
        "sort_scheme": rz._resolve_scheme(rcfg, trainer.params.capacity)[0]
        if rcfg.sort_scheme != "depthq" else "depthq",
        "launches": launches, "gpu": gpu,
    }
    return summary, reports, launches, trainer


def frame_grads(trainer, rcfg, cam_i: int):
    """Loss and gradients (every parameter field, then the absolute
    screen-space gradient) of the trainer's current state on frame `cam_i`
    under `rcfg`, with a black background."""
    import torch

    from dnsplatter_torch.models.dn_model import sh_degree_to_use
    from dnsplatter_torch.models.gaussians import FIELDS
    from dnsplatter_torch.train.trainer import loss_and_grads

    cam, batch = trainer.data.get(cam_i)
    loss, _, gparams, gabs, _ = loss_and_grads(
        trainer.model_cfg, rcfg, sh_degree_to_use(trainer.step,
                                                  trainer.model_cfg),
        trainer.params, trainer.alive, cam,
        trainer._device_batch(cam_i, batch), trainer.step,
        background=torch.zeros(3, device=trainer.device),
        generator=torch.Generator().manual_seed(0))
    return float(loss), [getattr(gparams, f) for f in FIELDS] + [gabs]


def compare_frame_grads(label, got, want, rtol=GRAD_RTOL,
                        atol=GRAD_ATOL) -> dict:
    """Two routes' gradients of one frame, per array scaled by its largest
    magnitude."""
    import torch

    from dnsplatter_torch.models.gaussians import FIELDS

    report = {}
    for name, a, b in zip(FIELDS + ("absgrad",), got[1], want[1]):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"[{label}] gradient of {name} not finite")
        scale = max(float(b.abs().max()), 1e-30)
        err = (a - b).abs() / scale
        worst = float((err - (atol + rtol * b.abs() / scale)).max())
        report[name] = float(err.max())
        if worst > 0.0:
            raise AssertionError(
                f"[{label}] gradient of {name} is off the reduction by "
                f"key's by {report[name]} of its scale")
    if (not math.isfinite(got[0])
            or abs(got[0] - want[0]) > 1e-5 * abs(want[0])):
        raise AssertionError(f"[{label}] losses {got[0]} and {want[0]}")
    return report


def bykey_config(rcfg):
    """`rcfg` with the default reduction: by key, compacted."""
    import dataclasses

    return dataclasses.replace(rcfg, grad_reduce="sortpack", reduce_pieces=0,
                               compact_frac=0.375)


def step_with(trainer, rcfg):
    """One `train_step` on the trainer's state, its RasterizeConfig
    replaced by `rcfg`, at the trainer's next camera; returns the loss."""
    from dnsplatter_torch.models.dn_model import sh_degree_to_use
    from dnsplatter_torch.train.trainer import train_step

    cam_i = trainer.step % len(trainer.data)
    cam, batch = trainer.data.get(cam_i)
    (trainer.params, trainer.adam, trainer.stats, loss, _) = train_step(
        trainer.model_cfg, trainer.optim_cfg, rcfg,
        sh_degree_to_use(trainer.step, trainer.model_cfg), trainer.params,
        trainer.alive, trainer.adam, trainer.stats, cam,
        trainer._device_batch(cam_i, batch), trainer.step,
        generator=trainer.generator)
    trainer.step += 1
    return loss


def run_step_path(label, trainer, rcfg, reducer, gpu, grad_atol=GRAD_ATOL):
    """Drive `train_step` on the trainer's state with its RasterizeConfig
    replaced by `rcfg`: PATH_STEPS timed steps after one warm-up, the
    launches counted, then the reduction kernel against its plain version
    on one more step's inputs and the frame's gradients against the
    reduction by key under the same keys."""
    import torch

    from dnsplatter_torch.models.gaussians import FIELDS
    from dnsplatter_torch.ops import rasterize_cuda as rc

    grads = compare_frame_grads(
        label, frame_grads(trainer, rcfg, 0),
        frame_grads(trainer, bykey_config(rcfg), 0), atol=grad_atol)

    def one_step():
        return step_with(trainer, rcfg)

    ms, losses, launches = timed_steps(one_step, 1, PATH_STEPS,
                                       STEP_KERNELS + REDUCERS)
    want = expected_step_launches(PATH_STEPS, trainer.params.capacity,
                                  reducer)
    if launches != want:
        raise AssertionError(f"[{label}] launches {launches}, "
                             f"expected {want}")
    for f in FIELDS:
        if not bool(torch.isfinite(getattr(trainer.params, f)).all()):
            raise AssertionError(f"[{label}] {f} is not finite")
    with mock.patch.object(rc, reducer, wraps=getattr(rc, reducer)) as red:
        one_step()
    rep = check_boundary_reduce(rc, reducer, red.call_args.args, label, gpu)
    rep["launches_per_step"] = 1
    rep["launches_main_path"] = launches[reducer]
    med = statistics.median(ms)
    summary = {
        "scene": label, "alive": int(trainer.alive.sum()),
        "capacity": trainer.params.capacity, "steps": PATH_STEPS,
        "ms_per_step": med, "ms_per_step_min": min(ms),
        "ms_per_step_max": max(ms), "losses": losses,
        "pair_capacity": rcfg.pair_capacity, "reducer": reducer,
        "sort_scheme": rcfg.sort_scheme, "grad_reduce": rcfg.grad_reduce,
        "reduce_pieces": rcfg.reduce_pieces,
        "compact_frac": rcfg.compact_frac,
        "grads_vs_bykey_max_scaled_err": grads, "launches": launches,
        "gpu": gpu,
    }
    return summary, [rep], launches


def write_mushroom_capture(root: Path, dev, capacity: int) -> dict:
    """A MuSHRoom iphone capture of the 1m scene at WIDTH x HEIGHT, rendered
    by the port: images, 16-bit millimetre depth (0 where the accumulated
    alpha is under 0.5), transformations.json, and a test.txt in the long
    capture. No normals, masks or seed cloud: the parser makes them."""
    import numpy as np
    import torch

    from dnsplatter_torch.data import io
    from dnsplatter_torch.data.synthetic import ring_cameras
    from dnsplatter_torch.eval.evaluator import eval_raster_config
    from dnsplatter_torch.ops.render import render

    _, n, shift, extent, _ = SCENES[1]
    gt, _, alive, _ = make_scene(n, shift, extent, 1, dev)
    cams = ring_cameras(MUSHROOM_LONG + MUSHROOM_SHORT, width=WIDTH,
                        img_height=HEIGHT, focal=700.0, device=dev)
    cfg = eval_raster_config(WIDTH, HEIGHT, capacity)
    # every sixth view goes to the short capture
    short = set(range(3, len(cams), 6))
    long_ = [i for i in range(len(cams)) if i not in short]
    coverage = []
    for capture, idx in (("long_capture", long_),
                         ("short_capture", sorted(short))):
        cdir = root / "iphone" / capture
        (cdir / "images").mkdir(parents=True)
        (cdir / "depth").mkdir()
        frames = []
        for j, i in enumerate(idx):
            with torch.no_grad():
                out, _ = render(gt, alive, cams[i], cfg, sh_degree_to_use=3,
                                background=torch.zeros(3, device=dev))
            hit = out.accumulation > 0.5
            coverage.append(float(hit.float().mean()))
            depth = torch.where(hit, out.depth, 0.0)
            io.write_image(cdir / "images" / f"{j:04d}.png",
                           out.rgb.cpu().numpy())
            io.write_depth_png(cdir / "depth" / f"{j:04d}.png",
                               depth.cpu().numpy())
            frames.append({"file_path": f"images/{j:04d}.png",
                           "depth_file_path": f"depth/{j:04d}.png",
                           "transform_matrix":
                               cams[i].c2w.cpu().numpy().tolist()})
        (cdir / "transformations.json").write_text(json.dumps(
            {"fl_x": 700.0, "fl_y": 700.0, "cx": WIDTH / 2, "cy": HEIGHT / 2,
             "w": WIDTH, "h": HEIGHT, "frames": frames}))
    (root / "iphone" / "long_capture" / "test.txt").write_text(
        "\n".join(MUSHROOM_TEST) + "\n")
    if min(coverage) < 0.2:
        raise AssertionError(f"the capture's views barely see the scene: "
                             f"coverage {coverage}")
    return {"frames_long": len(long_), "frames_short": len(short),
            "min_coverage": min(coverage)}


def run_mushroom(dev, gpu, tmp: Path):
    """Phase 8: write a MuSHRoom capture, parse it with the parser's
    defaults (1,000,000 seed points regenerated from the RGB-D frames,
    normals and consistency masks made from the depth), train on it, and
    evaluate its test split with LPIPS, point-cloud metrics after ICP and
    the with / within protocols. Returns (summary, [], launches)."""
    import contextlib
    import copy

    import numpy as np
    import torch

    from dnsplatter_torch.data.parsers import get_parser
    from dnsplatter_torch.data.parsers.mushroom import MushroomParserConfig
    from dnsplatter_torch.eval import icp as icp_mod
    from dnsplatter_torch.eval import metrics as M
    from dnsplatter_torch.eval.evaluator import eval_raster_config, evaluate
    from dnsplatter_torch.models.dn_model import ModelConfig, get_outputs
    from dnsplatter_torch.models.gaussians import FIELDS
    from dnsplatter_torch.ops import rasterize_cuda as rc
    from dnsplatter_torch.train.trainer import Trainer

    capacity = SCENES[1][4]
    t0 = time.perf_counter()
    written = write_mushroom_capture(tmp, dev, capacity)
    write_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    log(f"[mushroom] capture written: {write_s:.1f} s")

    parse = get_parser("mushroom")
    cfg = MushroomParserConfig(data=tmp, eval_mode="all",
                               load_depth_confidence_masks=True)
    if cfg.num_init_points != MUSHROOM_SEEDS:
        raise AssertionError(f"num_init_points {cfg.num_init_points}")
    t0 = time.perf_counter()
    train_ds = parse(cfg, "train")
    parse_train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    test_ds = parse(cfg, "test")
    parse_test_s = time.perf_counter() - t0
    made = {sub: len(list((tmp / "iphone" / "long_capture" / sub)
                          .glob("*.png")))
            for sub in ("normals_from_depth", "depth_normals_mask")}
    n_train = MUSHROOM_LONG - len(MUSHROOM_TEST)
    if (len(train_ds) != n_train
            or len(test_ds) != len(MUSHROOM_TEST) + MUSHROOM_SHORT
            or made != dict.fromkeys(made, MUSHROOM_LONG)
            or not (tmp / "iphone_pointcloud.ply").exists()):
        raise AssertionError(f"parsed {len(train_ds)} train / {len(test_ds)} "
                             f"test frames, made {made}")
    seeds = train_ds.seed()
    if len(seeds) != 3 or seeds[0].shape != (cfg.num_init_points, 3):
        raise AssertionError("the seed cloud is not 1,000,000 points with "
                             "colours and normals")
    t0 = time.perf_counter()
    for i in range(len(train_ds)):
        _, batch = train_ds.get(i)
        if sorted(batch) != ["confidence", "image", "normal",
                             "sensor_depth"]:
            raise AssertionError(f"train frame {i} holds {sorted(batch)}")
    load_s = time.perf_counter() - t0
    log(f"[mushroom] parse: train {parse_train_s:.1f} s, test "
        f"{parse_test_s:.1f} s, frame loads {load_s:.1f} s")

    # -- train: the main path's four kernels, counted --
    with contextlib.redirect_stdout(sys.stderr):
        trainer = Trainer(train_ds, seeds, model_cfg=ModelConfig(
            use_depth_loss=True, depth_lambda=0.2, use_normal_loss=True))
    if trainer.params.means.device.type != dev.type:
        raise AssertionError("Trainer did not default to the card")
    # Seeds resampled with replacement repeat exactly: a 3-NN distance of
    # 0 puts such a Gaussian at the init's 1e-7 scale floor.
    unique_seeds = len(np.unique(seeds[0], axis=0))
    live = trainer.alive > 0.5
    at_floor = float((trainer.params.scales[live].amax(dim=1)
                      < math.log(1e-6)).float().mean())

    def one_step():
        with contextlib.redirect_stdout(sys.stderr):
            return trainer.train(1, log_every=1 << 30)[-1]["loss"]

    ms, losses, launches = timed_steps(one_step, TRAIN_WARMUP,
                                       MUSHROOM_STEPS,
                                       STEP_KERNELS + REDUCERS)
    want = expected_step_launches(MUSHROOM_STEPS, trainer.params.capacity,
                                  "reduce_segments_bykey")
    if launches != want or want["expand_segments_stream"] == 0:
        raise AssertionError(f"[mushroom] launches {launches}, expected "
                             f"{want}")
    for f in FIELDS:
        if not bool(torch.isfinite(getattr(trainer.params, f)).all()):
            raise AssertionError(f"[mushroom] {f} is not finite")

    # -- evaluate the test split: LPIPS, point cloud + ICP, protocols --
    cam0, batch0 = test_ds.get(0)
    rcfg = eval_raster_config(WIDTH, HEIGHT,
                              trainer._raster_cfg(cam0).pair_capacity)
    totals = pair_totals(trainer.params, trainer.alive,
                         [test_ds.get(i)[0] for i in range(len(test_ds))],
                         rcfg)
    if max(totals) > rcfg.pair_capacity:
        raise AssertionError(f"[mushroom] pair totals {totals} overflow "
                             f"the audited capacity {rcfg.pair_capacity}")
    M.default_lpips()  # built outside the timings
    host_s = {"icp": [], "pd_metrics": []}

    def timed(name, fn):
        def call(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            host_s[name].append(time.perf_counter() - t)
            return out
        return call

    eval_names = ("expand_segments", "expand_segments_stream",
                  "forward_tiles")
    rc.LAUNCHES.clear()
    with mock.patch.object(icp_mod, "icp", timed("icp", icp_mod.icp)), \
            mock.patch.object(M, "pd_metrics",
                              timed("pd_metrics", M.pd_metrics)):
        metrics = evaluate(trainer.params, trainer.alive, test_ds,
                           pair_capacity=rcfg.pair_capacity,
                           extract_pointcloud=True,
                           reference_points=train_ds.seed_points,
                           run_icp_if_missing=True)
    eval_launches = {k: rc.LAUNCHES[k] for k in eval_names}
    frames = 1 + len(test_ds)  # one warm-up render, then one per frame
    want = dict.fromkeys(eval_names, 0)
    want["forward_tiles"] = frames
    want[expand_entry(rc, trainer.params.capacity).__name__] = frames
    if eval_launches != want:
        raise AssertionError(f"[mushroom] eval launches {eval_launches}, "
                             f"expected {want}")
    if [len(v) for v in host_s.values()] != [1, 1]:
        raise AssertionError(f"evaluate ran ICP / pd_metrics {host_s}")
    for k, v in metrics.items():
        if k == "lpips_kind":
            continue
        if not (isinstance(v, (int, float)) and math.isfinite(v)):
            raise AssertionError(f"[mushroom] metric {k} = {v}")
    if metrics["lpips_kind"] != "random-vgg(relative-only)":
        raise AssertionError(f"lpips_kind {metrics['lpips_kind']}")
    for key in ("within_rgb_psnr", "with_rgb_psnr", "within_rgb_lpips",
                "with_rgb_lpips", "within_depth_abs_rel", "with_normal_mae",
                "pd_accuracy", "pd_completeness", "pd_icp_rmse"):
        if key not in metrics:
            raise AssertionError(f"[mushroom] no {key} in {sorted(metrics)}")

    # -- frame time with and without LPIPS (each run renders one warm-up
    # frame first) --
    per_frame = {}
    for label, fn in (("lpips", None), ("stub", lambda a, b: 0.0)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate(trainer.params, trainer.alive, test_ds,
                 pair_capacity=rcfg.pair_capacity, lpips_fn=fn)
        per_frame[label] = (time.perf_counter() - t0) * 1e3 / len(test_ds)

    # -- LPIPS on the card against the same module on the CPU --
    with torch.no_grad():
        out, _ = get_outputs(trainer.params, trainer.alive, cam0,
                             ModelConfig(), rcfg, sh_degree=3,
                             background=torch.zeros(3, device=dev))
    gt_img = torch.as_tensor(batch0["image"], device=dev)
    card = float(M.default_lpips()(out["rgb"], gt_img))
    cpu_module = copy.deepcopy(M.default_lpips()).cpu()
    host = float(cpu_module(out["rgb"].cpu(), gt_img.cpu()))
    lpips_rel = abs(card - host) / abs(host)
    if not (math.isfinite(card) and lpips_rel <= LPIPS_CPU_RTOL):
        raise AssertionError(f"LPIPS on the card {card}, on the CPU {host}")

    med = statistics.median(ms)
    summary = {
        "scene": "mushroom_1m", "width": WIDTH, "height": HEIGHT, **written,
        "capture_write_s": write_s, "parse_train_s": parse_train_s,
        "parse_test_s": parse_test_s, "frame_load_s": load_s,
        "seed_points": int(seeds[0].shape[0]),
        "seed_unique_points": unique_seeds,
        "seeds_at_scale_floor_share": at_floor,
        "train_frames": len(train_ds), "test_frames": len(test_ds),
        "protocols": test_ds.protocols, "capacity": trainer.params.capacity,
        "alive": int(trainer.alive.sum()), "steps": MUSHROOM_STEPS,
        "ms_per_step": med, "ms_per_step_min": min(ms),
        "ms_per_step_max": max(ms), "losses": losses,
        "eval_ms_per_frame_lpips": per_frame["lpips"],
        "eval_ms_per_frame_no_lpips": per_frame["stub"],
        "icp_s": host_s["icp"][0], "pd_metrics_s": host_s["pd_metrics"][0],
        "pair_capacity": rcfg.pair_capacity,
        "pair_totals": totals, "lpips_card": card, "lpips_cpu": host,
        "lpips_card_vs_cpu_rel_err": lpips_rel,
        "metrics": {k: metrics[k] for k in (
            "rgb_psnr", "rgb_ssim", "rgb_lpips", "within_rgb_psnr",
            "with_rgb_psnr", "depth_abs_rel", "normal_mae", "pd_accuracy",
            "pd_completeness", "pd_icp_rmse", "lpips_kind")},
        "launches_train": launches, "launches_eval": eval_launches,
        "gpu": gpu,
    }
    del trainer
    torch.cuda.empty_cache()
    return summary, [], collections.Counter(launches) + collections.Counter(
        eval_launches)


# Phase 9: the CLI and the mesh chain on phase 8's capture.
CLI_STEPS = 13
EXPORT_MODES = (
    # mode, extra flags, the meshes it writes (globs: each must match)
    ("tsdf", (), ("TSDFfusion_mesh.ply",)),
    ("o3dtsdf", (), ("TSDFfusion_mesh.ply",)),
    ("dn", (), ("DepthAndNormals_poisson_mesh.ply", "TSDFfusion_mesh.ply")),
    ("gaussians", ("--poisson-resolution", "256"),
     ("Gaussians_poisson_mesh.ply",)),
    # a level with 100 points or fewer gets no Poisson mesh
    ("sugar-coarse", (), ("sugar_level_*_poisson_mesh.ply",)),
    ("isofusion", (), ("IsoFusion_mesh.ply",)),
    ("marching", ("--resolution", "128"), ("MarchingCubes_mesh.ply",)),
)
# The `marching` export's density level: a 13-step model's density stays
# under the exporter's default of 0.5, which leaves no surface at all.
MARCHING_LEVEL = 0.1


class HostTimers:
    """Seconds spent in the mesh chain's host functions (KD-trees, brick
    hashing, marching, clustering, decimation, smoothing, the octree's own
    work), by name, while active. Only the outermost timed call counts (the
    sparse volume's extraction holds its marching); the isofunc's device
    evaluations are timed apart and taken out of the octree's seconds."""

    def __init__(self):
        from dnsplatter_torch.mesh import (isofusion, marching, octree,
                                           poisson, postprocess, tsdf_sparse)
        from dnsplatter_torch.models import sugar

        self.s = collections.Counter()
        self.depth = 0
        sp = tsdf_sparse.SparseTSDF
        self.targets = [
            (sp, "_surface_bricks", "brick_hash"),
            (sp, "_ensure_slots", "brick_hash"),
            (sp, "extract_mesh", "brick_extract"),
            (marching, "marching_tetrahedra", "marching"),
            (sugar, "get_closest_gaussians", "kdtree"),
            (sugar, "closest_gaussians_tree", "kdtree"),
            (poisson, "trim_mesh_to_points", "kdtree"),
            (poisson, "density_quantile_cull", "kdtree"),
            (postprocess, "remove_small_clusters", "clusters"),
            (postprocess, "simplify_quadric_decimation", "decimation"),
            (postprocess, "filter_smooth_laplacian", "smoothing"),
            (octree, "adaptive_isosurface", "octree"),
        ]
        self.isofusion = isofusion
        self.patches = []

    def _timed(self, fn, name, inner=False):
        import torch

        def call(*args, **kw):
            if self.depth and not inner:
                return fn(*args, **kw)
            self.depth += 1
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                self.s[name] += time.perf_counter() - t
                self.depth -= 1
        return call

    def host_seconds(self) -> float:
        return sum(v for k, v in self.s.items() if k != "isofunc_card")

    def __enter__(self):
        for obj, attr, name in self.targets:
            self.patches.append(mock.patch.object(
                obj, attr, self._timed(getattr(obj, attr), name)))
        make = self.isofusion.make_isofunc

        def make_timed(*args, **kw):
            return self._timed(make(*args, **kw), "isofunc_card", inner=True)
        self.patches.append(mock.patch.object(self.isofusion, "make_isofunc",
                                              make_timed))
        for p in self.patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in reversed(self.patches):
            p.stop()
        self.patches = []
        if self.s["octree"]:
            self.s["octree"] -= self.s["isofunc_card"]
        return False


def check_mesh(path: Path) -> dict:
    """Vertex and face counts of a written mesh: finite vertices, faces that
    index them, at least one face."""
    import numpy as np

    from dnsplatter_torch.data import io

    mesh = io.read_ply(path)
    v, f = mesh["points"], mesh.get("faces")
    if f is None or len(f) == 0:
        raise AssertionError(f"{path.name}: no faces")
    if not np.isfinite(v).all():
        raise AssertionError(f"{path.name}: vertices not finite")
    if int(f.min()) < 0 or int(f.max()) >= len(v):
        raise AssertionError(f"{path.name}: faces index outside the "
                             f"{len(v)} vertices")
    return {"vertices": int(len(v)), "faces": int(len(f))}


def run_cli_mesh(dev, gpu, tmp: Path):
    """Phase 9: on phase 8's capture, `cli train` (13 steps at the parser's
    defaults, TensorBoard on), `cli eval` of the val split with both
    protocols, `cli export` in all seven modes at the audited pair capacity,
    then the meshes scored against one fused from the capture's own depth
    frames. Every marching of the phase takes the native backend, so a
    library that did not build fails the phase instead of falling back to
    numpy. Returns (summary, [], launches)."""
    import functools

    from dnsplatter_torch import native
    from dnsplatter_torch.mesh import marching

    if not native.available():
        raise AssertionError("[cli] native marching did not build: "
                             f"{native.build_error()}")
    log(f"[cli] native marching: {native.library_path()}")
    with mock.patch.object(marching, "marching_tetrahedra", functools.partial(
            marching.marching_tetrahedra, backend="native")):
        summary, fails, launches = cli_mesh_chain(dev, gpu, tmp)
    summary["native_marching"] = native.library_path().name
    return summary, fails, launches


def cli_mesh_chain(dev, gpu, tmp: Path):
    """The body of phase 9 (see `run_cli_mesh`)."""
    import contextlib
    import functools

    import numpy as np
    import torch

    from dnsplatter_torch import cli
    from dnsplatter_torch.data import io
    from dnsplatter_torch.data import pointcloud_utils as pu
    from dnsplatter_torch.eval.mesh_metrics import evaluate_mesh
    from dnsplatter_torch.eval.mesh_mushroom import evaluate_mesh_mushroom
    from dnsplatter_torch.eval.evaluator import eval_raster_config
    from dnsplatter_torch.mesh import exporters
    from dnsplatter_torch.ops import rasterize_cuda as rc
    from dnsplatter_torch.train.trainer import Trainer
    from dnsplatter_torch.utils.writers import read_tfevents_scalars

    data = ["--dataparser", "mushroom", "--data", str(tmp)]
    run = tmp / "run"
    seconds = {}

    def sync_now() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    # -- train: the four step kernels once a step --
    step_ms, saves = [], []
    train_one, save = Trainer.train_one, Trainer.save_checkpoint

    def timed_step(self, *args, **kw):
        t = sync_now()
        out = train_one(self, *args, **kw)
        step_ms.append((sync_now() - t) * 1e3)
        return out

    def timed_save(self, *args, **kw):
        t = sync_now()
        out = save(self, *args, **kw)
        saves.append(sync_now() - t)
        return out

    rc.LAUNCHES.clear()
    t0 = sync_now()
    with mock.patch.object(Trainer, "train_one", timed_step), \
            mock.patch.object(Trainer, "save_checkpoint", timed_save), \
            contextlib.redirect_stdout(sys.stderr):
        trainer = cli.cmd_train([
            "dn-splatter", "mushroom", "--data", str(tmp), "--output-dir",
            str(run), "--max-iterations", str(CLI_STEPS),
            "--model.use-depth-loss", "true",
            "--model.use-normal-loss", "true", "--train.tensorboard", "true"])
    seconds["train"] = sync_now() - t0
    train_launches = {k: rc.LAUNCHES[k] for k in STEP_KERNELS + REDUCERS}
    want = expected_step_launches(CLI_STEPS, trainer.params.capacity,
                                  "reduce_segments_bykey")
    if train_launches != want or want["expand_segments_stream"] == 0:
        raise AssertionError(f"[cli] train launches {train_launches}, "
                             f"expected {want}")
    if trainer.params.means.device.type != dev.type:
        raise AssertionError("cli train did not default to the card")
    n_seeds = int(trainer.params.means.shape[0])  # the state's capacity
    n_alive = int(trainer.alive.sum())
    ckpts = sorted(run.glob("ckpt_*.npz"))
    if [c.name for c in ckpts] != [f"ckpt_{CLI_STEPS:06d}.npz"]:
        raise AssertionError(f"[cli] checkpoints {ckpts}")
    (tb,) = (run / "tb").iterdir()
    tb_losses = [e["scalars"]["loss"] for e in read_tfevents_scalars(tb)
                 if "loss" in e["scalars"]]
    if not tb_losses or not all(math.isfinite(v) for v in tb_losses):
        raise AssertionError(f"[cli] tensorboard losses {tb_losses}")
    cap = trainer.train_cfg.pair_capacity
    audited = trainer.audited_pairs
    train_data = trainer.data
    cams = [train_data.camera(i) for i in range(len(train_data))]
    gt_depths = [train_data.get(i)[1]["sensor_depth"]
                 for i in range(len(train_data))]
    params, alive = trainer.params, trainer.alive
    del trainer
    log(f"[cli] train: {seconds['train']:.1f} s, {len(step_ms)} steps, "
        f"median {statistics.median(step_ms):.1f} ms, checkpoint "
        f"{saves[0]:.1f} s, pair capacity {cap}")

    # -- eval: one expansion and one forward_tiles a frame, plus a warm-up
    eval_dir = tmp / "evald"
    rc.LAUNCHES.clear()
    t0 = sync_now()
    with contextlib.redirect_stdout(sys.stderr):
        metrics = cli.cmd_eval(["--checkpoint", str(ckpts[0]), *data,
                                "--split", "val", "--parser.eval-mode", "all",
                                "--pair-capacity", str(cap),
                                "--output-dir", str(eval_dir)])
    seconds["eval"] = sync_now() - t0
    eval_names = ("expand_segments", "expand_segments_stream",
                  "forward_tiles")
    eval_launches = {k: rc.LAUNCHES[k] for k in eval_names}
    frames = metrics["num_images"]
    want = dict.fromkeys(eval_names, 0)
    want["forward_tiles"] = want[expand_entry(rc, n_seeds).__name__] = (
        1 + frames)
    if eval_launches != want:
        raise AssertionError(f"[cli] eval launches {eval_launches}, "
                             f"expected {want}")
    written = json.loads((eval_dir / "metrics.json").read_text())
    for key in ("within_rgb_psnr", "with_rgb_psnr", "rgb_psnr"):
        if not math.isfinite(written.get(key, float("nan"))):
            raise AssertionError(f"[cli] metrics.json {key}: "
                                 f"{written.get(key)}")
    bad = {k: v for k, v in written.items()
           if isinstance(v, float) and not math.isfinite(v)}
    if bad:
        raise AssertionError(f"[cli] metrics not finite: {bad}")

    # every export frame's pair list fits the capacity
    rcfg = eval_raster_config(WIDTH, HEIGHT, cap)
    totals = pair_totals(params, alive, cams, rcfg)
    if max(totals) > cap:
        raise AssertionError(f"[cli] pair totals {totals} overflow {cap}")
    del params, alive
    torch.cuda.empty_cache()

    # -- export: every mode --
    exports = {}
    renders = {"tsdf": len(cams), "o3dtsdf": len(cams), "dn": 2 * len(cams),
               "gaussians": 0, "sugar-coarse": -(-len(cams) // 4),
               "isofusion": len(cams), "marching": 0}
    for mode, extra, meshes in EXPORT_MODES:
        out = tmp / "exports" / mode
        rc.LAUNCHES.clear()
        level = mock.patch.object(exporters, "export_marching",
                                  functools.partial(exporters.export_marching,
                                                    level=MARCHING_LEVEL))
        with (level if mode == "marching" else contextlib.nullcontext()), \
                HostTimers() as host, contextlib.redirect_stdout(sys.stderr):
            t0 = sync_now()
            cli.cmd_export([mode, "--checkpoint", str(ckpts[0]), *data,
                            "--output-dir", str(out), "--pair-capacity",
                            str(cap), *extra])
            total = sync_now() - t0
        launches = {k: rc.LAUNCHES[k] for k in eval_names}
        want = dict.fromkeys(eval_names, 0)
        want["forward_tiles"] = want[expand_entry(rc, n_seeds).__name__] = (
            renders[mode])
        if launches != want:
            raise AssertionError(f"[cli] export {mode} launches {launches}, "
                                 f"expected {want}")
        host_s = {k: v for k, v in sorted(host.s.items()) if v}
        exports[mode] = {
            "seconds": total, "host_seconds": host_s,
            # renders, device work, transfers, PLY writes and the rest
            "other_seconds": total - host.host_seconds(),
            "meshes": {p.name: check_mesh(p) for m in meshes
                       for p in sorted(out.glob(m)) or [out / m]},
            "launches": launches}
        torch.cuda.empty_cache()
        log(f"[cli] export {mode}: {total:.1f} s, host {host_s}, "
            f"{exports[mode]['meshes']}")

    # -- score: against a mesh fused from the capture's own depth frames,
    # in the parser's frame (oriented, centred and scaled as the model),
    # by the route of tsdf_fused_cloud, which runs too (capture frame) --
    long_dir = tmp / "iphone" / "long_capture"
    t0 = sync_now()
    scale = train_data.dataparser_scale
    gt_v, gt_f, _ = pu.tsdf_fuse_frames(
        [(b["image"], b["sensor_depth"], c.c2w.cpu().numpy(), float(c.fx),
          float(c.fy), float(c.cx), float(c.cy))
         for c, b in (train_data.get(i) for i in range(len(train_data)))],
        voxel=0.04 * scale, trunc=0.2 * scale, reach=4.0 * scale)
    seconds["reference_mesh"] = sync_now() - t0
    reference_path = tmp / "reference_mesh.ply"
    io.write_ply(reference_path, gt_v, faces=gt_f)
    t0 = sync_now()
    cloud = pu.tsdf_fused_cloud(long_dir)
    seconds["tsdf_fused_cloud"] = sync_now() - t0
    log(f"[cli] reference mesh {len(gt_v)} vertices / {len(gt_f)} faces: "
        f"{seconds['reference_mesh']:.1f} s; tsdf_fused_cloud "
        f"{seconds['tsdf_fused_cloud']:.1f} s")
    if cloud[0].shape != (1_000_000, 3) or not np.isfinite(cloud[0]).all():
        raise AssertionError(f"[cli] tsdf_fused_cloud {cloud[0].shape}")
    scores = {}
    for mode, name in (("tsdf", "TSDFfusion_mesh.ply"),
                       ("dn", "DepthAndNormals_poisson_mesh.ply"),
                       ("isofusion", "IsoFusion_mesh.ply")):
        mesh = io.read_ply(tmp / "exports" / mode / name)
        t0 = sync_now()
        scores[mode] = evaluate_mesh(mesh["points"], mesh["faces"], gt_v,
                                     gt_f, cams)
        seconds[f"evaluate_mesh_{mode}"] = sync_now() - t0
        log(f"[cli] evaluate_mesh {mode}: "
            f"{seconds[f'evaluate_mesh_{mode}']:.1f} s {scores[mode]}")
    mesh = io.read_ply(tmp / "exports" / "dn"
                       / "DepthAndNormals_poisson_mesh.ply")
    t0 = sync_now()
    scores["dn_mushroom"] = evaluate_mesh_mushroom(
        mesh["points"], mesh["faces"], gt_v, gt_f, cams, gt_depths=gt_depths,
        icp_transform=np.eye(4))
    seconds["evaluate_mesh_mushroom_dn"] = sync_now() - t0
    for label, m in scores.items():
        for k, v in m.items():
            if not math.isfinite(v):
                raise AssertionError(f"[cli] {label} {k} = {v}")

    launches = collections.Counter(train_launches) + collections.Counter(
        eval_launches)
    for e in exports.values():
        launches.update(e["launches"])
    summary = {
        "scene": "cli_mesh_1m", "width": WIDTH, "height": HEIGHT,
        "capacity": n_seeds, "alive": n_alive, "steps": CLI_STEPS,
        "checkpoint": str(ckpts[0]),
        "reference_mesh_path": str(reference_path),
        "train_ms_per_step": statistics.median(step_ms),
        "train_ms_per_step_min": min(step_ms),
        "train_ms_per_step_max": max(step_ms),
        "checkpoint_save_s": saves[0], "tensorboard_losses": tb_losses,
        "pair_capacity": cap, "audited_pairs": audited,
        "pair_totals": totals, "eval_frames": frames,
        "eval_metrics": {k: written[k] for k in (
            "rgb_psnr", "within_rgb_psnr", "with_rgb_psnr", "rgb_lpips",
            "depth_abs_rel") if k in written},
        "seconds": seconds, "exports": exports,
        "reference_mesh": {"vertices": int(len(gt_v)),
                           "faces": int(len(gt_f))},
        "mesh_metrics": scores,
        "launches_train": train_launches, "launches_eval": eval_launches,
        "gpu": gpu,
    }
    return summary, [], launches


# Phase 10: monocular priors over phase 8's capture, training on them, and
# `cli render` of phase 9's checkpoint.
PRIOR_STEPS = 5
FP32_PEAK_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
# card against CPU at the narrow widths, of each output's largest magnitude
# (float32 both sides, TF32 off on the card)
PRIOR_CARD_TOL = 1e-4
UNIT_TOL = 1e-3


def prior_networks():
    """(name, maker of the published network from a seed, the input of
    one forward at the scripts' shapes, forwards a frame) of the three
    networks."""
    from dnsplatter_torch.priors import dpt, dsine, zoedepth

    return (
        ("dpt_hybrid_omnidata", lambda dev, seed: dpt.load_model(
            cfg=dpt.DPTHybridConfig(out_channels=3), device=dev, seed=seed),
         lambda m, dev: (torch_rand(dev, (1, 3, 384, 384)),), 1),
        ("dsine_b5", lambda dev, seed: dsine.load_model(device=dev,
                                                        seed=seed),
         lambda m, dev: (torch_rand(dev, (1, 3, HEIGHT, WIDTH)),
                         dsine_intrinsics(dev)), 1),
        ("zoedepth_nyu", lambda dev, seed: zoedepth.load_model(
            device=dev, seed=seed),
         lambda m, dev: (torch_rand(dev, (1, 3) + zoedepth.NET_HW),), 2),
    )


def torch_rand(dev, shape):
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    return torch.rand(shape, generator=g, device=dev)


def dsine_intrinsics(dev):
    import torch

    from dnsplatter_torch.priors.dsine import intrins_from_fov

    return torch.as_tensor(intrins_from_fov(60.0, HEIGHT, WIDTH)[None],
                           device=dev)


def event_ms(fn, reps: int = 5) -> list:
    """ms of each of `reps` calls between CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def forward_profile(model, inputs) -> dict:
    """Median ms of one forward between CUDA events (one warm-up, then five
    timed), its FLOPs counted from the shapes of its products and
    convolutions (torch.utils.flop_counter), and the peak memory; then,
    timed only, the same forward with TF32 allowed in products and
    convolutions (the flags restored after)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from dnsplatter_torch.priors.common import strict_fp32

    with torch.inference_mode():
        with strict_fp32():
            model(*inputs)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = event_ms(lambda: model(*inputs))
            peak = torch.cuda.max_memory_allocated()
            counter = FlopCounterMode(display=False)
            with counter:
                model(*inputs)
        matmul = torch.backends.cuda.matmul
        was = matmul.allow_tf32
        matmul.allow_tf32 = True
        try:
            with torch.backends.cudnn.flags(
                    enabled=True, benchmark=torch.backends.cudnn.benchmark,
                    deterministic=torch.backends.cudnn.deterministic,
                    allow_tf32=True):
                tf32 = event_ms(lambda: model.forward(*inputs))
        finally:
            matmul.allow_tf32 = was
    return {"forward_ms": statistics.median(times),
            "forward_ms_min": min(times), "forward_ms_max": max(times),
            "forward_flops": int(counter.get_total_flops()),
            "peak_memory_bytes": int(peak),
            "forward_ms_tf32_allowed": statistics.median(tf32)}


def dpt_head_conv_ms(model, dev) -> dict:
    """The DPT head's first convolution at the omnidata operating point
    (256 -> 128 channels, 3x3, 192x192), float32 without TF32, through
    cuDNN and through PyTorch's own convolution (the route the network
    takes; dpt.DPTHybrid.head_forward): median ms between CUDA events."""
    import torch

    from dnsplatter_torch.priors.common import strict_fp32, without_cudnn

    conv = model.head.head[0]
    x = torch_rand(dev, (1, conv.in_channels, 192, 192))
    with torch.inference_mode():
        with strict_fp32():
            cudnn = event_ms(lambda: conv(x), reps=3)
        with without_cudnn():
            own = event_ms(lambda: conv(x), reps=3)
    return {"cudnn_fp32_ms": statistics.median(cudnn),
            "pytorch_fp32_ms": statistics.median(own)}


def prior_small_cases() -> dict:
    """name -> (narrow module maker, input shape, takes intrinsics): the
    networks of the CPU parity tests."""
    import dataclasses

    from dnsplatter_torch.priors import dpt, dsine, zoedepth

    return {
        "dpt_hybrid_omnidata": (lambda: dpt.DPTHybrid(dataclasses.replace(
            dpt.SMALL_CONFIG, out_channels=3)), (1, 3, 96, 96), False),
        "dsine_b5": (lambda: dsine.DSINE(nf=64, feature_dim=16,
                                         hidden_dim=16, head_hidden=32,
                                         nrn_hidden=16), (1, 3, 64, 96),
                     True),
        "zoedepth_nyu": (lambda: zoedepth.ZoeDepth(zoedepth.SMALL_CONFIG),
                         (1, 3, 128, 160), False),
    }


def card_vs_cpu(dev, names=None) -> dict:
    """Each network (of `names`, default all) at its narrow test width
    with the same weights on the card and on the CPU (largest difference
    over the output's largest magnitude), and twice on the card (largest
    difference). Raises beyond PRIOR_CARD_TOL."""
    import numpy as np
    import torch

    from dnsplatter_torch.priors import common as C

    k = torch.as_tensor([[[80.0, 0, 47.5], [0, 80.0, 31.5], [0, 0, 1]]])
    cases = prior_small_cases()
    out = {}
    for name in names or sorted(cases):
        make, shape, intrins = cases[name]
        x = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
        runs = {}
        for where in ("cpu", "cuda", "cuda2"):
            d = torch.device("cpu" if where == "cpu" else dev)
            model = make().to(d).eval()
            C.params_from_numpy(model, C.random_arrays(model, 1))
            args = (torch.as_tensor(x, device=d),)
            if intrins:
                args += (k.to(d),)
            with torch.inference_mode(), C.strict_fp32():
                y = model(*args)
            runs[where] = (y[-1] if intrins else y).cpu().numpy()
        scale = float(np.abs(runs["cpu"]).max())
        err = float(np.abs(runs["cuda"] - runs["cpu"]).max()) / scale
        spread = float(np.abs(runs["cuda"] - runs["cuda2"]).max())
        if not (np.isfinite(runs["cuda"]).all() and err <= PRIOR_CARD_TOL):
            raise AssertionError(f"[priors] {name} card vs CPU: {err} of "
                                 f"the output's scale {scale}")
        out[name] = {"card_vs_cpu_rel": err, "card_twice_max_abs": spread,
                     "shape": list(shape)}
    return out


def check_maps(folder: Path, frames: int, pattern: str = "*.png") -> int:
    """Every map in `folder` finite and of the frame's size."""
    import numpy as np

    from dnsplatter_torch.data import io

    paths = sorted(folder.glob(pattern))
    if len(paths) != frames:
        raise AssertionError(f"[priors] {folder.name}: {len(paths)} maps, "
                             f"expected {frames}")
    for p in paths:
        m = np.load(p) if p.suffix == ".npy" else io.read_image(p)
        if m.shape[:2] != (HEIGHT, WIDTH) or not np.isfinite(m).all():
            raise AssertionError(f"[priors] {p}: shape {m.shape} or not "
                                 "finite")
    return len(paths)


def run_priors(dev, gpu, tmp: Path, cli_summary: dict):
    """Phase 10: the three prior networks at their published widths with
    seeded weights, through the scripts over phase 8's capture (omnidata,
    its HD merge, DSINE, ZoeDepth with sensor alignment, align_depth),
    each network timed, counted and held card against CPU at a narrow
    width; the capture re-parsed with the priors and trained on (3 + 5
    counted steps); `cli render` of phase 9's checkpoint, vis_errors and
    compare_normals on its tree; the reference mesh's normals and depths
    along the cameras. Returns (summary, [], launches)."""
    import contextlib

    import numpy as np
    import torch

    from dnsplatter_torch import cli
    from dnsplatter_torch.data.parsers import get_parser
    from dnsplatter_torch.data.parsers.mushroom import MushroomParserConfig
    from dnsplatter_torch.models.dn_model import ModelConfig
    from dnsplatter_torch.ops import rasterize_cuda as rc
    from dnsplatter_torch.priors import common as C
    from dnsplatter_torch.priors import dpt, dsine
    from dnsplatter_torch.priors.zoedepth import ZoeDepthNYUConfig
    from dnsplatter_torch.scripts import (align_depth, compare_normals,
                                          depth_from_pretrain, normals_hd,
                                          normals_from_pretrain,
                                          render_faro_depth,
                                          render_gt_normals, vis_errors)
    from dnsplatter_torch.train.trainer import Trainer

    long_dir = tmp / "iphone" / "long_capture"
    frames = MUSHROOM_LONG
    seconds, nets = {}, {}

    def sync_now() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    t_phase = sync_now()
    # -- the networks: seeded weights at the published widths, profiled on
    # the card, written as npz for the scripts --
    weights = tmp / "prior_weights"
    weights.mkdir()
    for seed, (name, make, inputs, per_frame) in enumerate(prior_networks()):
        t0 = sync_now()
        model = make(dev, seed)
        build_s = sync_now() - t0
        prof = forward_profile(model, inputs(model, dev))
        if name.startswith("dpt"):
            prof["head_conv"] = dpt_head_conv_ms(model, dev)
        t0 = time.perf_counter()
        np.savez(weights / f"{name}.npz", **C.state_arrays(model))
        nets[name] = {
            "params": int(sum(p.numel() for p in model.parameters())),
            "build_s": build_s, "npz_write_s": time.perf_counter() - t0,
            "forwards_per_frame": per_frame,
            "input_shape": list(inputs(model, dev)[0].shape), **prof,
            "ms_per_frame": prof["forward_ms"] * per_frame,
            "flops_per_frame": prof["forward_flops"] * per_frame,
            "bound_ms_per_frame": prof["forward_flops"] * per_frame
            / FP32_PEAK_FLOPS * 1e3, "bound_by": "operations"}
        del model
        torch.cuda.empty_cache()
        log(f"[priors] {name}: {nets[name]}")
    seconds["networks"] = sync_now() - t_phase

    # -- the scripts over the capture, their float outputs captured --
    captured = {"omnidata": [], "hd": [], "dsine": []}

    def capture(key, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            captured[key].append(np.asarray(out))
            return out
        return call

    data = ["--data", str(long_dir)]
    runs = (
        ("dpt_hybrid_omnidata", "normals_from_pretrain",
         lambda: normals_from_pretrain.main(
             data + ["--ckpt", str(weights / "dpt_hybrid_omnidata.npz")])),
        ("dpt_hybrid_omnidata_hd", "normals_hd", lambda: normals_from_pretrain
         .main(data + ["--ckpt", str(weights / "dpt_hybrid_omnidata.npz"),
                       "--hd", "--output-dir", str(long_dir / "normals_hd")])),
        ("dsine_b5", "normals_dsine", lambda: normals_from_pretrain.main(
            data + ["--ckpt", str(weights / "dsine_b5.npz"), "--model-type",
                    "dsine", "--output-dir", str(long_dir / "normals_dsine")])),
        ("zoedepth_nyu", "mono_depth", lambda: depth_from_pretrain.main(
            data + ["--ckpt", str(weights / "zoedepth_nyu.npz"),
                    "--sensor-dir", str(long_dir / "depth")])),
    )
    with mock.patch.object(dpt, "run_normals",
                           capture("omnidata", dpt.run_normals)), \
            mock.patch.object(normals_hd, "predict_normals_hd",
                              capture("hd", normals_hd.predict_normals_hd)), \
            mock.patch.object(dsine, "predict_normals",
                              capture("dsine", dsine.predict_normals)), \
            contextlib.redirect_stdout(sys.stderr):
        for name, folder, run in runs:
            t0 = sync_now()
            n = run()
            seconds[f"script_{name}"] = sync_now() - t0
            if n != frames:
                raise AssertionError(f"[priors] {name} wrote {n} frames")
            # mono_depth: the predictions, not yet the *_aligned maps
            check_maps(long_dir / folder, frames,
                       "*[!d].npy" if folder == "mono_depth" else "*.png")
        t0 = sync_now()
        align_depth.main(data)
        seconds["align_depth"] = sync_now() - t0
    for name, _, _ in runs:
        key = name if name in nets else "dpt_hybrid_omnidata"
        nets[key][f"script_ms_per_frame{name[len(key):]}"] = (
            seconds[f"script_{name}"] * 1e3 / frames)
    # the omnidata maps are the clamped raw output; the others unit
    # (the HD route's patches among them)
    for omni in captured["omnidata"]:
        if not (np.isfinite(omni).all() and omni.min() >= 0
                and omni.max() <= 1):
            raise AssertionError("[priors] an omnidata map is not finite "
                                 "in [0, 1]")
    omni_calls = len(captured["omnidata"])
    unit_err = {}
    for key in ("hd", "dsine"):
        maps = np.stack(captured[key])
        if maps.shape != (frames, HEIGHT, WIDTH, 3):
            raise AssertionError(f"[priors] {key} maps {maps.shape}")
        unit_err[key] = float(np.abs(np.linalg.norm(maps, axis=-1)
                                     - 1.0).max())
        if not unit_err[key] <= UNIT_TOL:
            raise AssertionError(f"[priors] {key} normals off unit by "
                                 f"{unit_err[key]}")
    cfg = ZoeDepthNYUConfig()
    depth = np.stack([np.load(p) for p in sorted(
        (long_dir / "mono_depth").glob("*.npy")) if "_aligned" not in p.name])
    depth_range = [float(depth.min()), float(depth.max())]
    if not cfg.min_depth <= depth_range[0] <= depth_range[1] <= cfg.max_depth:
        raise AssertionError(f"[priors] depths span {depth_range}")
    check_maps(long_dir / "mono_depth", frames, "*_aligned.npy")
    log(f"[priors] scripts: {seconds}")

    t0 = sync_now()
    card_cpu = card_vs_cpu(dev)
    seconds["card_vs_cpu"] = sync_now() - t0

    # -- train on the priors: the parser takes normals_from_pretrain/ --
    parse = get_parser("mushroom")
    t0 = sync_now()
    train_ds = parse(MushroomParserConfig(data=tmp,
                                          load_depth_confidence_masks=True),
                     "train")
    seconds["parse"] = sync_now() - t0
    sources = {f.normal_path.parent.name for f in train_ds.frames}
    if sources != {"normals_from_pretrain"}:
        raise AssertionError(f"[priors] normals parsed from {sources}")
    t0 = sync_now()
    with contextlib.redirect_stdout(sys.stderr):
        trainer = Trainer(train_ds, train_ds.seed(), model_cfg=ModelConfig(
            use_depth_loss=True, depth_lambda=0.2, use_normal_loss=True))

    def one_step():
        with contextlib.redirect_stdout(sys.stderr):
            return trainer.train(1, log_every=1 << 30)[-1]["loss"]

    ms, losses, train_launches = timed_steps(
        one_step, TRAIN_WARMUP, PRIOR_STEPS, STEP_KERNELS + REDUCERS)
    want = expected_step_launches(PRIOR_STEPS, trainer.params.capacity,
                                  "reduce_segments_bykey")
    if train_launches != want:
        raise AssertionError(f"[priors] train launches {train_launches}, "
                             f"expected {want}")
    del trainer
    torch.cuda.empty_cache()
    seconds["train"] = sync_now() - t0

    # -- cli render of phase 9's checkpoint at the audited capacity --
    cap = cli_summary["pair_capacity"]
    renders = tmp / "renders"
    eval_names = ("expand_segments", "expand_segments_stream",
                  "forward_tiles")
    rc.LAUNCHES.clear()
    t0 = sync_now()
    with contextlib.redirect_stdout(sys.stderr):
        metrics = cli.cmd_render([
            "--checkpoint", cli_summary["checkpoint"], "--dataparser",
            "mushroom", "--data", str(tmp), "--split", "val",
            "--parser.eval-mode", "all", "--pair-capacity", str(cap),
            "--output-dir", str(renders)])
    seconds["cli_render"] = sync_now() - t0
    render_launches = {k: rc.LAUNCHES[k] for k in eval_names}
    n_render = metrics["num_images"]
    want = dict.fromkeys(eval_names, 0)
    want["forward_tiles"] = want[expand_entry(
        rc, cli_summary["capacity"]).__name__] = 1 + n_render
    if render_launches != want:
        raise AssertionError(f"[priors] render launches {render_launches}, "
                             f"expected {want}")
    for sub, pattern in (("pred/rgb", "*.png"), ("pred/normal", "*.png"),
                         ("pred/depth", "*.npy"), ("gt/normal", "*.png"),
                         ("pred/depth_colormaps", "*.png")):
        check_maps(renders / sub, n_render, pattern)
    with contextlib.redirect_stdout(sys.stderr):
        t0 = time.perf_counter()
        n_err = vis_errors.main(["--renders", str(renders)])
        seconds["vis_errors"] = time.perf_counter() - t0
        if n_err != 3 * n_render:
            raise AssertionError(f"[priors] {n_err} error maps")
        normal_err = compare_normals.main([
            "--dir-a", str(renders / "gt" / "normal"),
            "--dir-b", str(renders / "pred" / "normal")])

        # -- the reference mesh along the capture's cameras --
        mesh_args = ["--mesh", cli_summary["reference_mesh_path"], "--data",
                     str(tmp), "--dataparser", "mushroom"]
        t0 = sync_now()
        n_ref = render_gt_normals.main(mesh_args + [
            "--output-dir", str(tmp / "reference_normal")])
        seconds["render_gt_normals"] = sync_now() - t0
        t0 = sync_now()
        n_depth = render_faro_depth.main(mesh_args + [
            "--output-dir", str(tmp / "reference_depth")])
        seconds["render_faro_depth"] = sync_now() - t0
        prior_vs_mesh = compare_normals.main([
            "--dir-a", str(long_dir / "normals_from_pretrain"),
            "--dir-b", str(tmp / "reference_normal")])
    check_maps(tmp / "reference_normal", n_ref)
    check_maps(tmp / "reference_depth", n_depth)
    if not (math.isfinite(normal_err) and math.isfinite(prior_vs_mesh)):
        raise AssertionError("[priors] normal comparisons not finite")
    seconds["phase"] = sync_now() - t_phase

    summary = {
        "scene": "priors_mushroom", "width": WIDTH, "height": HEIGHT,
        "frames": frames, "networks": nets, "card_vs_cpu": card_cpu,
        "unit_err": unit_err, "mono_depth_range": depth_range,
        "omnidata_forwards": omni_calls,
        "normal_sources": sorted(sources), "train_steps": PRIOR_STEPS,
        "train_ms_per_step": statistics.median(ms), "train_losses": losses,
        "render_frames": n_render, "render_pair_capacity": cap,
        "render_normal_err_deg": normal_err,
        "prior_vs_mesh_normal_err_deg": prior_vs_mesh,
        "seconds": seconds, "launches_train": train_launches,
        "launches_render": render_launches, "gpu": gpu,
    }
    for name, rep in nets.items():
        print(json.dumps({"network": name, "gpu": gpu, **rep}), flush=True)
    return summary, [], collections.Counter(train_launches) + \
        collections.Counter(render_launches)


# Phase 11: the baseline methods through `cli train`, the live viewer's orbit
# renders while a Trainer steps, and batch runs, on phase 8's capture.
BASELINE_METHODS = ("gnerfacto", "gdepthfacto", "gneusfacto")
BASELINE_STEPS = 30
BASELINE_TRACED_STEP = 10  # runs inside profiling.trace, not timed
BASELINE_LOSS_RTOL = 1e-5  # card against CPU, one step's loss
BASELINE_GRAD_L2 = 1e-3  # each leaf's |g_card - g_cpu|_2 / |g_cpu|_2
BASELINE_TS_BINS = 1e-2  # card against CPU, sample distances in coarse bins
VIEWER_STEPS = 5
ORBIT_POSES = ((0.0, 20.0, 3.0), (75.0, 10.0, 2.5), (160.0, -10.0, 3.5))
ORBIT_SCALES = (0.5, 1.0, 1.5)
BATCH_SEEDS = 20_000


def baseline_card_vs_cpu(method, dev, frame, cfg=None, seed=0) -> dict:
    """One step's loss and gradients of a baseline method, at `cfg` (default:
    the method's own widths), on the card and on the CPU from the same
    weights, pixel draws and sample distances. Each device places the
    samples from the same draws (nerfacto: the coarse field pass, the pdf's
    search and the sort) and the two sets are held against each other in
    bins of the coarse grid; both losses then take the CPU's distances, for
    the devices round the pdf's sums differently and a sample a few ulps
    away can cross a hash cell. `frame`: (camera, image, depth, normal) on
    the CPU."""
    import torch

    from dnsplatter_torch.baselines import nerfacto, neusfacto, runner
    from dnsplatter_torch.ops.camera import Camera

    cpu = torch.device("cpu")
    cfg = cfg or runner.method_config(method)
    neus = method == "gneusfacto"
    mod = neusfacto if neus else nerfacto
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    ref = mod.init_params(gen, cfg, device=cpu)
    leaves = [x.detach().numpy() for x in runner.leaves_like_jax(ref)]
    cam, image, depth, normal = frame
    px = mod.pixel_draws(mod.N_RAYS, cam.width, cam.height, gen)
    if neus:
        draws = {"jitter": torch.rand((mod.N_RAYS, cfg.n_samples),
                                      generator=gen)}
    else:
        draws = nerfacto.ray_draws(cfg, mod.N_RAYS, gen)
    out, ts_on = {}, {}
    for device in (cpu, dev):
        params = runner.params_from_jax(leaves, cfg, device=device)
        c = Camera.create(float(cam.fx), float(cam.fy), float(cam.cx),
                          float(cam.cy), cam.c2w.cpu().numpy(), cam.width,
                          cam.height, device=device)
        on = {k: v.to(device) for k, v in draws.items()}
        if neus:
            ts_on[device.type] = neusfacto.sample_distances(cfg, on["jitter"])
        else:
            o, d = nerfacto.camera_rays(c, px.to(device))
            ts_on[device.type] = nerfacto.sample_distances(params, cfg, o, d,
                                                           on)
        ts = ts_on["cpu"]
        args = [c, image.to(device), depth.to(device)]
        args += [normal.to(device)] if neus else []
        loss = mod.train_loss(params, cfg, *args, {"px": px.to(device),
                                                   "ts": ts.to(device)})
        grads = torch.autograd.grad(loss, runner.leaves_like_jax(params))
        out[device.type] = (float(loss.detach()), [g.cpu() for g in grads])
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out[dev.type]
    l2 = [float((a - b).norm() / b.norm().clamp_min(1e-30))
          for a, b in zip(g_card, g_cpu)]
    worst = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
             for a, b in zip(g_card, g_cpu)]
    coarse_bin = (cfg.far - cfg.near) / (cfg.n_samples if neus
                                         else cfg.n_coarse)
    return {"loss_cpu": l_cpu, "loss_card": l_card,
            "loss_rel_err": abs(l_card - l_cpu) / abs(l_cpu),
            "grad_rel_l2": max(l2), "grad_max_abs_rel": max(worst),
            "ts_max_err_bins": float((ts_on[dev.type].cpu() - ts_on["cpu"])
                                     .abs().max()) / coarse_bin,
            "rays": mod.N_RAYS, "samples": int(ts.shape[1])}


def trace_counts(prof) -> dict:
    """Kernels on the card, launch calls on the host, and the kernels'
    summed device time, of a `profiling.trace`d block."""
    from torch.autograd import DeviceType

    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    launch_calls = sum(e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                  "cudaLaunchKernelExC", "cuLaunchKernelEx")
                       for e in events)
    return {"device_kernels": len(kernels), "launch_calls": launch_calls,
            "device_ms": sum(e.time_range.elapsed_us()
                             for e in kernels) / 1e3}


def run_baselines(dev, gpu, tmp: Path):
    """Phase 11: `cli train` of the three baseline methods at their own
    widths on phase 8's capture (30 steps each, one of them traced), each
    method's step card against CPU; a Trainer with the live viewer serving
    orbit renders while it steps; `dispatch_jobs` over two copies of the
    capture on one device slot. Returns (summary, [], launches)."""
    import contextlib
    import io as _io
    import os
    import threading
    import urllib.request

    import numpy as np
    import torch
    from PIL import Image

    from dnsplatter_torch import cli
    from dnsplatter_torch.baselines import nerfacto, neusfacto, runner
    from dnsplatter_torch.data.parsers.mushroom import (MushroomParserConfig,
                                                        parse)
    from dnsplatter_torch.eval import batch_run
    from dnsplatter_torch.models.dn_model import ModelConfig
    from dnsplatter_torch.ops import rasterize_cuda as rc
    from dnsplatter_torch.train.trainer import TrainConfig, Trainer
    from dnsplatter_torch.utils import profiling

    seconds, methods = {}, {}

    def sync_now() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    t_phase = sync_now()
    # -- the baselines through the CLI (they read no seed cloud) --
    for method in BASELINE_METHODS:
        mod = neusfacto if method == "gneusfacto" else nerfacto
        rec = {"ms": [], "losses": []}
        make = mod.make_train_step

        def make_timed(cfg, lr, make=make, rec=rec, method=method):
            step, opt = make(cfg, lr=lr)

            def timed(*args, **kw):
                if len(rec["losses"]) == BASELINE_TRACED_STEP:
                    with profiling.trace(tmp / f"trace_{method}") as prof:
                        loss = step(*args, **kw)
                        value = float(loss)
                    rec["trace"] = trace_counts(prof)
                else:
                    t = sync_now()
                    loss = step(*args, **kw)
                    value = float(loss)  # waits for the step
                    rec["ms"].append((time.perf_counter() - t) * 1e3)
                rec["losses"].append(value)
                return loss

            return timed, opt

        run = tmp / f"baseline_{method}"
        rc.LAUNCHES.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = sync_now()
        with mock.patch.object(mod, "make_train_step", make_timed), \
                contextlib.redirect_stdout(sys.stderr):
            params, history = cli.cmd_train([
                method, "mushroom", "--data", str(tmp), "--output-dir",
                str(run), "--max-iterations", str(BASELINE_STEPS),
                "--parser.load-3D-points", "false"])
        seconds[method] = sync_now() - t0
        peak = torch.cuda.max_memory_allocated()
        if any(rc.LAUNCHES.values()):
            raise AssertionError(f"[{method}] launched rasterizer kernels "
                                 f"{dict(rc.LAUNCHES)}")
        losses, ms = rec["losses"], rec["ms"]
        if len(losses) != BASELINE_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"[{method}] losses {losses}")
        if (method != "gneusfacto"
                and not np.mean(losses[-5:]) < np.mean(losses[:5])):
            raise AssertionError(f"[{method}] the loss did not fall: "
                                 f"{losses}")
        if not rec["trace"]["device_kernels"] > 0:
            raise AssertionError(f"[{method}] the trace shows no kernel: "
                                 f"{rec['trace']}")
        if not (tmp / f"trace_{method}" / "trace.json").exists():
            raise AssertionError(f"[{method}] no trace written")
        back = runner.load_baseline(run / f"baseline_{method}.npz", method,
                                    device=dev)
        for a, b in zip(runner.leaves_like_jax(back),
                        runner.leaves_like_jax(params)):
            if not torch.equal(a, b):
                raise AssertionError(f"[{method}] the checkpoint does not "
                                     "reload")
        hist = json.loads((run / f"baseline_{method}_history.json")
                          .read_text())
        if hist != history or hist[-1]["step"] != BASELINE_STEPS:
            raise AssertionError(f"[{method}] history {hist}")
        methods[method] = {
            "ms_per_step_median": statistics.median(ms),
            "ms_per_step_min": min(ms), "steps_per_s":
            1e3 / statistics.median(ms), "peak_gb": peak / 1e9,
            "step_trace": rec["trace"], "losses": losses,
            "params": int(sum(p.numel() for p in params.parameters()))}
        log(f"[baselines] {method}: {methods[method]}")
        del params, back
        torch.cuda.empty_cache()

    # -- each method's step on the card against the CPU --
    t0 = sync_now()
    cpu_ds = parse(MushroomParserConfig(data=tmp, load_3D_points=False),
                   "train", device="cpu")
    cam, batch = cpu_ds.get(0)
    frame = (cam,) + tuple(torch.as_tensor(np.asarray(
        batch[k].cpu() if torch.is_tensor(batch[k]) else batch[k]),
        dtype=torch.float32) for k in ("image", "sensor_depth", "normal"))
    for method in BASELINE_METHODS:
        cmp = baseline_card_vs_cpu(method, dev, frame)
        if not (cmp["loss_rel_err"] <= BASELINE_LOSS_RTOL
                and cmp["grad_rel_l2"] <= BASELINE_GRAD_L2
                and cmp["ts_max_err_bins"] <= BASELINE_TS_BINS):
            raise AssertionError(f"[{method}] card vs CPU {cmp}")
        methods[method]["card_vs_cpu"] = cmp
    seconds["card_vs_cpu"] = sync_now() - t0

    # -- the viewer: orbit renders while a Trainer steps --
    t0 = sync_now()
    with contextlib.redirect_stdout(sys.stderr):
        ds = parse(MushroomParserConfig(data=tmp), "train", device=dev)
        trainer = Trainer(ds, ds.seed(), model_cfg=ModelConfig(
            use_depth_loss=True, depth_lambda=0.2, use_normal_loss=True),
            train_cfg=TrainConfig(viewer=True, viewer_port=0,
                                  steps_per_eval_image=VIEWER_STEPS))
    seconds["viewer_setup"] = sync_now() - t0
    render_ms = []
    orbit = trainer._orbit_render

    def timed_orbit(*args, **kw):
        t = time.perf_counter()
        out = orbit(*args, **kw)  # ends in copies to the host
        render_ms.append((time.perf_counter() - t) * 1e3)
        return out

    trainer.viewer.set_render_fn(timed_orbit)
    base = f"http://127.0.0.1:{trainer.viewer.port}"
    poses = [(az, el, r, s) for az, el, r in ORBIT_POSES
             for s in ORBIT_SCALES]
    fetched, fetched_stats, errors = [], [], []

    def get(path):
        with urllib.request.urlopen(base + path, timeout=120) as resp:
            return resp.status, resp.read()

    def client():
        try:
            for az, el, r, s in poses:
                t = time.perf_counter()
                status, body = get(f"/render.png?az={az}&el={el}&r={r}"
                                   f"&scale={s}&ch=rgb")
                fetched.append(((az, el, r, s), status, body, t,
                                time.perf_counter()))
                if len(fetched) == len(poses) // 2:
                    fetched_stats.append(get("/stats.json"))
        except Exception as e:  # the phase fails on it below
            errors.append(e)

    rc.LAUNCHES.clear()
    th = threading.Thread(target=client)
    t_train = time.perf_counter()
    th.start()
    with contextlib.redirect_stdout(sys.stderr):
        trainer.train(VIEWER_STEPS, log_every=1)
    torch.cuda.synchronize()
    t_trained = time.perf_counter()
    th.join(timeout=300)
    if th.is_alive() or errors:
        raise AssertionError(f"[viewer] orbit fetches failed: {errors}")
    viewer_launches = {k: rc.LAUNCHES[k] for k in STEP_KERNELS + REDUCERS}
    want = expected_step_launches(VIEWER_STEPS, trainer.params.capacity,
                                  "reduce_segments_bykey")
    renders = VIEWER_STEPS + 1 + len(poses)  # steps, one eval, the orbits
    want["forward_tiles"] = renders
    want[expand_entry(rc, trainer.params.capacity).__name__] = renders
    if viewer_launches != want:
        raise AssertionError(f"[viewer] launches {viewer_launches}, "
                             f"expected {want}")
    base_cam = ds.get(0)[0]
    ocams = {pose: trainer.orbit_camera(trainer.params, trainer.alive, *pose)
             for pose in poses}
    sizes = {}
    for pose, status, body, _, _ in fetched:
        s = pose[3]
        want_size = (ocams[pose].width, ocams[pose].height)
        img = Image.open(_io.BytesIO(body))
        img.load()
        if status != 200 or img.size != want_size:
            raise AssertionError(f"[viewer] {status} {img.size} for scale "
                                 f"{s}, expected {want_size}")
        sizes[s] = img.size
    if len({body for pose, _, body, _, _ in fetched
            if pose[3] == 1.0}) != len(ORBIT_POSES):
        raise AssertionError("[viewer] two poses gave the same render")
    overlapped = sum(t1 > t_train and t0 < t_trained
                     for *_, t0, t1 in fetched)
    stats = json.loads(get("/stats.json")[1])
    if stats.get("step") != VIEWER_STEPS or not math.isfinite(stats["loss"]):
        raise AssertionError(f"[viewer] stats {stats}")
    status, page = get("/")
    if status != 200 or b"viewer" not in page:
        raise AssertionError("[viewer] no page")
    for ch in ("rgb", "depth"):
        status, body = get(f"/{ch}.png")
        img = Image.open(_io.BytesIO(body))
        img.load()
        if status != 200 or img.size != (base_cam.width, base_cam.height):
            raise AssertionError(f"[viewer] /{ch}.png {status} {img.size}")
    # the orbit frames' pair lists at the render's capacity, against the
    # JAX package's 2^20 cap
    cap = trainer.train_cfg.pair_capacity
    pairs = []
    for pose in poses:
        pairs.append(int(bin_frame(trainer.params, trainer.alive, ocams[pose],
                                   trainer._raster_cfg(ocams[pose])
                                   ).total_pairs))
    trainer.viewer.close()
    viewer = {
        "steps": VIEWER_STEPS, "orbit_renders": len(poses),
        "orbit_sizes": {str(k): v for k, v in sizes.items()},
        "orbit_render_ms_median": statistics.median(render_ms),
        "orbit_render_ms": render_ms,
        "orbit_fetches_during_training": overlapped,
        "train_s": t_trained - t_train, "pair_capacity": cap,
        "orbit_pairs_max": max(pairs), "orbit_pairs": pairs,
        "orbit_overflow": max(pairs) > cap,
        "orbit_over_jax_cap": max(pairs) > (1 << 20),
        "stats_mid_training": json.loads(fetched_stats[0][1])
        if fetched_stats else None}
    log(f"[viewer] {viewer}")
    del trainer, ds
    torch.cuda.empty_cache()
    seconds["viewer"] = sync_now() - t0

    # -- batch runs: two copies of the capture, one device slot --
    data_root, out_root = tmp / "batch_data", tmp / "batch_runs"
    scenes = ["room_a", "room_b"]
    for scene in scenes:
        (data_root / scene).mkdir(parents=True)
        (data_root / scene / "iphone").symlink_to(tmp / "iphone")
    cfg = batch_run.ExperimentConfig(
        max_iterations=2, extra_flags=["--parser.num-init-points",
                                       str(BATCH_SEEDS)])
    spans = []
    real_run = subprocess.run

    def recording_run(cmd, **kw):
        t = time.perf_counter()
        proc = real_run(cmd, **kw)
        spans.append((kw["env"]["DNSPLATTER_DEVICE_SLOT"], t,
                      time.perf_counter()))
        return proc

    t0 = time.perf_counter()
    with mock.patch.object(batch_run.subprocess, "run", recording_run), \
            mock.patch.dict(os.environ, {"PYTHONPATH": str(REPO)}), \
            contextlib.redirect_stdout(sys.stderr):
        results = batch_run.dispatch_jobs(cfg, data_root, out_root, scenes,
                                          device_slots=1)
    seconds["batch_run"] = time.perf_counter() - t0
    written = json.loads((out_root / "batch_results.json").read_text())
    if written != dict.fromkeys(scenes, 0) or results != written:
        for scene in scenes:
            log((out_root / scene / "train.log").read_text()[-3000:])
        raise AssertionError(f"[batch_run] results {written}")
    if ([s for s, _, _ in spans] != ["0", "0"]
            or not spans[1][1] >= spans[0][2]):
        raise AssertionError(f"[batch_run] jobs {spans}")
    for scene in scenes:
        if not (out_root / scene / "ckpt_000002.npz").exists():
            raise AssertionError(f"[batch_run] no checkpoint for {scene}")
    batch = {"jobs": len(scenes), "job_s": [b - a for _, a, b in spans],
             "slots": [s for s, _, _ in spans], "results": written}
    seconds["phase"] = sync_now() - t_phase

    summary = {"scene": "baselines_mushroom", "width": WIDTH,
               "height": HEIGHT, "baseline_steps": BASELINE_STEPS,
               "methods": methods, "viewer": viewer, "batch_run": batch,
               "seconds": seconds, "launches_viewer": viewer_launches,
               "gpu": gpu}
    for method, rep in methods.items():
        print(json.dumps({"baseline": method, "gpu": gpu,
                          **{k: v for k, v in rep.items()
                             if k != "losses"}}), flush=True)
    return summary, [], collections.Counter(viewer_launches)


# Phase 12: multi-device training on torch.distributed: the dp, gspmd and
# tile steps under NCCL at world size 1 on the train 1m state, and over
# gloo with two ranks sharing the card on the train 100k inputs.
PAR_STEPS = 3  # steps of each strategy over gloo
PAR_TRAINER_STEPS = 20  # the 2-rank Trainer: one densify event, at step 20
# Against the single-device step. World 1 (NCCL) runs the very same
# arithmetic: expected bit-equal, held at 1e-6 of each array's largest
# magnitude. Two ranks (gloo) add the gathered rows' gradients in another
# grouping (tile: the slabs' per-Gaussian sums): three Adam steps may turn
# a rounding-level gradient into a step of the learning rate where a
# gradient is near zero, so parameters are held at 1e-3 of each array's
# largest magnitude on all but PAR_FLIP_FRAC of the elements, and every
# element within PAR_MAX_ERR of it. Read on the H100 before these limits:
# dp and gspmd bit-equal; tile 5.7e-3 at most, on 2.4e-5 of the elements.
PAR_WORLD1_TOL = 1e-6
PAR_LOSS_RTOL = 1e-5
PAR_TOL = 1e-3
PAR_FLIP_FRAC = 1e-4
PAR_MAX_ERR = 2e-2
PAR_TIMEOUT = 300


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def copy_state(params, alive, adam, stats):
    """A deep copy of a training state (the steps update Adam in place)."""
    import dataclasses

    from dnsplatter_torch.models.gaussians import FIELDS, GaussianParams
    from dnsplatter_torch.train.optim import AdamState
    from dnsplatter_torch.train.strategy import RefineStats

    tree = lambda t: GaussianParams(**{  # noqa: E731
        f: getattr(t, f).clone() for f in FIELDS})
    return (tree(params), alive.clone(),
            AdamState(mu=tree(adam.mu), nu=tree(adam.nu),
                      count=dict(adam.count), accum=tree(adam.accum)),
            RefineStats(*(s.clone() for s in dataclasses.astuple(stats))))


def scaled_errors(got: dict, want: dict) -> dict:
    """Per array: the largest |got - want| over the largest |want|, the
    share of elements beyond PAR_TOL of it, and whether all are equal."""
    import torch

    out = {}
    for k, w in want.items():
        g, w = got[k].float(), w.float()
        d = (g - w).abs() / max(float(w.abs().max()), 1e-12)
        out[k] = {"max": float(d.max()),
                  "over": float((d > PAR_TOL).float().mean()),
                  "bit_equal": bool(torch.equal(g, w))}
    return out


def state_arrays(params, stats) -> dict:
    from dnsplatter_torch.models.gaussians import FIELDS

    arrays = {f: getattr(params, f) for f in FIELDS}
    arrays.update(grad_sum=stats.grad_sum, vis_count=stats.vis_count,
                  max_2d=stats.max_2d)
    return arrays


def run_parallel_world1(trainer, dev, gpu):
    """Phase 12a: from the train 1m Trainer's state, one step each through
    `train_step`, `make_dp_train_step` (dp 1), `make_sharded_train_step`
    and `make_tile_train_step` (one shard), under NCCL in a process group
    of one, black background, each after one warm-up step on a copy (the
    first NCCL call makes its communicator). Returns (summary, launches)."""
    import functools

    import torch

    from dnsplatter_torch.models.dn_model import sh_degree_to_use
    from dnsplatter_torch.ops import rasterize_cuda as rc
    from dnsplatter_torch.parallel import collectives as C
    from dnsplatter_torch.parallel import distributed as D
    from dnsplatter_torch.parallel import sharding as S
    from dnsplatter_torch.parallel import tile_sharding as T
    from dnsplatter_torch.train.trainer import train_step

    t0 = time.perf_counter()
    step = trainer.step
    i = step % len(trainer.data)
    cam, batch = trainer.data.get(i)
    batch = trainer._device_batch(i, batch)
    sh = sh_degree_to_use(step, trainer.model_cfg)
    rcfg = trainer._raster_cfg(cam)
    mc, oc = trainer.model_cfg, trainer.optim_cfg
    bg = torch.zeros(3, device=dev)
    state = copy_state(trainer.params, trainer.alive, trainer.adam,
                       trainer.stats)
    capacity = trainer.params.capacity
    D.shutdown_distributed()
    ctx = D.init_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    if ctx.backend != "nccl" or not ctx.initialized:
        raise AssertionError(f"world 1 on the card: {ctx}")
    try:
        mesh = D.make_hybrid_mesh(dp=1)
        dp_fn = D.make_dp_train_step(mc, oc, rcfg, sh, mesh)
        steps = {
            "single": functools.partial(train_step, mc, oc, rcfg, sh,
                                        background=bg),
            "dp": functools.partial(dp_fn, backgrounds=bg[None],
                                    frame_idx=[i]),
            "gspmd": functools.partial(
                S.make_sharded_train_step(mc, oc, rcfg, sh, mesh),
                background=bg),
            "tile": functools.partial(
                T.make_tile_train_step(mc, oc, rcfg, sh, mesh),
                background=bg),
        }
        rows, totals, want = {}, collections.Counter(), None
        for name, fn in steps.items():
            fn(*copy_state(*state), cam, batch, step)  # warm-up
            args = copy_state(*state)
            torch.cuda.synchronize()
            rc.LAUNCHES.clear()
            C.LOG.clear()
            t = time.perf_counter()
            out = fn(*args, cam, batch, step)
            loss = float(out[3])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            launches = {k: rc.LAUNCHES[k] for k in STEP_KERNELS + REDUCERS}
            coll = C.log_totals()
            if launches != expected_step_launches(1, capacity,
                                                  "reduce_segments_bykey"):
                raise AssertionError(f"[12a {name}] launches {launches}")
            totals.update(launches)
            arrays = state_arrays(out[0], out[2])
            row = {"ms": ms, "loss": loss, "launches": launches,
                   "collective_calls": coll["calls"],
                   "collective_bytes": coll["bytes"],
                   "collectives": sorted({r["op"] for r in C.LOG})}
            if want is None:
                want = (loss, arrays)
            else:
                errs = scaled_errors(arrays, want[1])
                row["max_scaled_err"] = max(e["max"] for e in errs.values())
                row["bit_equal"] = all(e["bit_equal"] for e in errs.values())
                if (abs(loss - want[0]) > PAR_LOSS_RTOL * abs(want[0])
                        or row["max_scaled_err"] > PAR_WORLD1_TOL):
                    raise AssertionError(f"[12a {name}] against train_step: "
                                         f"loss {loss} vs {want[0]}, {errs}")
            rows[name] = row
            del out, args
    finally:
        D.shutdown_distributed()
    summary = {"phase": "12a", "scene": "train_1m", "backend": "nccl",
               "world": 1, "capacity": capacity, "step": step,
               "pair_capacity": rcfg.pair_capacity, "steps": rows,
               "seconds": time.perf_counter() - t0, "gpu": gpu}
    return summary, dict(totals)


def parallel_references(blob, dev, state0, rcfg, mc):
    """The single-device references of phase 12b: PAR_STEPS train_steps
    (frame s % 4), and PAR_STEPS steps of one Adam update on the mean of
    frames 2s and 2s + 1's gradients (the dp semantics)."""
    import torch

    from dnsplatter_torch.models.gaussians import FIELDS, GaussianParams
    from dnsplatter_torch.train.optim import OptimConfig
    from dnsplatter_torch.train.trainer import (
        apply_gradients,
        loss_and_grads,
        train_step,
    )

    cams, batches = blob["frames"](dev)
    bg = torch.zeros(3, device=dev)
    oc = OptimConfig()
    st = copy_state(*state0)
    single = []
    for s in range(PAR_STEPS):
        i = s % len(cams)
        p, adam, stats, loss, _ = train_step(mc, oc, rcfg, 3, *st, cams[i],
                                             batches[i], s, background=bg)
        st = (p, st[1], adam, stats)
        single.append(float(loss))
    single_arrays = state_arrays(st[0], st[3])
    st = copy_state(*state0)
    dp = []
    for s in range(PAR_STEPS):
        outs = [loss_and_grads(mc, rcfg, 3, st[0], st[1], cams[i],
                               batches[i], s, background=bg)
                for i in ((2 * s) % 4, (2 * s + 1) % 4)]
        g = GaussianParams(**{f: (getattr(outs[0][2], f)
                                  + getattr(outs[1][2], f)) / 2.0
                              for f in FIELDS})
        p, adam, stats = apply_gradients(
            oc, rcfg, st[0], st[1], st[2], st[3], g, outs[0][3] + outs[1][3],
            torch.maximum(outs[0][4].radii, outs[1][4].radii),
            outs[0][4].valid | outs[1][4].valid, s)
        st = (p, st[1], adam, stats)
        dp.append(float((outs[0][0] + outs[1][0]) / 2.0))
    return {"single": (single, single_arrays),
            "dp": (dp, state_arrays(st[0], st[3]))}


def parallel_blob(inputs, capacity, pair_capacity):
    """What the ranks of phase 12b load: the frames, the seed points, the
    model configuration, the capacities."""
    import dataclasses

    import numpy as np

    return {"cams": [(float(c.fx), float(c.fy), float(c.cx), float(c.cy),
                      c.c2w.cpu().numpy(), c.width, c.height)
                     for c in inputs["cams"]],
            "batches": [{k: np.asarray(v.cpu() if hasattr(v, "cpu") else v)
                         for k, v in b.items()}
                        for b in inputs["data"].batches],
            "seeds": inputs["seeds"], "capacity": capacity,
            "pair_capacity": pair_capacity,
            "model_cfg": dataclasses.asdict(inputs["model_cfg"])}


def blob_frames(blob, dev):
    import numpy as np
    import torch

    from dnsplatter_torch.ops.camera import Camera

    cams = [Camera.create(fx, fy, cx, cy, np.asarray(c2w), w, h, device=dev)
            for fx, fy, cx, cy, c2w, w, h in blob["cams"]]
    batches = [{k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                for k, v in b.items()} for b in blob["batches"]]
    return cams, batches


def blob_state(blob, dev):
    import numpy as np

    from dnsplatter_torch.models.gaussians import init_from_points
    from dnsplatter_torch.train.optim import init_adam
    from dnsplatter_torch.train.strategy import init_stats

    pts, cols = blob["seeds"]
    params, alive, _ = init_from_points(np.random.default_rng(7), pts, cols,
                                        sh_degree=3,
                                        capacity=blob["capacity"],
                                        device=dev)
    return params, alive, init_adam(params), init_stats(blob["capacity"], dev)


def parallel_rank(rank: int, port: int, tmp: Path) -> int:
    """One rank of phase 12b (`chip_smoke.py --parallel-rank RANK PORT
    DIR`): gloo on the shared card; PAR_STEPS steps each of the dp (dp 2),
    gspmd and tile strategies from the blob's state, then a 2-rank Trainer
    through one refinement event. Writes DIR/rank<r>.pt."""
    import torch

    sys.path.insert(0, str(REPO))
    from dnsplatter_torch.models.dn_model import ModelConfig
    from dnsplatter_torch.ops import rasterize_cuda as rc
    from dnsplatter_torch.ops.rasterize import RasterizeConfig
    from dnsplatter_torch.parallel import collectives as C
    from dnsplatter_torch.parallel import distributed as D
    from dnsplatter_torch.parallel import sharding as S
    from dnsplatter_torch.parallel import tile_sharding as T
    from dnsplatter_torch.train.optim import OptimConfig
    from dnsplatter_torch.train.trainer import TrainConfig, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dnsplatter_torch import resolve_device

    ctx = D.init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    dev = resolve_device(None)
    blob = torch.load(tmp / "par_inputs.pt", weights_only=False)
    cams, batches = blob_frames(blob, dev)
    mc = ModelConfig(**blob["model_cfg"])
    oc = OptimConfig()
    state0 = blob_state(blob, dev)
    bg = torch.zeros(3, device=dev)
    while not (tmp / "go").exists():  # the parent's references run first
        time.sleep(0.05)
    res = {"rank": rank, "backend": ctx.backend, "strategies": {}}
    launches = collections.Counter()
    for kind in ("dp", "gspmd", "tile"):
        mesh = D.make_hybrid_mesh(dp=2 if kind == "dp" else 1)
        cap = blob["pair_capacity"] * (2 if kind == "tile" else 1)
        rcfg = RasterizeConfig(width=WIDTH, height=HEIGHT, chunk=128,
                               tile_block=32, pair_capacity=cap,
                               backend="cuda", sort_scheme="depthq")
        if kind == "dp":
            fn = D.make_dp_train_step(mc, oc, rcfg, 3, mesh)
        else:
            make = (T.make_tile_train_step if kind == "tile"
                    else S.make_sharded_train_step)
            fn = make(mc, oc, rcfg, 3, mesh)
        shard = (D.shard_state_hybrid if kind == "dp"
                 else S.shard_gaussian_state)
        st = shard(mesh, *copy_state(*state0))
        rows = []
        for s in range(PAR_STEPS):
            if kind == "dp":
                frames = [(2 * s + r) % len(cams) for r in range(2)]
                i = frames[mesh.dp_axis.rank]
                kw = dict(backgrounds=bg.expand(2, 3), frame_idx=frames)
            else:
                i = s % len(cams)
                kw = dict(background=bg)
            torch.cuda.synchronize()
            rc.LAUNCHES.clear()
            C.LOG.clear()
            t = time.perf_counter()
            p, adam, stats, loss, _ = fn(*st, cams[i], batches[i], s, **kw)
            loss = float(loss)
            torch.cuda.synchronize()
            rows.append({"ms": (time.perf_counter() - t) * 1e3,
                         "loss": loss, **C.log_totals(),
                         "launches": {k: rc.LAUNCHES[k]
                                      for k in STEP_KERNELS + REDUCERS}})
            launches.update(rows[-1]["launches"])
            st = (p, st[1], adam, stats)
        arrays = {k: D.host_local_value(v, mesh)
                  for k, v in state_arrays(st[0], st[3]).items()}
        res["strategies"][kind] = {"steps": rows,
                                   "shard_rows": st[0].capacity,
                                   "mesh": mesh.shape}
        if rank == 0:
            torch.save(arrays, tmp / f"par_{kind}.pt")
        del st, p, adam, stats
    # -- the Trainer over two ranks, through one refinement event --
    out_dir = tmp / f"trainer_rank{rank}"
    tr = Trainer(Frames(cams, batches), blob["seeds"], model_cfg=mc,
                 train_cfg=TrainConfig(devices=2, steps_per_eval_image=0),
                 out_dir=out_dir)
    n0 = tr._alive_count()
    rc.LAUNCHES.clear()
    torch.cuda.synchronize()
    t = time.perf_counter()
    hist = tr.train(PAR_TRAINER_STEPS, log_every=PAR_TRAINER_STEPS)
    torch.cuda.synchronize()
    trainer_launches = {k: rc.LAUNCHES[k] for k in STEP_KERNELS + REDUCERS}
    launches.update(trainer_launches)
    res["trainer"] = {
        "n0": n0, "alive": tr._alive_count(), "loss": hist[-1]["loss"],
        "ms_per_step": (time.perf_counter() - t) * 1e3 / PAR_TRAINER_STEPS,
        "pair_capacity": tr.train_cfg.pair_capacity,
        "capacity": tr.params.capacity * 2, "launches": trainer_launches,
        "files": sorted(x.name for x in out_dir.glob("ckpt_*.npz"))
        if out_dir.exists() else []}
    res["launches"] = dict(launches)
    torch.save(res, tmp / f"rank{rank}.pt")
    D.shutdown_distributed()
    return 0


def run_parallel_gloo(dev, gpu, tmp: Path):
    """Phase 12b: two ranks on the one card over gloo, on the train 100k
    inputs (see `parallel_rank`); the parent holds each strategy's last
    state against its single-device reference and the 2-rank Trainer's
    alive count against a single-process Trainer's. Returns (summary,
    launches summed over the ranks)."""
    import contextlib
    import os

    import torch

    from dnsplatter_torch.train.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    _, n, shift, extent, cap = SCENES[0]
    inputs = training_inputs(n, shift, extent, cap, 0, dev, REFINE_KW)
    with contextlib.redirect_stdout(sys.stderr):
        single_tr = Trainer(inputs["data"], inputs["seeds"],
                            model_cfg=inputs["model_cfg"],
                            train_cfg=TrainConfig(devices=0,
                                                  steps_per_eval_image=0))
    blob = parallel_blob(inputs, single_tr.params.capacity,
                         single_tr.train_cfg.pair_capacity)
    torch.save(blob, tmp / "par_inputs.pt")
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--parallel-rank", str(r), str(port),
                               str(tmp)], env=env, cwd=REPO, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        # -- the references, while the ranks start --
        blob["frames"] = lambda d: blob_frames(blob, d)
        state0 = blob_state(blob, dev)
        from dnsplatter_torch.ops.rasterize import RasterizeConfig

        rcfg = RasterizeConfig(width=WIDTH, height=HEIGHT, chunk=128,
                               tile_block=32,
                               pair_capacity=blob["pair_capacity"],
                               backend="cuda", sort_scheme="depthq")
        refs = parallel_references(blob, dev, state0, rcfg,
                                   inputs["model_cfg"])
        del state0
        n0_single = int(single_tr.alive.sum())
        with contextlib.redirect_stdout(sys.stderr):
            single_hist = single_tr.train(PAR_TRAINER_STEPS,
                                          log_every=PAR_TRAINER_STEPS)
        single_alive = int(single_tr.alive.sum())
        del single_tr
        torch.cuda.empty_cache()
        (tmp / "go").touch()
        deadline = time.monotonic() + PAR_TIMEOUT
        codes = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
                 for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for f in logs:
            f.close()
    if codes != [0, 0]:
        tails = "\n".join((tmp / f"rank{r}.log").read_text()[-3000:]
                          for r in range(2))
        raise AssertionError(f"[12b] rank exit codes {codes}:\n{tails}")
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    rows, totals = {}, collections.Counter()
    want_launch = expected_step_launches(1, blob["capacity"],
                                         "reduce_segments_bykey")
    for kind in ("dp", "gspmd", "tile"):
        ref_loss, ref_arrays = refs["dp" if kind == "dp" else "single"]
        got = torch.load(tmp / f"par_{kind}.pt", weights_only=False)
        errs = scaled_errors({k: torch.as_tensor(v) for k, v in got.items()},
                             {k: v.cpu() for k, v in ref_arrays.items()})
        steps = [r["strategies"][kind]["steps"] for r in ranks]
        losses = [s["loss"] for s in steps[0]]
        for a, b in zip(losses, ref_loss):
            if abs(a - b) > PAR_LOSS_RTOL * abs(b):
                raise AssertionError(f"[12b {kind}] losses {losses} vs "
                                     f"{ref_loss}")
        bad = {k: e for k, e in errs.items()
               if e["over"] > PAR_FLIP_FRAC or e["max"] > PAR_MAX_ERR}
        if bad:
            raise AssertionError(f"[12b {kind}] against one device: {bad}")
        # every rank rasterizes the gathered rows (or its frame's whole
        # state): the resident expansion at 126,976 Gaussians
        for rank_steps in steps:
            for s in rank_steps:
                if s["launches"] != want_launch:
                    raise AssertionError(f"[12b {kind}] launches "
                                         f"{s['launches']}, expected "
                                         f"{want_launch}")
        ms = [s["ms"] for s in steps[0]]
        rows[kind] = {
            "mesh": ranks[0]["strategies"][kind]["mesh"],
            "ms_per_step": statistics.median(ms), "ms": ms,
            "losses": losses, "ref_losses": ref_loss,
            "collective_calls_per_step": steps[0][-1]["calls"],
            "collective_bytes_per_step": steps[0][-1]["bytes"],
            "staged_bytes_per_step": steps[0][-1]["staged_bytes"],
            "max_scaled_err": max(e["max"] for e in errs.values()),
            "share_over_tol": max(e["over"] for e in errs.values()),
            "bit_equal": all(e["bit_equal"] for e in errs.values())}
    t0r, t1r = (r["trainer"] for r in ranks)
    if not (t0r["alive"] == t1r["alive"] == single_alive):
        raise AssertionError(f"[12b trainer] alive {t0r['alive']} / "
                             f"{t1r['alive']} vs one process {single_alive}")
    if t0r["alive"] == t0r["n0"]:
        raise AssertionError("[12b trainer] the refinement event changed "
                             "nothing")
    if t0r["files"] != [f"ckpt_{PAR_TRAINER_STEPS:06d}.npz"] or t1r["files"]:
        raise AssertionError(f"[12b trainer] checkpoints rank 0 "
                             f"{t0r['files']}, rank 1 {t1r['files']}")
    for r in ranks:
        totals.update(r["launches"])
    summary = {"phase": "12b", "scene": "train_100k", "backend": "gloo",
               "world": 2, "card_shared": True, "strategies": rows,
               "trainer": {"alive": t0r["alive"], "alive_single": single_alive,
                           "n0": t0r["n0"], "n0_single": n0_single,
                           "loss": t0r["loss"],
                           "loss_single": single_hist[-1]["loss"],
                           "ms_per_step": t0r["ms_per_step"],
                           "pair_capacity": t0r["pair_capacity"],
                           "files_rank0": t0r["files"],
                           "files_rank1": t1r["files"]},
               "launches_by_rank": [r["launches"] for r in ranks],
               "seconds": time.perf_counter() - t0, "gpu": gpu}
    return summary, dict(totals)


def oracle_grad_check(dev):
    """Gradients of the kernel path (forward_tiles, backward_tiles, the
    key sort, the reduction) against torch.autograd through the dense
    oracle, per array scaled by its largest magnitude: rtol 2e-2, atol
    2e-3 under the bf16-packed reduction (the JAX package's tolerance for
    it), rtol 1e-4 / atol 1e-5 under the float32 one."""
    import numpy as np
    import torch

    from dnsplatter_torch.data.synthetic import make_gt_gaussians, ring_cameras
    from dnsplatter_torch.ops import rasterize_cuda as rc
    from dnsplatter_torch.ops.projection import project_gaussians
    from dnsplatter_torch.ops.rasterize import RasterizeConfig, rasterize
    from dnsplatter_torch.ops.rasterize_ref import rasterize_pixels_ref

    n, w, h = 600, 96, 64
    gt, _ = make_gt_gaussians(np.random.default_rng(11), n, device=dev)
    cam = ring_cameras(1, width=w, img_height=h, focal=90.0, device=dev)[0]
    with torch.no_grad():
        proj = project_gaussians(gt.means, gt.quats, torch.exp(gt.scales),
                                 cam.viewmat(), cam.fx, cam.fy, cam.cx,
                                 cam.cy, w, h)
    gen = torch.Generator(dev).manual_seed(3)
    feats = torch.rand(n, 7, device=dev, generator=gen)
    op = torch.sigmoid(gt.opacities)
    w_img = torch.randn(h, w, 7, device=dev, generator=gen)
    w_a = torch.randn(h, w, 1, device=dev, generator=gen)
    names = ["means2d", "conics", "opacities", "features"]
    report = {"oracle_grad_check": f"kernel path vs dense oracle, {w}x{h}, "
              f"{n} Gaussians, 7 channels"}
    for scheme, reduce, reducer, rtol, atol in (
            ("depthq", "sortpack", "reduce_segments_bykey", GRAD_RTOL,
             GRAD_ATOL),
            ("packed", "sortpack", "reduce_segments_bykey", GRAD_RTOL,
             GRAD_ATOL),
            ("packed", "segsum", "reduce_segments", SEGSUM_RTOL,
             SEGSUM_ATOL)):
        cfg = RasterizeConfig(width=w, height=h, chunk=128,
                              pair_capacity=1 << 15, sort_scheme=scheme,
                              grad_reduce=reduce)
        tag = scheme if reduce == "sortpack" else f"{scheme}.{reduce}"
        grads = {}
        for path in ("kernel", "oracle"):
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (proj.means2d, proj.conics, op, feats)]
            before = (rc.LAUNCHES["backward_tiles"], rc.LAUNCHES[reducer])
            if path == "kernel":
                img, a = rasterize(leaves[0], leaves[1], proj.depths,
                                   leaves[2], leaves[3], proj.valid, cfg,
                                   radii=proj.radii)
            else:
                img, a = rasterize_pixels_ref(
                    leaves[0], leaves[1], proj.depths, leaves[2], leaves[3],
                    proj.valid, w, h, radii=proj.radii)
            loss = (img * w_img).sum() + (a * w_a).sum()
            grads[path] = torch.autograd.grad(loss, leaves)
            after = (rc.LAUNCHES["backward_tiles"], rc.LAUNCHES[reducer])
            if path == "kernel" and after != (before[0] + 1, before[1] + 1):
                raise AssertionError("the autograd function did not launch "
                                     "both backward kernels")
        for name, gk, go in zip(names, grads["kernel"], grads["oracle"]):
            scale = max(float(go.abs().max()), 1e-6)
            err = (gk - go).abs() / scale
            allowed = atol + rtol * go.abs() / scale
            worst = float((err - allowed).max())
            report[f"{tag}.{name}.max_scaled_err"] = float(err.max())
            if worst > 0.0:
                raise AssertionError(
                    f"gradient of {name} under {tag} is off the dense "
                    f"oracle's by {float(err.max())} of its scale")
    return report


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        log("chip_smoke: PyTorch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs only on the GPU")
        return 2
    if not (REPO / "dnsplatter_torch" / "csrc").is_dir():
        log("chip_smoke: run from a checkout of the repository (the "
            "dnsplatter_torch package is missing)")
        return 2
    sys.path.insert(0, str(REPO))
    # Float32 products and convolutions stay full FP32 on the card (the
    # defaults for products, set here so nothing upstream changes them).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from dnsplatter_torch.ops import kernel_build
    from dnsplatter_torch.ops import rasterize_cuda as rc

    gpu = gpu_name_and_power()
    print(gpu, flush=True)
    t0 = time.perf_counter()
    reports = kernel_build.build()
    build_s = time.perf_counter() - t0
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")
    print(json.dumps({"build_seconds": build_s,
                      "built": sorted(reports)}), flush=True)

    import dataclasses

    from dnsplatter_torch.train.trainer import TrainConfig

    dev = torch.device("cuda")
    totals = collections.Counter()
    kernel_rows = {}

    def keep(summary, reps, launches, *_):
        totals.update(launches)
        for rep in reps:
            print(json.dumps(rep), flush=True)
            kernel_rows[(rep["kernel"], rep["scene"])] = rep
        print(json.dumps(summary), flush=True)

    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=REPO) as tmp:
        for seed, (name, n, shift, extent, cap) in enumerate(SCENES):
            keep(*run_scene(name, n, shift, extent, cap, seed, dev, gpu,
                            Path(tmp)))
    print(json.dumps(oracle_check(dev)), flush=True)
    keep(*run_big_scene(dev, gpu))
    torch.cuda.empty_cache()

    (_, n, shift, extent, cap), (_, n1, shift1, extent1, cap1) = SCENES
    # -- 100k: the default path with refinement, then path D on its state
    inputs = training_inputs(n, shift, extent, cap, 0, dev, REFINE_KW)
    *kept, trainer = run_training("train_100k", inputs, dev, gpu,
                                  TRAIN_STEPS_100K, True)
    keep(*kept)
    rcfg = dataclasses.replace(trainer._raster_cfg(inputs["cams"][0]),
                               sort_scheme="packed", grad_reduce="segsum")
    keep(*run_step_path("train_100k_segsum", trainer, rcfg,
                        "reduce_segments", gpu, grad_atol=SEGSUM_VS_BF16_ATOL))
    del trainer, inputs
    torch.cuda.empty_cache()
    # -- 1m: the default path, path B through its own Trainer, path C on
    # that Trainer's state
    inputs = training_inputs(n1, shift1, extent1, cap1, 1, dev, {})
    *kept, trainer = run_training("train_1m", inputs, dev, gpu,
                                  TRAIN_STEPS_1M, False)
    keep(*kept)
    step_ms_1m = kept[0]["ms_per_step"]
    capacity_1m = trainer.params.capacity
    # -- phase 12a: the multi-device steps at world 1 on this state --
    summary12, launches12 = run_parallel_world1(trainer, dev, gpu)
    keep(summary12, [], launches12)
    del trainer
    *kept, trainer = run_training(
        "train_1m_packed", inputs, dev, gpu, PATH_STEPS, False,
        train_cfg=TrainConfig(sort_scheme="auto", compact_frac=0.0),
        reducer="reduce_segments_packed")
    keep(*kept)
    rcfg = dataclasses.replace(trainer._raster_cfg(inputs["cams"][0]),
                               sort_scheme="packed32", reduce_pieces=4,
                               compact_frac=0.0)
    keep(*run_step_path("train_1m_pieces", trainer, rcfg,
                        "reduce_segments_packed_multi", gpu))
    del trainer, inputs
    print(json.dumps(oracle_grad_check(dev)), flush=True)
    torch.cuda.empty_cache()
    for scene, rows in SH_ROWS:
        keep({"phase": "6", "sh_colors_rows": rows}, [
            check_sh_colors(rc, rows, scene, gpu)], {})
        torch.cuda.empty_cache()
    for scene, rows, width, height, focal in PS_ROWS:
        keep({"phase": "6", "project_screen_rows": rows}, [
            check_project_screen(rc, rows, scene, width, height, focal,
                                 gpu)], {})
        torch.cuda.empty_cache()
    for scene, height, width in SSIM_FRAMES:
        keep({"phase": "6", "ssim_frame": [height, width]}, [
            check_ssim(rc, scene, height, width, gpu)], {})
        torch.cuda.empty_cache()
    # -- the file-backed MuSHRoom path --
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=REPO) as tmp:
        keep(*run_mushroom(dev, gpu, Path(tmp)))
        torch.cuda.empty_cache()
        # -- the CLI and the mesh chain on the same capture --
        cli_run = run_cli_mesh(dev, gpu, Path(tmp))
        keep(*cli_run)
        torch.cuda.empty_cache()
        # -- monocular priors, training on them, cli render --
        keep(*run_priors(dev, gpu, Path(tmp), cli_run[0]))
        torch.cuda.empty_cache()
        # -- the baselines, the viewer, batch runs --
        keep(*run_baselines(dev, gpu, Path(tmp)))
        torch.cuda.empty_cache()
        # -- phase 12b: two ranks over gloo on the one card --
        summary12, launches12 = run_parallel_gloo(dev, gpu, Path(tmp))
        keep(summary12, [], launches12)
    from dnsplatter_torch.utils.scaling import scaling_statement

    # at the size of the step it divides: the train 1m state and frame
    print(json.dumps({"phase": "12", "scaling_statement": scaling_statement(
        step_ms_1m, capacity=capacity_1m, width=WIDTH, height=HEIGHT),
        "step_ms_1chip_from": "train_1m, phase 4", "gpu": gpu}), flush=True)

    src = "dnsplatter_torch/csrc/"
    pallas = "dnsplatter_tpu/ops/rasterize_pallas.py"
    kinds = (
        ("expand_segments", "train_100k", "expand_segments.cu",
         f"{pallas}:248"),
        ("expand_segments_stream", "train_1m", "expand_segments.cu",
         f"{pallas}:315"),
        ("forward_tiles", "1m", "forward_tiles.cu", f"{pallas}:527"),
        ("backward_tiles", "train_1m", "backward_tiles.cu",
         f"{pallas}:1289"),
        ("reduce_segments_bykey", "train_1m", "reduce_segments_bykey.cu",
         f"{pallas}:881"),
        ("reduce_segments_packed", "train_1m_packed",
         "reduce_segments_packed.cu", f"{pallas}:745"),
        ("reduce_segments_packed_multi", "train_1m_pieces",
         "reduce_segments_packed_multi.cu", f"{pallas}:997"),
        ("reduce_segments", "train_100k_segsum", "reduce_segments.cu",
         f"{pallas}:619"),
        ("cumsum_lanes_i32", "2p24", "cumsum_lanes_i32.cu", f"{pallas}:117"),
        ("sh_colors", "big_3m", "sh_colors.cu",
         "none: dnsplatter_tpu/ops/sh.py eval_sh, left to XLA"),
        ("project_screen", "big_3m", "project_screen.cu",
         "none: dnsplatter_tpu/ops/projection.py project_gaussians and "
         "normals.py, left to XLA"),
        ("ssim", "big_3m", "ssim.cu",
         "none: dnsplatter_tpu/models/losses.py ssim, left to XLA"),
    )
    kernels = []
    for kname, scene, source, replaces in kinds:
        rep = kernel_rows[(kname, scene)]
        if totals[kname] == 0:
            raise AssertionError(f"{kname} never launched on the main path")
        kernels.append({
            "name": kname, "route": "cuda", "source": src + source,
            "replaces": replaces, "launches": totals[kname],
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "scene": scene,
        })
    print(json.dumps({"script_seconds": time.perf_counter() - t_start}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(int(sys.argv[2]), int(sys.argv[3]),
                               Path(sys.argv[4])))
    sys.exit(main())
