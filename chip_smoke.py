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
   just after. Metrics must be finite (LPIPS is not ported and reports
   NaN), every camera's pair list must fit the capacity, and each kernel
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
   Times: device time per call, from a batch of calls queued back to back
   behind a spin kernel between one pair of CUDA events (median of three
   batches), so the host's per-call cost is not in it. The bound is the
   larger of the bytes the function must move / 3.35 TB/s and its FP32
   work / 67 TFLOP/s (H100 SXM data sheet), counted on this run's data.
7. The kernel path against the port's dense oracle on small scenes: the
   forward, and the gradients of the autograd function (rtol 2e-2 / atol
   2e-3 of each array's largest magnitude) under depthq and packed keys;
   under `segsum`, which rounds nothing to bf16, rtol 1e-4 / atol 1e-5.

Prints one JSON line per kernel and scene, one per scene, a `kernels`
line, the card's name and power limit, and last
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


def bin_frame(params, alive, cam, cfg):
    """The port's bin_gaussians on exactly the inputs `render` hands the
    rasterizer for this camera."""
    import torch

    from dnsplatter_torch.ops.projection import project_gaussians
    from dnsplatter_torch.ops.rasterize import bin_gaussians

    with torch.no_grad():
        opac = torch.sigmoid(params.opacities)
        proj = project_gaussians(
            params.means, params.quats, torch.exp(params.scales),
            cam.viewmat(), cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
            cam.height, opacities=opac)
        validf = (proj.valid & (alive > 0.5)).float()
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
        if k.startswith("rgb_lpips") or k == "lpips_kind":
            continue
        if not (isinstance(v, (int, float)) and math.isfinite(v)):
            raise AssertionError(f"[{name}] metric {k} = {v}")
    if metrics.get("lpips_kind") != "not_ported":
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
        "launches": launches, "gpu": gpu,
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

    # the layout at this size: no overflow, every tile front to back
    # (pair_gauss indexes the depth-sorted order, so it must ascend)
    totals, visible = [], []
    for cam in cams:
        b = bin_frame(served, alive, cam, cfg)
        total = int(b.total_pairs)
        totals.append(total)
        visible.append(int((b.gauss_starts[1:] > b.gauss_starts[:-1]).sum()))
        if total > capacity or int(b.starts[-1]) != total:
            raise AssertionError(f"[2p24] {total} pairs overflow {capacity}")
        pg = b.pair_gauss[:total].long()
        slot = torch.arange(1, total, device=dev)
        tile = torch.searchsorted(b.starts.long(), slot, right=True)
        prev = torch.searchsorted(b.starts.long(), slot - 1, right=True)
        if bool(((pg[1:] <= pg[:-1]) & (tile == prev)).any()):
            raise AssertionError("[2p24] a tile's list is out of depth order")
        del b, pg, slot, tile, prev
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


def expected_step_launches(steps: int, capacity: int, reducer: str) -> dict:
    """Once a step: one expand entry (by the state's capacity), the two
    tile kernels and the configuration's reduction; the others never."""
    want = dict.fromkeys(STEP_KERNELS + REDUCERS, 0)
    stream = capacity + 1 > (1 << 18)
    want["expand_segments_stream" if stream else "expand_segments"] = steps
    want["forward_tiles"] = want["backward_tiles"] = want[reducer] = steps
    return want


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
                                       STEP_KERNELS + REDUCERS)
    want = expected_step_launches(steps, trainer.params.capacity, reducer)
    if launches != want:
        raise AssertionError(f"[{label}] launches {launches}, "
                             f"expected {want}")
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
