#!/usr/bin/env python3
"""Serve a trained scene with dnsplatter_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Prints the card's name and power limit, builds every CUDA kernel of
   `dnsplatter_torch/csrc` with nvcc (one process per source, in
   parallel) and prints the build time.
2. Main path, for two synthetic scenes at 1024x576, SH degree 3, seven
   composited channels: 100k Gaussians (pair capacity 1,441,792: the
   resident `expand_segments` entry) and 1M Gaussians (scale shift
   -ln(10)/3, extent 1.5, capacity 5,242,880: the streamed entry). Each
   scene's perturbed Gaussians go through a checkpoint in the JAX
   package's npz format, `load_checkpoint_arrays` and `evaluate` over four
   ring cameras, with every launch counter set to 0 just before and read
   just after. Metrics must be finite (LPIPS is not ported and reports
   NaN), every camera's pair list must fit the capacity, and each kernel
   of the path must have launched once per rendered frame.
3. Each kernel against its plain PyTorch version, on the card, at the
   inputs the main path gives it (captured from camera 0): expand_segments
   bit-equal with int32 and float32 rows; forward_tiles image / t_final
   within 1e-4 (image: of its max) on every pixel whose `last` agrees.
   The kernel composites with a running product, the plain version with
   exp of summed log1p (the Pallas arithmetic), so a pixel whose
   transmittance lands within rounding of the 1e-4 cutoff can stop one
   splat earlier or later. At most 20 pixels of a frame may do so, and
   each must show it: the version that went on stopped with T within
   0.1% of 1e-4, and its image moved by no more than that one splat
   (|dT| times the largest feature) plus the tolerance.
   Times: device time per call, from a batch of calls queued back to back
   behind a spin kernel between one pair of CUDA events (median of three
   batches), so the host's per-call cost is not in it. The bound is the
   larger of the bytes the function must move / 3.35 TB/s and its FP32
   work / 67 TFLOP/s (H100 SXM data sheet), counted on this run's data.
4. The kernel path against the port's dense oracle on a small scene.

Prints one JSON line per kernel and scene, one per scene, a `kernels`
line, the card's name and power limit, and last
{"ok": true, "device": {...}}. Needs CUDA: without it, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

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
FWD_TOL = 1e-4
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


def forward_work(payload, starts, counts, n_tiles: int, tile: int,
                 tiles_x: int, last, k: int = 128):
    """The least work of forward_tiles on these inputs, per pixel as (T, P)
    tensors, from the plain version's `last`: (evaluated, composited).

    A pixel composites every hit up to `last`. The first hit past `last`,
    if any, is the Gaussian that ended it: the pixel must evaluate its
    list up to and including it, else the whole list. A tile needs its
    pairs up to the largest `evaluated` of its pixels."""
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
    evaluated = cnt[:, None].expand(n_tiles, p).clone()
    composited = torch.zeros((n_tiles, p), dtype=torch.int64, device=dev)
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
        composited += (hit & (jj <= last)).sum(dim=2)
        ender = torch.where(hit & (jj > last), jj, 1 << 30).amin(dim=2)
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


def pair_totals(params, alive, cams, cfg):
    """total_pairs of the port's bin_gaussians for each camera, on exactly
    the inputs `render` hands the rasterizer."""
    import torch

    from dnsplatter_torch.ops.projection import project_gaussians
    from dnsplatter_torch.ops.rasterize import bin_gaussians

    totals = []
    with torch.no_grad():
        for cam in cams:
            opac = torch.sigmoid(params.opacities)
            proj = project_gaussians(
                params.means, params.quats, torch.exp(params.scales),
                cam.viewmat(), cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
                cam.height, opacities=opac)
            validf = (proj.valid & (alive > 0.5)).float()
            b = bin_gaussians(cfg, proj.means2d, proj.depths, proj.radii_xy,
                              validf)
            totals.append(int(b.total_pairs))
    return totals


def check_expand(rc, args, entry, name, scene, gpu):
    """Kernel vs plain, int32 and float32 rows; returns the report."""
    import torch

    vals, starts, out_len = args
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

    class Frames:
        def __init__(self, cams, batches):
            self.cams, self.batches = cams, batches

        def __len__(self):
            return len(self.cams)

        def get(self, i):
            return self.cams[i], self.batches[i]

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
    stream = n + 1 > (1 << 18)
    want = {"expand_segments": 0 if stream else frames,
            "expand_segments_stream": frames if stream else 0,
            "forward_tiles": frames}
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
    entry = rc.expand_segments_stream if stream else rc.expand_segments
    reports = [check_expand(rc, expand.call_args.args, entry,
                            entry.__name__, name, gpu),
               check_forward(rc, fwd.call_args.args, name, gpu)]
    for rep in reports:
        rep["launches_per_frame"] = 1
        rep["launches_main_path"] = launches[rep["kernel"]]
    summary = {
        "scene": name, "n_gaussians": n, "width": WIDTH, "height": HEIGHT,
        "pair_capacity": capacity, "pair_totals": totals,
        "ms_per_frame": ms_frame,
        "mpix_per_s": WIDTH * HEIGHT / (ms_frame * 1e3),
        "eval_fps": metrics["fps"], "psnr": metrics["rgb_psnr"],
        "ssim": metrics["rgb_ssim"], "depth_abs_rel":
            metrics["depth_abs_rel"], "normal_mae": metrics["normal_mae"],
        "launches": launches, "gpu": gpu,
    }
    return summary, reports, launches


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

    dev = torch.device("cuda")
    totals = {"expand_segments": 0, "expand_segments_stream": 0,
              "forward_tiles": 0}
    kernel_rows = {}
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=REPO) as tmp:
        for seed, (name, n, shift, extent, cap) in enumerate(SCENES):
            summary, reps, launches = run_scene(
                name, n, shift, extent, cap, seed, dev, gpu, Path(tmp))
            for k, v in launches.items():
                totals[k] += v
            for rep in reps:
                print(json.dumps(rep), flush=True)
                kernel_rows[(rep["kernel"], name)] = rep
            print(json.dumps(summary), flush=True)
    print(json.dumps(oracle_check(dev)), flush=True)

    src = "dnsplatter_torch/csrc/"
    kinds = (
        ("expand_segments", "100k", "expand_segments.cu",
         "dnsplatter_tpu/ops/rasterize_pallas.py:248"),
        ("expand_segments_stream", "1m", "expand_segments.cu",
         "dnsplatter_tpu/ops/rasterize_pallas.py:315"),
        ("forward_tiles", "1m", "forward_tiles.cu",
         "dnsplatter_tpu/ops/rasterize_pallas.py:527"),
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
