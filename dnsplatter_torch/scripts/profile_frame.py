"""Where one served frame's, or one training step's, time goes, on the GPU.

    python -m dnsplatter_torch.scripts.profile_frame [--n 1000000] [--train]

Builds chip_smoke.py's synthetic scene (make_gt_gaussians with real
degree-3 SH, ring cameras at 1024x576, focal 700), runs a few warm-up
frames, then profiles `--frames` frames with torch.profiler (CPU + CUDA
activity): `get_outputs` on the scene itself, or with `--train` steps of
`Trainer.train` at the Trainer's defaults on seed points perturbed from
the scene, against targets the port rendered (chip_smoke.py's training
scene). Prints one JSON line: host ms per frame, device-busy ms per frame
(the sum of kernel times), the device's idle share, the kernels and
operators that take the most device time, and each stage the program's
spans (`utils/profiling.SPANS`) mark: the device time of the kernels
launched inside it (matched to their launch by the profiler's correlation
id, on any thread, inclusive of the stages nested in it), its stream time
and host time from the recorder, its parent, and the recorder's counters
per frame. Runs only on the card.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import json
import math
import sys
import time
from typing import Dict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dnsplatter_torch.data.synthetic import make_gt_gaussians, ring_cameras
from dnsplatter_torch.eval.evaluator import eval_raster_config
from dnsplatter_torch.models.dn_model import ModelConfig, get_outputs
from dnsplatter_torch.utils import profiling


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _merged(ivs):
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def stage_device_us(events) -> Dict[str, float]:
    """{span: device time (us) of the operations launched inside it}. A
    device operation shares its correlation id with the runtime call (a
    launch, copy or memset) that issued it; it belongs to a span when that
    call started inside one of the span's host ranges, on any thread (the
    autograd engine launches the backward from threads of its own, the
    port's kernels are launched through ctypes)."""
    ranges: Dict[str, list] = {}
    launch_at, ops = {}, []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name not in profiling.SPANS:
                ops.append((e.id, s, t - s))
        elif e.name in profiling.SPANS:
            ranges.setdefault(e.name, []).append((s, t))
        elif (e.name.startswith(("cuda", "cu"))
              and not e.name.startswith("cub")):
            launch_at[e.id] = s
    out = {}
    for name, ivs in ranges.items():
        ivs = _merged(ivs)
        starts = [a for a, _ in ivs]
        total = 0.0
        for cid, s, d in ops:
            at = launch_at.get(cid, s)
            k = bisect.bisect_right(starts, at) - 1
            if k >= 0 and at < ivs[k][1]:
                total += d
        out[name] = total
    return out


def _trainer(args, dev, gt, alive, cam_list, cfg):
    """chip_smoke.py's training scene: targets rendered by the port, seed
    points perturbed from the ground truth, the Trainer's defaults."""
    from dnsplatter_torch.data.synthetic import SyntheticScene, render_batches
    from dnsplatter_torch.ops.sh import sh_to_rgb
    from dnsplatter_torch.train.trainer import TrainConfig, Trainer

    data = SyntheticScene(
        cameras=cam_list, gt_params=gt, gt_alive=alive,
        batches=render_batches(gt, alive, cam_list, lambda cam: cfg,
                               sh_degree=3))
    rng = np.random.default_rng(args.seed + 100)
    pts = (gt.means.cpu().numpy()
           + rng.normal(0.0, 0.002, (args.n, 3)).astype(np.float32))
    cols = np.clip(sh_to_rgb(gt.features_dc).cpu().numpy(), 0.0, 1.0)
    model_cfg = ModelConfig(use_depth_loss=True, depth_lambda=0.2,
                            use_normal_loss=True, sh_degree=3,
                            sh_degree_interval=1)
    with contextlib.redirect_stdout(sys.stderr):
        return Trainer(data, (pts, cols), model_cfg=model_cfg,
                       train_cfg=TrainConfig(steps_per_eval_image=0))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--capacity", type=int, default=None,
                   help="pair capacity (default: chip_smoke.py's for --n)")
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train", action="store_true",
                   help="profile training steps instead of served frames")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame needs a CUDA device")
    dev = torch.device("cuda")
    big = args.n > 300_000
    capacity = args.capacity or (5_242_880 if big else 1_441_792)
    shift = -math.log(args.n / 100_000) / 3.0 if big else 0.0

    rng = np.random.default_rng(args.seed)
    params, alive = make_gt_gaussians(rng, args.n, extent=1.5,
                                      scale_shift=shift, device=dev)
    rest = rng.normal(0.0, 0.1, tuple(params.features_rest.shape))
    params = dataclasses.replace(params, features_rest=torch.as_tensor(
        rest.astype(np.float32), device=dev))
    cams = ring_cameras(4, width=1024, img_height=576, focal=700.0,
                        device=dev)
    cam = cams[0]
    cfg = eval_raster_config(1024, 576, capacity)
    bg = torch.zeros(3, device=dev)
    if args.train:
        trainer = _trainer(args, dev, params, alive, cams, cfg)
        capacity = trainer.train_cfg.pair_capacity

        def frame():
            with contextlib.redirect_stdout(sys.stderr):
                trainer.train(1, log_every=1 << 30)
    else:
        def frame():
            get_outputs(params, alive, cam, ModelConfig(), cfg, sh_degree=3,
                        background=bg)

    with torch.set_grad_enabled(args.train):
        for _ in range(4 if args.train else 3):
            frame()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.frames):
            frame()
        torch.cuda.synchronize()
        plain_wall_ms = (time.perf_counter() - t0) * 1e3 / args.frames
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.frames):
                frame()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / args.frames

    rec = profiling.record()
    stats = [e for e in prof.key_averages() if _device_us(e) > 0]
    kernels = [e for e in stats if e.device_type == DeviceType.CUDA
               and e.key not in profiling.SPANS]
    ops = [e for e in stats if e.device_type == DeviceType.CPU
           and e.key not in profiling.SPANS]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / args.frames

    def table(evts):
        evts = sorted(evts, key=_device_us, reverse=True)[:args.top]
        return [{"name": e.key[:90],
                 "ms_per_frame": _device_us(e) / 1e3 / args.frames,
                 "calls_per_frame": e.count / args.frames} for e in evts]

    device_us = stage_device_us(prof.events())
    per = 1.0 / args.frames
    stages = {name: {
        "parent": s["parent"], "n_per_frame": s["n"] * per,
        "device_ms_per_frame": device_us.get(name, 0.0) / 1e3 * per,
        "stream_ms_per_frame": (None if s["stream_ms"] is None
                                else s["stream_ms"] * per),
        "host_ms_per_frame": s["host_ms"] * per}
        for name, s in rec["spans"].items()}
    counters = {k: v * per for k, v in rec["counters"].items()}
    print(json.dumps({
        "mode": "train" if args.train else "serve", "stages": stages,
        "counters_per_frame": counters,
        "n_gaussians": args.n, "pair_capacity": capacity,
        "frames": args.frames, "host_ms_per_frame": plain_wall_ms,
        "host_ms_per_frame_profiled": wall_ms,
        "device_busy_ms_per_frame": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / plain_wall_ms),
        "kernels_launched_per_frame": sum(e.count for e in kernels)
        / args.frames,
        "gpu": torch.cuda.get_device_name(0),
        "top_kernels": table(kernels), "top_operators": table(ops),
    }))


if __name__ == "__main__":
    main()
