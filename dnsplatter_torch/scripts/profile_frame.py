"""Where one served frame's time goes, on the GPU.

    python -m dnsplatter_torch.scripts.profile_frame [--n 1000000]

Builds chip_smoke.py's synthetic scene (make_gt_gaussians with real
degree-3 SH, ring cameras at 1024x576, focal 700), renders a few warm-up
frames, then profiles `get_outputs` over `--frames` frames with
torch.profiler (CPU + CUDA activity). Prints one JSON line: host ms per
frame, device-busy ms per frame (the sum of kernel times), the device's
idle share, and the kernels and operators that take the most device time.
Runs only on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dnsplatter_torch.data.synthetic import make_gt_gaussians, ring_cameras
from dnsplatter_torch.eval.evaluator import eval_raster_config
from dnsplatter_torch.models.dn_model import ModelConfig, get_outputs


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--capacity", type=int, default=None,
                   help="pair capacity (default: chip_smoke.py's for --n)")
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--seed", type=int, default=0)
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
    cam = ring_cameras(4, width=1024, img_height=576, focal=700.0,
                       device=dev)[0]
    cfg = eval_raster_config(1024, 576, capacity)
    bg = torch.zeros(3, device=dev)

    def frame():
        get_outputs(params, alive, cam, ModelConfig(), cfg, sh_degree=3,
                    background=bg)

    with torch.no_grad():
        for _ in range(3):
            frame()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.frames):
            frame()
        torch.cuda.synchronize()
        plain_wall_ms = (time.perf_counter() - t0) * 1e3 / args.frames
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.frames):
                frame()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / args.frames

    stats = [e for e in prof.key_averages() if _device_us(e) > 0]
    kernels = [e for e in stats if e.device_type == DeviceType.CUDA]
    ops = [e for e in stats if e.device_type == DeviceType.CPU]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / args.frames

    def table(evts):
        evts = sorted(evts, key=_device_us, reverse=True)[:args.top]
        return [{"name": e.key[:90],
                 "ms_per_frame": _device_us(e) / 1e3 / args.frames,
                 "calls_per_frame": e.count / args.frames} for e in evts]

    print(json.dumps({
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
