"""Readings that a `prior` cell's correctness limits are set from, on the
card.

    python benchmark/calibrate_prior.py --workload dsine_b5.infer \
        --seeds 1,2,3 --control-seeds 1,2,3 --fault stale_frame \
        [--fault ...] --fault-seeds 4,5,6

For each seed of `--seeds` it drives the cell's timed path as a run does
(a short window, `--seconds`) and prints, as one JSON line, the numbers
the check compares. For `--control-seeds` it prints the same numbers with
the reference computed with TF32 allowed put in the program's place (the
control, which has to fail), and for `--fault-seeds` those of the program
with a fault planted (`FAULTS`). Needs the card.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path
from unittest import mock

BENCH_DIR = Path(__file__).resolve().parent
for p in (str(BENCH_DIR), str(BENCH_DIR.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


@contextlib.contextmanager
def stale_frame():
    """Every frame but the first returns the previous frame's map."""
    from dnsplatter_torch.priors import dsine

    orig = dsine.predict_normals
    last = {}

    def predict_normals(*a, **kw):
        out = orig(*a, **kw)
        prev = last.get("out")
        last["out"] = out
        return out if prev is None else prev

    with mock.patch.object(dsine, "predict_normals", predict_normals):
        yield


@contextlib.contextmanager
def fewer_iterations():
    """Four NRN iterations in place of five."""
    from dnsplatter_torch.priors import dsine

    orig = dsine.dsine_forward

    def dsine_forward(model, img, intrins, num_iter=dsine.NUM_ITER):
        return orig(model, img, intrins, num_iter - 1)

    with mock.patch.object(dsine, "dsine_forward", dsine_forward):
        yield


@contextlib.contextmanager
def no_ray_relu():
    """The refinement's ray-ReLU skipped (its rotated neighbours, the only
    5-D input, pass through); the decoder's first one kept."""
    from dnsplatter_torch.priors import dsine

    orig = dsine._ray_relu

    def ray_relu(n, ray, *a, **kw):
        return n if n.dim() == 5 else orig(n, ray, *a, **kw)

    with mock.patch.object(dsine, "_ray_relu", ray_relu):
        yield


@contextlib.contextmanager
def rows_zeroed():
    """The first 8 rows of every map set to 0."""
    from dnsplatter_torch.priors import dsine

    orig = dsine.predict_normals

    def predict_normals(*a, **kw):
        out = orig(*a, **kw).copy()
        out[:8] = 0.0
        return out

    with mock.patch.object(dsine, "predict_normals", predict_normals):
        yield


FAULTS = {"stale_frame": stale_frame, "fewer_iterations": fewer_iterations,
          "no_ray_relu": no_ray_relu, "rows_zeroed": rows_zeroed}


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", choices=sorted(FAULTS), action="append",
                    default=[], help="repeat for more than one")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="the short window")
    args = ap.parse_args(argv)

    import torch

    from harness import cells

    if not torch.cuda.is_available():
        print("calibrate_prior needs the card", file=sys.stderr)
        return 3
    bench = cells.load_benchmark()
    cell = cells.workload(bench, args.workload)
    cfg = cells.config(bench, cell["config"])
    mix = cells.traffic(cell["traffic"])
    lim = cells.limits(args.workload)
    D = cells.driver(mix["kind"])
    R = cells.reference(cfg)
    dev = "cuda"

    def emit(kind, seed, nums, t0):
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "seed": seed, "numbers": nums,
                          "seconds": time.perf_counter() - t0}), flush=True)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    for seed in _seeds(args.seeds):
        t0 = time.perf_counter()
        oc = D.run(cfg, mix, lim, seed, args.seconds, False, dev, t0)
        emit("program", seed, {k: c["value"] for k, c in oc.checks.items()},
             t0)
        free()
    for seed in _seeds(args.control_seeds):
        t0 = time.perf_counter()
        arrays, frames, K = D.prior_inputs(cfg, seed)
        sample = D.prior_sample(cfg, mix, seed)
        want = D.prior_reference(R, arrays, frames, sample, K, dev)
        low = D.prior_reference(R, arrays, frames, sample, K, dev,
                                allow_tf32=True)
        emit("control", seed, D.prior_numbers(low, want), t0)
        del arrays, frames, want, low
        free()
    for fault in args.fault:
        for seed in _seeds(args.fault_seeds):
            t0 = time.perf_counter()
            oc = D.run(cfg, mix, lim, seed, args.seconds, False, dev, t0,
                       fault=FAULTS[fault])
            emit(f"fault:{fault}", seed,
                 {k: c["value"] for k, c in oc.checks.items()}, t0)
            free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
