"""Readings that a cell's correctness limits are set from, on the card.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault half_batch [--fault ...]
        --fault-seeds 4,5,6]

For each seed of `--seeds` it drives the cell's timed path as a run does
and prints, as one JSON line, the numbers the check compares: a train
cell's checked steps through `Trainer.train` against the reference, a
render cell's sampled frames from a short window at the cell's own load.
For `--control-seeds` it prints the same numbers with the reference
computed in bfloat16 put in the program's place (the control, which has
to fail), and for `--fault-seeds` those of the program with a fault
planted (`FAULTS`). One process reads them all, so the kernels build
once. Needs the card.
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
def half_batch():
    """The loss of the top half of each frame alone, the mean taken over
    it: half of the batch left out."""
    from dnsplatter_torch.train import trainer

    orig = trainer.compute_loss

    def loss(outputs, batch, *a, **kw):
        h = batch["image"].shape[0] // 2
        top = {k: (v[:h] if v.dim() == 3 else v) for k, v in outputs.items()}
        return orig(top, {k: v[:h] for k, v in batch.items()}, *a, **kw)

    with mock.patch.object(trainer, "compute_loss", loss):
        yield


@contextlib.contextmanager
def stale_frame():
    """Every frame but the first returns the previous frame's outputs."""
    from dnsplatter_torch.models import dn_model

    orig = dn_model.get_outputs
    last = {}

    def get_outputs(*a, **kw):
        out, info = orig(*a, **kw)
        prev = last.get("out")
        last["out"] = out
        return (prev if prev is not None else out), info

    with mock.patch.object(dn_model, "get_outputs", get_outputs):
        yield


@contextlib.contextmanager
def altered_rows():
    """The first 8 rows of every served rgb image altered (set to 0)."""
    from dnsplatter_torch.models import dn_model

    orig = dn_model.get_outputs

    def get_outputs(*a, **kw):
        out, info = orig(*a, **kw)
        out = dict(out)
        rgb = out["rgb"].clone()
        rgb[:8] = 0.0
        out["rgb"] = rgb
        return out, info

    with mock.patch.object(dn_model, "get_outputs", get_outputs):
        yield


@contextlib.contextmanager
def skip_refine():
    """The densify-and-cull event returns the state it was given."""
    from dnsplatter_torch.train import trainer

    def densify_and_cull(cfg, params, alive, adam, stats, *a, **kw):
        return params, alive, adam, stats

    with mock.patch.object(trainer, "densify_and_cull", densify_and_cull):
        yield


@contextlib.contextmanager
def stat_doubled():
    """The densification statistic altered where it is produced: each
    step's absolute screen-space gradient enters it doubled."""
    from dnsplatter_torch.train import trainer

    orig = trainer.update_stats

    def update_stats(stats, grad2d, *a, **kw):
        return orig(stats, 2.0 * grad2d, *a, **kw)

    with mock.patch.object(trainer, "update_stats", update_stats):
        yield


FAULTS = {"half_batch": half_batch, "stale_frame": stale_frame,
          "altered_rows": altered_rows, "skip_refine": skip_refine,
          "stat_doubled": stat_doubled}


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
                    help="a render cell's short window")
    args = ap.parse_args(argv)

    import torch

    from harness import cells
    from harness import scene as S
    from harness.driving import PROGRAM_FIELDS, ref_cam

    if not torch.cuda.is_available():
        print("calibrate needs the card", file=sys.stderr)
        return 3
    bench = cells.load_benchmark()
    cell = cells.workload(bench, args.workload)
    cfg = cells.config(bench, cell["config"])
    mix = cells.traffic(cell["traffic"])
    lim = cells.limits(args.workload)
    D = cells.driver(mix["kind"])
    R = cells.reference(cfg)
    dev = "cuda"

    def emit(kind, seed, nums, t0, leaves=None):
        row = {"workload": args.workload, "kind": kind, "seed": seed,
               "numbers": nums, "seconds": time.perf_counter() - t0}
        if leaves:
            row["leaves"] = leaves
        print(json.dumps(row), flush=True)

    def leaves(a, b):
        """Per-leaf norms (program or control, reference) of the first
        gradient and of the change, the losses, and the rows the
        refinement removed and added."""
        return {q: {f: [a[q][f], b[q][f]] for f in b[q]}
                for q in ("grads", "change")} | {
                    "losses": [a["losses"], b["losses"]],
                    "event": [[int(e["event"].removed.sum()),
                               e["event"].added] for e in (a, b)]}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    if mix["kind"] == "train":
        def readings(seed, lowp_too, fault=None):
            ctx = FAULTS[fault]() if fault else contextlib.nullcontext()
            with ctx:
                tr, scene, prog = D.train_setup(cfg, mix, seed, dev)
            del tr
            free()
            ref = D.train_reference(cfg, mix, scene, lowp=False)
            low = (D.train_reference(cfg, mix, scene, lowp=True)
                   if lowp_too else None)
            return prog, ref, low

        control = set(_seeds(args.control_seeds))
        for seed in _seeds(args.seeds):
            t0 = time.perf_counter()
            prog, ref, low = readings(seed, seed in control)
            emit("program", seed, D.train_numbers(prog, ref), t0,
                 leaves(prog, ref))
            if low is not None:
                emit("control", seed, D.train_numbers(low, ref), t0,
                     leaves(low, ref))
            free()
        for seed in sorted(control - set(_seeds(args.seeds))):
            t0 = time.perf_counter()
            _, ref, low = readings(seed, True)
            emit("control", seed, D.train_numbers(low, ref), t0,
                 leaves(low, ref))
            free()
        for fault in args.fault:
            for seed in _seeds(args.fault_seeds):
                t0 = time.perf_counter()
                prog, ref, _ = readings(seed, False, fault)
                emit(f"fault:{fault}", seed,
                     D.train_numbers(prog, ref), t0, leaves(prog, ref))
                free()
        return 0

    for seed in _seeds(args.seeds):
        t0 = time.perf_counter()
        oc = D.run(cfg, mix, lim, seed, args.seconds, False, dev, t0)
        emit("program", seed, {k: c["value"] for k, c in oc.checks.items()},
             t0)
        free()
    for seed in _seeds(args.control_seeds):
        t0 = time.perf_counter()
        scene = S.make_scene(cfg, seed, dev, with_targets=False)
        pairs = R.pair_counts(
            {f: scene.state[f] for f in PROGRAM_FIELDS},
            scene.state["alive"], [ref_cam(R, scene, i)
                                   for i in range(int(cfg["frames"]))])
        heavy = max(range(len(pairs)), key=pairs.__getitem__)
        frames = D.render_sample(cfg, mix, seed, heavy)
        want = D.render_reference(cfg, scene, frames, lowp=False)
        low = D.render_reference(cfg, scene, frames, lowp=True)
        got = {i: {k: v.cpu().numpy() for k, v in low[i].items()}
               for i in frames}
        emit("control", seed, D.render_numbers(got, want), t0)
        del scene, want, low, got
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
