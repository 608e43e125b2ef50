"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (BENCHMARK.json `workloads`) names a configuration
(`configs/<name>.json`) and a traffic mix (`traffic/<name>.json`); the
mix's `kind` picks the driver (`drivers/<kind>.py`). The run makes its
scene and state from the seed on the card, sets up and warms the program
(counted as `setup_s`), measures for `--seconds`, and with `--trace 1`
profiles a steady stretch after the window for the per-layer metrics
(`metrics/<name>.py`). Then it frees the program's state, checks the
program's outputs against the plain reference that the configuration
names (`harness/reference.py` for the DN-Splatter ones) with the cell's
limits (`limits/<cell>.json`), and prints, as the last line of stdout,
one JSON object: correct, attempted, failed, metrics, device, with
--trace 1 breakdown, and checks (each compared number with its limit),
which also end stderr.

It needs an NVIDIA card and fails without one; it never falls back to the
CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Build and kernel caches live at fixed paths inside the checkout, so only
# a cell's first run in a checkout builds.
CACHE = ROOT / ".bench_cache"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
# One process with few threads: the port's host work is Python and
# launches, and idle CPU threads would only contend with it.
os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("MKL_NUM_THREADS", "1")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
for p in (str(BENCH_DIR), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dnsplatter_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def layer_metrics(bench, name, ctx) -> dict:
    from harness import cells

    out = {}
    for m in cells.metrics_for(bench, "per_layer", name):
        v = cells.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def e2e_names(bench, name) -> list:
    from harness import cells

    return [m["name"] for m in cells.metrics_for(bench, "end_to_end", name)]


def result_line(bench, name, oc, card: str, power: str,
                layer: dict = None) -> dict:
    """The run's result: correct, attempted, failed, metrics (the cell's
    end-to-end metrics, or with `layer` its per-layer ones), device, with
    a trace its breakdown, and last the compared numbers with their
    limits."""
    from harness import cells

    cell = cells.workload(bench, name)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    if layer is None:
        metrics = {k: {"value": oc.end_to_end[k], "unit": units[k]}
                   for k in e2e_names(bench, name)}
    else:
        metrics = layer
    device = {"platform": "gpu", "kind": card, "count": int(cell["chips"]),
              "memory_peak_bytes": int(oc.memory_peak), "power": power}
    correct = all(c["value"] <= c["limit"] for c in oc.checks.values())
    result = {"correct": correct, "attempted": oc.attempted,
              "failed": oc.failed, "metrics": metrics, "device": device}
    if oc.trace is not None:
        device["busy_s"] = oc.trace["busy_s"]
        device["window_s"] = oc.trace["window_s"]
        result["breakdown"] = {"device_ops": oc.trace["device_ops"],
                               "idle_gaps": oc.trace["idle_gaps"]}
    result["checks"] = oc.checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import cells

    bench = cells.load_benchmark()
    cell = cells.workload(bench, args.workload)
    cfg = cells.config(bench, cell["config"])
    mix = cells.traffic(cell["traffic"])
    limits = cells.limits(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs only on the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{torch.cuda.device_count()} CUDA devices, the cell needs "
              f"{cell['chips']}", file=sys.stderr)
        return 3
    card = torch.cuda.get_device_name(0)
    limit = power_limit()
    print(f"card: {card}, devices {torch.cuda.device_count()}, "
          f"nvidia-smi: {limit}", file=sys.stderr)

    oc = cells.driver(mix["kind"]).run(
        cfg, mix, limits, args.seed, args.seconds, bool(args.trace), "cuda",
        T_START)

    ctx_metrics = (layer_metrics(bench, args.workload, oc.layer_ctx)
                   if args.trace else None)
    result = result_line(bench, args.workload, oc, card, limit, ctx_metrics)
    # last, so that nothing the readers or the check loaded escapes it
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 4
    for k, c in oc.checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
