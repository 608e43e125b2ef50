"""Where the harness finds a cell's parts, by the names in BENCHMARK.json.

* a configuration: `configs/<config>.json`; its `reference` key names
  the module of its plain reference, imported by that name with
  `benchmark/` on the import path (`harness.reference` for the
  DN-Splatter configurations; a later one may bring its own, such as
  `references/<name>.py`, importing from `harness.reference`);
* a traffic mix: `traffic/<traffic>.json`, whose `kind` names its driver,
  the module `drivers/<kind>.py` (imported as `drivers.<kind>`), with
  `run(cfg, mix, limits, seed, seconds, trace, device, t_start)`
  returning a `harness.driving.Outcome`; a driver passes its own span
  table to `harness.trace`;
* a per-layer metric: `metrics/<metric>.py`, a module with
  `read(ctx) -> float | None`;
* the limits of a cell's correctness check: `limits/<workload>.json`.

A later cell, configuration, reference, traffic kind or metric is added
as files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: Dict, name: str, bench_dir: Path = BENCH_DIR) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((bench_dir.parent / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> Dict:
    return json.loads((bench_dir / "traffic" / f"{name}.json").read_text())


def limits(name: str, bench_dir: Path = BENCH_DIR) -> Dict:
    return json.loads((bench_dir / "limits" / f"{name}.json").read_text())


def metrics_for(bench: Dict, section: str, workload_name: str
                ) -> List[Dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") that this
    cell reports: those that list it under `workloads`. An end-to-end
    metric without the key is every cell's; a per-layer metric has to
    list its cells."""
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if workload_name in m["workloads"]:
                out.append(m)
        elif section == "end_to_end":
            out.append(m)
        else:
            raise KeyError(f"per-layer metric {m['name']!r} lists no "
                           "workloads")
    return out


def reader(metric: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """`read` of metrics/<metric>.py."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str) -> ModuleType:
    """The module `drivers/<kind>.py` of a traffic mix's `kind`, imported
    by its name, so that it loads once."""
    return importlib.import_module(f"drivers.{kind}")


def reference(cfg: Dict) -> ModuleType:
    """The plain reference that a configuration names under `reference`,
    imported by that name: under a second name its classes (`Cam`,
    `Event`) would be a second set."""
    return importlib.import_module(cfg["reference"])
