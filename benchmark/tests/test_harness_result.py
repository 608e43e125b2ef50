"""The result line keeps the contract: its keys, the metrics of the run's
kind, the device, the breakdown of a traced run, and the compared numbers
with their limits last; without a card the run prints nothing and fails."""

from __future__ import annotations

import json
import subprocess
import sys

import run as bench_run
from harness import cells
from harness.driving import Outcome, judge

from conftest import BENCH_DIR, ROOT


def _outcome(trace=None, bad=False):
    return Outcome(
        end_to_end={"setup_s": 30.5, "step_ms": 48.25},
        attempted=600, failed=0,
        checks=judge({"loss_gap": 2.0 if bad else 1e-5, "grad_gap_median": 1e-3},
                     {"loss_gap": 1e-3, "grad_gap_median": 1e-2}),
        memory_peak=8_325_016_064, trace=trace)


def test_untraced_line():
    bench = cells.load_benchmark()
    line = bench_run.result_line(bench, "big_3m.train_steady", _outcome(),
                                 "NVIDIA H100 80GB HBM3", "700.00 W")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"] == {"setup_s": {"value": 30.5, "unit": "s"},
                               "step_ms": {"value": 48.25, "unit": "ms"}}
    dev = line["device"]
    assert (dev["platform"], dev["count"]) == ("gpu", 1)
    assert dev["memory_peak_bytes"] == 8_325_016_064
    assert line["checks"]["loss_gap"] == {"value": 1e-5, "limit": 1e-3}
    json.dumps(line)


def test_traced_line_and_a_failed_check():
    trace = {"busy_s": 0.5, "window_s": 1.5, "device_ops": [["k", 0.1]],
             "idle_gaps": [["autograd_grad", 0.01]]}
    bench = cells.load_benchmark()
    layer = {"train.kernels_per_step": {"value": 2165.0, "unit": "kernels"}}
    line = bench_run.result_line(bench, "big_3m.train_steady",
                                 _outcome(trace, bad=True), "card", "w",
                                 layer)
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert line["correct"] is False
    assert line["metrics"] == layer
    assert (line["device"]["busy_s"], line["device"]["window_s"]) == (0.5,
                                                                      1.5)
    assert line["breakdown"]["idle_gaps"] == [["autograd_grad", 0.01]]


def test_each_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    bench = cells.load_benchmark()
    for w in bench["workloads"]:
        e2e = bench_run.e2e_names(bench, w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cells.metrics_for(bench, "per_layer", w["name"])


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload",
         "room_1m.render", "--seed", str(2**31 + 7), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    import torch

    if torch.cuda.is_available():
        return
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
