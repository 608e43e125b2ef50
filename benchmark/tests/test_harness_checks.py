"""The check decides `correct` against the reference and is shown to fail:
the control (the reference in bfloat16 in the program's place) and each
fault a cell can have, planted under a whole run of the driver at a tiny
size on the CPU (the harness's look for a card skipped), read above the
cell's limits."""

from __future__ import annotations

import contextlib
import subprocess
import sys
import time
from unittest import mock

import pytest

import calibrate
from drivers import render as RD
from drivers import train as TD
from harness import cells

from conftest import BENCH_DIR, ROOT, tiny

TRAIN = ("room_1m.train_densify", "big_3m.train_steady")
RENDER = ("room_1m.render", "big_3m.render")


@contextlib.contextmanager
def unchanged_state():
    """The step returns its state unchanged."""
    from dnsplatter_torch.train import trainer

    with mock.patch.object(trainer, "adam_step",
                           lambda cfg, p, g, st, step: (p, st)):
        yield


# A mix kept for a later cell, with its limits, though no cell of
# BENCHMARK.json runs it: the refinement's checks stay tested.
KEPT = {"room_1m.train_densify": {"config": "dnsplatter_room_1m",
                                  "traffic": "train_densify"}}


def _cell(name, **size):
    bench = cells.load_benchmark()
    w = KEPT[name] if name in KEPT else cells.workload(bench, name)
    return (tiny(w["config"], **size), cells.traffic(w["traffic"]),
            cells.limits(name))


# The control at the density of the cells' frames: enough Gaussians that
# a pixel composites several layers, as at the timed sizes.
CONTROL_SIZE = {"n": 60000, "tiles": 8}


def _run(name, fault=None, seed=2**31 + 11):
    cfg, mix, lim = _cell(name)
    oc = cells.driver(mix["kind"]).run(cfg, mix, lim, seed, 0.3, False,
                                       "cpu", time.perf_counter(),
                                       fault=fault)
    return {k: c["value"] > c["limit"] for k, c in oc.checks.items()}


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", [unchanged_state, calibrate.half_batch],
                         ids=["unchanged_state", "half_batch"])
def test_train_faults_fail(name, fault):
    assert any(_run(name, fault).values())


@pytest.mark.parametrize("fault", [calibrate.skip_refine,
                                   calibrate.stat_doubled],
                         ids=["skip_refine", "stat_doubled"])
def test_refinement_faults_fail(fault):
    """The densify cell's checked steps end in a refinement event: an
    event that does nothing, or one fed an altered statistic, fails the
    refinement's numbers."""
    assert _run("room_1m.train_densify", fault)["refine_added_gap"]


def test_refinement_splits_as_the_reference_at_a_cpu_size():
    """At this size the event at 4100 splits a fifth of the rows (at 1M
    it only duplicates): the program's removed rows agree with the
    reference's, and the bfloat16 control's do not as closely."""
    cfg, mix, _ = _cell("room_1m.train_densify")
    tr, scene, prog = TD.train_setup(cfg, mix, 2**31 + 11, "cpu")
    del tr
    ref = TD.train_reference(cfg, mix, scene, lowp=False)
    low = TD.train_reference(cfg, mix, scene, lowp=True)
    assert int(ref["event"].removed.sum()) > cfg["num_gaussians"] // 10
    sound = TD.event_numbers(prog["event"], ref["event"])
    control = TD.event_numbers(low["event"], ref["event"])
    assert sound["refine_removed_gap"] < 3e-3
    assert control["refine_removed_gap"] > 3 * sound["refine_removed_gap"]


def test_overflowing_frames_count_as_failed():
    cfg, mix, lim = _cell("room_1m.render")
    mix["capacity_margin"] = 0.5
    oc = RD.run(cfg, mix, lim, 2**31 + 13, 0.3, False, "cpu",
                time.perf_counter())
    assert 0 < oc.failed <= oc.attempted


@pytest.mark.parametrize("name", RENDER)
@pytest.mark.parametrize("fault", [calibrate.stale_frame,
                                   calibrate.altered_rows],
                         ids=["stale_frame", "altered_rows"])
def test_render_faults_fail(name, fault):
    assert any(_run(name, fault).values())


def test_a_planted_fault_ends_with_the_run():
    """A render fault replaces `dn_model.get_outputs` for its run alone:
    the modules that bind it by name (the Trainer's, the evaluator's) are
    loaded before the fault is entered, so none keeps the replacement
    once the run is over. Run in a fresh interpreter, where the driver is
    the first to load them."""
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(BENCH_DIR / 'tests')!r}, {str(BENCH_DIR)!r},"
        f" {str(ROOT)!r}]\n"
        "import calibrate\n"
        "from conftest import tiny\n"
        "from drivers import render as RD\n"
        "from harness import cells\n"
        "bench = cells.load_benchmark()\n"
        "w = cells.workload(bench, 'room_1m.render')\n"
        "assert 'dnsplatter_torch.train.trainer' not in sys.modules\n"
        "RD.run(tiny(w['config']), cells.traffic(w['traffic']),\n"
        "       cells.limits(w['name']), 3, 0.3, False, 'cpu',\n"
        "       time.perf_counter(), fault=calibrate.stale_frame)\n"
        "from dnsplatter_torch.eval import evaluator\n"
        "from dnsplatter_torch.models import dn_model\n"
        "from dnsplatter_torch.train import trainer\n"
        "print(trainer.get_outputs is dn_model.get_outputs,\n"
        "      evaluator.get_outputs is dn_model.get_outputs)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-2:] == ["True", "True"]


@pytest.mark.parametrize("name", TRAIN)
def test_train_control_fails(name):
    cfg, mix, lim = _cell(name, **CONTROL_SIZE)
    tr, scene, _ = TD.train_setup(cfg, mix, 5, "cpu")
    del tr
    ref = TD.train_reference(cfg, mix, scene, lowp=False)
    low = TD.train_reference(cfg, mix, scene, lowp=True)
    nums = TD.train_numbers(low, ref)
    assert any(nums[k] > v for k, v in lim.items()), nums


@pytest.mark.parametrize("name", RENDER)
def test_render_control_fails(name):
    from harness import scene as S

    cfg, mix, lim = _cell(name, **CONTROL_SIZE)
    scene = S.make_scene(cfg, 5, "cpu", with_targets=False)
    frames = RD.render_sample(cfg, mix, 5, 0)
    want = RD.render_reference(cfg, scene, frames, lowp=False)
    low = RD.render_reference(cfg, scene, frames, lowp=True)
    got = {i: {k: v.numpy() for k, v in low[i].items()} for i in frames}
    nums = RD.render_numbers(got, want)
    assert any(nums[k] > v for k, v in lim.items()), nums
