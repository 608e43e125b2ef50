"""The check decides `correct` against the reference and is shown to fail:
the control (the reference in bfloat16 in the program's place) and each
fault a cell can have, planted under a whole run of the driver at a tiny
size on the CPU (the harness's look for a card skipped), read above the
cell's limits."""

from __future__ import annotations

import contextlib
import time
from unittest import mock

import pytest

import calibrate
from harness import cells, drivers

from conftest import tiny

TRAIN = ("room_1m.train_densify", "big_3m.train_steady")
RENDER = ("room_1m.render", "big_3m.render")


@contextlib.contextmanager
def unchanged_state():
    """The step returns its state unchanged."""
    from dnsplatter_torch.train import trainer

    with mock.patch.object(trainer, "adam_step",
                           lambda cfg, p, g, st, step: (p, st)):
        yield


def _cell(name, **size):
    bench = cells.load_benchmark()
    w = cells.workload(bench, name)
    return (tiny(w["config"], **size), cells.traffic(w["traffic"]),
            cells.limits(name))


# The control at the density of the cells' frames: enough Gaussians that
# a pixel composites several layers, as at the timed sizes.
CONTROL_SIZE = {"n": 60000, "tiles": 8}


def _run(name, fault=None, seed=2**31 + 11):
    cfg, mix, lim = _cell(name)
    oc = drivers.DRIVERS[mix["kind"]](cfg, mix, lim, seed, 0.3, False,
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
    tr, scene, prog = drivers.train_setup(cfg, mix, 2**31 + 11, "cpu")
    del tr
    ref = drivers.train_reference(cfg, mix, scene, lowp=False)
    low = drivers.train_reference(cfg, mix, scene, lowp=True)
    assert int(ref["event"].removed.sum()) > cfg["num_gaussians"] // 10
    sound = drivers.event_numbers(prog["event"], ref["event"])
    control = drivers.event_numbers(low["event"], ref["event"])
    assert sound["refine_removed_gap"] < 3e-3
    assert control["refine_removed_gap"] > 3 * sound["refine_removed_gap"]


def test_overflowing_frames_count_as_failed():
    cfg, mix, lim = _cell("room_1m.render")
    mix["capacity_margin"] = 0.5
    oc = drivers.run_render(cfg, mix, lim, 2**31 + 13, 0.3, False, "cpu",
                            time.perf_counter())
    assert 0 < oc.failed <= oc.attempted


@pytest.mark.parametrize("name", RENDER)
@pytest.mark.parametrize("fault", [calibrate.stale_frame,
                                   calibrate.altered_rows],
                         ids=["stale_frame", "altered_rows"])
def test_render_faults_fail(name, fault):
    assert any(_run(name, fault).values())


@pytest.mark.parametrize("name", TRAIN)
def test_train_control_fails(name):
    cfg, mix, lim = _cell(name, **CONTROL_SIZE)
    tr, scene, _ = drivers.train_setup(cfg, mix, 5, "cpu")
    del tr
    ref = drivers.train_reference(cfg, mix, scene, lowp=False)
    low = drivers.train_reference(cfg, mix, scene, lowp=True)
    nums = drivers.train_numbers(low, ref)
    assert any(nums[k] > v for k, v in lim.items()), nums


@pytest.mark.parametrize("name", RENDER)
def test_render_control_fails(name):
    from harness import scene as S

    cfg, mix, lim = _cell(name, **CONTROL_SIZE)
    scene = S.make_scene(cfg, 5, "cpu", with_targets=False)
    frames = drivers.render_sample(cfg, mix, 5, 0)
    want = drivers.render_reference(cfg, scene, frames, lowp=False)
    low = drivers.render_reference(cfg, scene, frames, lowp=True)
    got = {i: {k: v.numpy() for k, v in low[i].items()} for i in frames}
    nums = drivers.render_numbers(got, want)
    assert any(nums[k] > v for k, v in lim.items()), nums
