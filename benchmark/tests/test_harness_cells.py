"""A cell, a configuration, a traffic mix, a per-layer metric, a traffic
kind's driver and a configuration's reference are found by name from
files alone."""

from __future__ import annotations

import functools
import json
import sys

import pytest
import torch

import run as bench_run
from harness import cells

from conftest import BENCH_DIR, ROOT

METRIC = '''
def read(ctx):
    return 2.0 * ctx["units"] if ctx["units"] else None
'''


def _added(tmp_path):
    """A benchmark folder with one cell added only as files and entries."""
    for sub in ("configs", "traffic", "metrics", "limits"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "cfg_x.json").write_text(json.dumps({"a": 1}))
    (tmp_path / "traffic" / "mix_y.json").write_text(
        json.dumps({"kind": "train", "resume_step": 7}))
    (tmp_path / "metrics" / "train.extra_ms.py").write_text(METRIC)
    (tmp_path / "limits" / "x.mix_y.json").write_text(
        json.dumps({"loss_gap": 0.5}))
    bench = {
        "configs": [{"name": "cfg_x", "file": f"{tmp_path.name}/configs/"
                     "cfg_x.json"}],
        "workloads": [{"name": "x.mix_y", "config": "cfg_x",
                       "traffic": "mix_y", "chips": 1}],
        "end_to_end": [{"name": "setup_s"},
                       {"name": "step_ms", "workloads": ["x.mix_y"]},
                       {"name": "render_fps", "workloads": ["other"]}],
        "per_layer": [{"name": "train.extra_ms", "moves": "step_ms",
                       "workloads": ["x.mix_y"]},
                      {"name": "listed", "moves": "step_ms",
                       "workloads": ["other"]}],
    }
    return bench


def test_added_cell_is_found_by_name(tmp_path):
    bench = _added(tmp_path)
    cell = cells.workload(bench, "x.mix_y")
    assert cells.config(bench, cell["config"], tmp_path) == {"a": 1}
    assert cells.traffic(cell["traffic"], tmp_path)["resume_step"] == 7
    assert cells.limits("x.mix_y", tmp_path) == {"loss_gap": 0.5}
    e2e = [m["name"] for m in cells.metrics_for(bench, "end_to_end",
                                                 "x.mix_y")]
    assert e2e == ["setup_s", "step_ms"]
    layer = cells.metrics_for(bench, "per_layer", "x.mix_y")
    assert [m["name"] for m in layer] == ["train.extra_ms"]
    read = cells.reader("train.extra_ms", tmp_path)
    assert read({"units": 3}) == 6.0
    assert read({"units": 0}) is None


def test_a_per_layer_metric_has_to_list_its_cells(tmp_path):
    bench = _added(tmp_path)
    del bench["per_layer"][0]["workloads"]
    with pytest.raises(KeyError, match="lists no workloads"):
        cells.metrics_for(bench, "per_layer", "x.mix_y")


def test_every_cell_of_the_benchmark_has_its_files():
    from harness import driving, reference

    # the program's checkpoint leaves are the reference's, in its order
    assert driving.PROGRAM_FIELDS == reference.FIELDS
    bench = cells.load_benchmark()
    for w in bench["workloads"]:
        cfg = cells.config(bench, w["config"])
        mix = cells.traffic(w["traffic"])
        assert callable(cells.driver(mix["kind"]).run)
        assert cells.reference(cfg) is reference
        assert cells.limits(w["name"])
    for m in bench["per_layer"]:
        assert callable(cells.reader(m["name"]))


# A model that the benchmark did not know: its traffic kind's driver and
# its configuration's reference come as files, as its mix and limits do.
DRIVER = '''
from harness import cells
from harness.driving import Outcome, judge


def run(cfg, mix, limits, seed, seconds, trace, device, t_start,
        fault=None):
    R = cells.reference(cfg)
    nums = R.compare(cfg["gap"], mix["frames"])
    return Outcome(end_to_end={"setup_s": 1.5, "render_fps": 40.0,
                               "render_p95_ms": 30.0},
                   attempted=mix["frames"], failed=0,
                   checks=judge(nums, limits), memory_peak=1 << 20)
'''
REFERENCE = '''
def compare(gap, frames):
    return {"normal_mae": gap, "frames_seen": float(frames)}
'''


@pytest.fixture
def new_model(tmp_path, monkeypatch):
    """A benchmark folder in `tmp_path` with one cell of a new traffic
    kind (`stub_infer`) and a configuration whose `reference` is a module
    of that folder; the folder is on the import path as `benchmark/` is.
    The modules are unloaded again afterwards."""
    bench = _added(tmp_path)
    (tmp_path / "drivers").mkdir()
    (tmp_path / "drivers" / "stub_infer.py").write_text(DRIVER)
    (tmp_path / "references").mkdir()
    (tmp_path / "references" / "stub_net.py").write_text(REFERENCE)
    (tmp_path / "configs" / "stub_net.json").write_text(json.dumps(
        {"reference": "references.stub_net", "gap": 0.02}))
    (tmp_path / "traffic" / "stub_frames.json").write_text(json.dumps(
        {"kind": "stub_infer", "frames": 12}))
    (tmp_path / "limits" / "stub_net.frames.json").write_text(json.dumps(
        {"normal_mae": 0.05}))
    bench["configs"].append({"name": "stub_net",
                             "file": f"{tmp_path.name}/configs/"
                             "stub_net.json"})
    bench["workloads"].append({"name": "stub_net.frames",
                               "config": "stub_net",
                               "traffic": "stub_frames", "chips": 1})
    for m in bench["end_to_end"]:
        if m["name"] == "render_fps":
            m["workloads"].append("stub_net.frames")
    bench["end_to_end"].append({"name": "render_p95_ms", "unit": "ms",
                                "workloads": ["stub_net.frames"]})
    for m, unit in zip(bench["end_to_end"], ("s", "ms", "frames/s")):
        m["unit"] = unit
    monkeypatch.syspath_prepend(str(tmp_path))
    yield bench, tmp_path
    for name in ("drivers.stub_infer", "references.stub_net", "references"):
        sys.modules.pop(name, None)


def _real_files():
    return {p: (p.stat().st_size, p.stat().st_mtime_ns)
            for p in [ROOT / "BENCHMARK.json", *BENCH_DIR.rglob("*")]
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_kind_and_reference_are_found_by_name(new_model):
    bench, folder = new_model
    before = _real_files()
    cell = cells.workload(bench, "stub_net.frames")
    cfg = cells.config(bench, cell["config"], folder)
    mix = cells.traffic(cell["traffic"], folder)
    drv = cells.driver(mix["kind"])
    ref = cells.reference(cfg)
    assert drv.__file__ == str(folder / "drivers" / "stub_infer.py")
    assert ref.__file__ == str(folder / "references" / "stub_net.py")
    assert cells.driver("stub_infer") is drv
    assert cells.reference(cfg) is ref
    # the benchmark's own drivers are still found beside it
    assert cells.driver("render").__file__ == str(BENCH_DIR / "drivers"
                                                  / "render.py")
    assert _real_files() == before


@pytest.mark.parametrize("gap,correct", [(0.02, True), (0.5, False)])
def test_run_main_runs_a_cell_added_as_files(new_model, monkeypatch, capsys,
                                             gap, correct):
    """run.main drives the new cell on the CPU (its look for a card
    answered yes) and prints its result line, `correct` decided by the
    stub reference's number against the cell's limit."""
    bench, folder = new_model
    cfg_file = folder / "configs" / "stub_net.json"
    cfg_file.write_text(json.dumps({"reference": "references.stub_net",
                                    "gap": gap}))
    before = _real_files()
    monkeypatch.setattr(cells, "load_benchmark", lambda: bench)
    for name in ("config", "traffic", "limits"):
        monkeypatch.setattr(cells, name, functools.partial(
            getattr(cells, name), bench_dir=folder))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "stub")
    monkeypatch.setattr(bench_run, "power_limit", lambda: "not read")
    rc = bench_run.main(["--workload", "stub_net.frames", "--seed",
                         str(2**31 + 5), "--seconds", "1", "--trace", "0"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is correct
    assert line["attempted"] == 12
    assert list(line["metrics"]) == ["setup_s", "render_fps",
                                     "render_p95_ms"]
    assert line["checks"] == {"normal_mae": {"value": gap, "limit": 0.05}}
    assert _real_files() == before
