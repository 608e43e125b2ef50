"""A cell, a configuration, a traffic mix and a per-layer metric are found
by name from files alone."""

from __future__ import annotations

import json

import pytest

from harness import cells

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
    bench = cells.load_benchmark()
    for w in bench["workloads"]:
        cells.config(bench, w["config"])
        mix = cells.traffic(w["traffic"])
        assert mix["kind"] in ("train", "render")
        assert cells.limits(w["name"])
    for m in bench["per_layer"]:
        assert callable(cells.reader(m["name"]))
