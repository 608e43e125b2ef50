"""The program's recorder (`utils/profiling`): nothing recorded with
recording off; under a profiler a training step and a served frame record
every span they pass through with its parent, and the profiler's events
hold the spans' ranges; the counters equal direct counts of the work; the
record is bounded and safe across threads; the benchmark's per-layer
metrics read the record. The test marked `cuda` checks the stream times on
the card.

    python -m pytest tests/test_torch_tracing.py -q
    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

from __future__ import annotations

import ast
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dnsplatter_torch.data.synthetic import make_synthetic_scene
from dnsplatter_torch.models import dn_model
from dnsplatter_torch.ops import rasterize, render
from dnsplatter_torch.train import trainer as ttr
from dnsplatter_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)

# Each span of a training step through Trainer.train, with its parent.
STEP_SPANS = {
    "train.data": None, "train.step": None,
    "train.forward": "train.step", "model.outputs": "train.forward",
    "render.screen": "model.outputs", "raster.bin": "model.outputs",
    "raster.payload": "model.outputs", "raster.tiles": "model.outputs",
    "render.finish": "model.outputs", "train.loss": "train.step",
    "train.backward": "train.step", "raster.backward": "train.backward",
    "raster.reduce": "raster.backward", "raster.live_slots": "raster.reduce",
    "train.optim": "train.step", "train.log": None,
}
FRAME_SPANS = {
    "model.outputs": None, "render.screen": "model.outputs",
    "raster.bin": "model.outputs", "raster.payload": "model.outputs",
    "raster.tiles": "model.outputs", "render.finish": "model.outputs",
}


def _trainer(device="cpu", **model_kw):
    scene = make_synthetic_scene(seed=0, n_gaussians=300, n_cameras=4,
                                 width=64, height=48, pair_capacity=1 << 14,
                                 device=device)
    pts, cols = scene.seed_points(np.random.default_rng(1), noise=0.03)
    model = dn_model.ModelConfig(**dict(
        dict(use_depth_loss=True, depth_lambda=0.2, warmup_length=10_000,
             sh_degree=1), **model_kw))
    return ttr.Trainer(scene, (pts, cols), model_cfg=model,
                       train_cfg=ttr.TrainConfig(
                           pair_capacity=1 << 14, chunk=32, tile_block=4,
                           steps_per_eval_image=0,
                           auto_pair_capacity=False),
                       device=device)


@pytest.fixture(scope="module")
def trainer():
    tr = _trainer()
    tr.train(1, log_every=1 << 30)  # warm
    return tr


def _frame(tr):
    cam, _ = tr.data.get(1)
    with torch.no_grad():
        out, _ = dn_model.get_outputs(
            tr.params, tr.alive, cam, tr.model_cfg, tr._raster_cfg(cam),
            sh_degree=1, training=False, background=torch.zeros(3))
    return out


def test_recording_off_leaves_the_record_empty(trainer):
    profiling.reset()
    assert not profiling.enabled()
    assert profiling.span("train.step") is profiling.span("model.outputs")
    trainer.train(1, log_every=1)
    _frame(trainer)
    profiling.count("bin.calls", torch.ones(()))
    assert profiling.host_read("loss", float, torch.ones(())) == 1.0
    assert profiling.record() == {"spans": {}, "counters": {}}
    assert not profiling._entries and not profiling._events


@pytest.mark.parametrize("what", ["step", "frame"])
def test_profiled_step_and_frame_record_their_spans(trainer, what):
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.enabled()
        if what == "step":
            trainer.train(1, log_every=1)
        else:
            _frame(trainer)
    assert not profiling.enabled()
    rec = profiling.record()
    want = STEP_SPANS if what == "step" else FRAME_SPANS
    assert set(rec["spans"]) == set(want)
    for name, parent in want.items():
        s = rec["spans"][name]
        assert s["parent"] == parent, name
        assert s["n"] >= 1 and s["host_ms"] > 0 and s["stream_ms"] is None
    # the tiles-to-image step, finish and outputs_dict
    assert rec["spans"]["render.finish"]["n"] == 3
    if what == "step":  # data.get, then the upload in train_one
        assert rec["spans"]["train.data"]["n"] == 2
    ranges = {e.name for e in prof.events()}
    assert set(want) <= ranges
    # a parent's host time covers its children's
    sp = rec["spans"]
    assert sp["model.outputs"]["host_ms"] >= sp["raster.bin"]["host_ms"]
    if what == "step":
        assert sp["train.step"]["host_ms"] >= (
            sp["train.forward"]["host_ms"] + sp["train.backward"]["host_ms"])


def test_refinement_and_eval_spans():
    tr = _trainer(warmup_length=1, refine_every=2)
    tr.train(1, log_every=1 << 30)
    with profiling.recording():
        tr.train(1, log_every=1 << 30)  # step 2: the refinement acts
    sp = profiling.record()["spans"]
    assert sp["train.refine"]["n"] == 1
    assert sp["train.refine"]["parent"] is None
    with profiling.recording():
        tr.eval_image(0)
    sp = profiling.record()["spans"]
    assert sp["train.eval"]["parent"] is None
    assert sp["model.outputs"]["parent"] == "train.eval"


def _syncs(rec):
    return {k: v for k, v in rec["counters"].items()
            if k.startswith("sync.")}


def test_refinement_and_eval_count_their_host_reads():
    """A densify-and-cull step reads which rows it writes once per
    write (the duplicates, then each split sample), the culled rows once,
    and the alive count for the capacity check; the eval frame reads each
    metric and the alive count."""
    tr = _trainer(warmup_length=1, refine_every=2)
    tr.train(7, log_every=1 << 30)
    with profiling.recording():
        tr.train(1, log_every=1 << 30)  # step 8: densify and cull
    rec = profiling.record()
    assert rec["spans"]["train.refine"]["n"] == 1
    writes = 1 + tr.model_cfg.n_split_samples
    assert _syncs(rec) == {
        "sync.live_slots": 1, "sync.refine_rows": writes, "sync.cull": 1,
        "sync.alive_count": 2, "sync.loss": 1}
    with profiling.recording():
        row = tr.eval_image(0)
    # every metric, and the alive count
    assert _syncs(profiling.record()) == {"sync.eval": len(row)}
    assert "depth_rmse" in row


def test_counters_equal_direct_counts(trainer, monkeypatch):
    seen = {"pairs": [], "cap": [], "visible": [], "rows": [], "live": []}
    bin0, screen0 = rasterize.bin_gaussians, render.screen_space
    slots0 = rasterize.live_pair_slots

    def bin_gaussians(cfg, *a, **kw):
        binned = bin0(cfg, *a, **kw)
        seen["pairs"].append(int(binned.total_pairs))
        seen["cap"].append(cfg.pair_capacity)
        return binned

    def screen_space(*a, **kw):
        ss = screen0(*a, **kw)
        seen["visible"].append(int(ss.valid.sum()))
        seen["rows"].append(ss.valid.shape[0])
        return ss

    def live_pair_slots(*a):
        slots = slots0(*a)
        seen["live"].append(len(slots))
        return slots

    monkeypatch.setattr(rasterize, "bin_gaussians", bin_gaussians)
    monkeypatch.setattr(render, "screen_space", screen_space)
    monkeypatch.setattr(rasterize, "live_pair_slots", live_pair_slots)
    with profiling.recording():
        trainer.train(2, log_every=1 << 30)
        _frame(trainer)
    c = profiling.record()["counters"]
    assert len(seen["pairs"]) == 3 and len(seen["live"]) == 2
    assert c["bin.calls"] == 3
    assert c["bin.pairs_listed"] == sum(seen["pairs"])
    assert c["bin.pair_capacity"] == sum(seen["cap"])
    assert c["project.visible"] == sum(seen["visible"])
    assert c["project.rows"] == sum(seen["rows"])
    # the two steps' binnings had a backward, the frame's not
    assert c["bwd.pairs_listed"] == sum(seen["pairs"][:2])
    assert c["bwd.live_slots"] == sum(seen["live"])
    # one nonzero a step; the loss and the alive count once, at the end
    assert {k: v for k, v in c.items() if k.startswith("sync.")} == {
        "sync.live_slots": 2, "sync.loss": 1, "sync.alive_count": 1}
    assert not any(k.startswith("launch.") for k in c)  # no kernel on CPU


def test_launch_counts_are_the_increase_while_recording(monkeypatch):
    from dnsplatter_torch.ops import rasterize_cuda as rc

    monkeypatch.setattr(rc, "LAUNCHES", type(rc.LAUNCHES)({"fwd": 5}))
    with profiling.recording():
        with profiling.span("model.outputs"):
            rc.LAUNCHES["fwd"] += 2
            rc.LAUNCHES["bwd"] += 1
    rc.LAUNCHES["fwd"] += 7  # after the recording
    c = profiling.record()["counters"]
    assert c == {"launch.fwd": 2, "launch.bwd": 1}
    assert rc.LAUNCHES["fwd"] == 14


def test_span_record_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_ENTRIES", 8)
    monkeypatch.setattr(profiling, "MAX_PENDING", 4)
    with profiling.recording():
        for k in range(50):
            with profiling.span("train.step"):
                with profiling.span("train.forward"):
                    profiling.count("bin.pairs_listed", torch.tensor(k))
            assert len(profiling._entries) <= 8
            assert len(profiling._pending["bin.pairs_listed"]) <= 5
    rec = profiling.record()
    assert rec["spans"]["train.step"]["n"] == 50
    assert rec["spans"]["train.forward"]["parent"] == "train.step"
    assert rec["counters"]["bin.pairs_listed"] == sum(range(50))


def test_identifiers_threads_and_the_engine_parent(monkeypatch):
    got = {}

    def on_thread(name, key, go, done):
        go.wait()
        with profiling.span(name) as s:
            got[key] = s.parent
        done.set()

    with profiling.recording():
        with profiling.span("train.step") as step:
            with profiling.span("train.forward") as fwd:
                assert fwd.parent is step
            # a thread of its own (the viewer's): no parent
            go, done = threading.Event(), threading.Event()
            th = threading.Thread(target=on_thread, args=(
                "model.outputs", "viewer", go, done))
            th.start()
            go.set()
            th.join()
            assert got["viewer"] is None
            # the autograd engine's thread: the span around the grad call
            monkeypatch.setattr(profiling, "_graph_task_id", lambda: 0)
            with profiling.span("train.backward", grad=True) as bwd:
                go, done = threading.Event(), threading.Event()
                th = threading.Thread(target=on_thread, args=(
                    "raster.backward", "engine", go, done))
                th.start()
                go.set()
                th.join()
            assert got["engine"] is bwd
            assert not profiling._grad_callers
    sp = profiling.record()["spans"]
    assert sp["raster.backward"]["parent"] == "train.backward"
    assert sp["model.outputs"]["parent"] is None


def test_concurrent_spans_keep_their_own_parents():
    """More threads than cores under a short switch interval: every span
    and count survives, and each span keeps the parent of its own
    thread."""
    import os
    import sys

    errors = []
    pairs = (("train.step", "train.forward"),
             ("model.outputs", "render.screen"))
    n_threads = 2 * max(4, os.cpu_count() or 1)

    def loop(outer, inner):
        try:
            for _ in range(100):
                with profiling.span(outer) as o:
                    with profiling.span(inner) as i:
                        assert i.parent is o
                    profiling.count("bin.calls")
        except AssertionError as e:  # pragma: no cover - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            ths = [threading.Thread(target=loop, args=pairs[t % 2])
                   for t in range(n_threads)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in ths)
    finally:
        sys.setswitchinterval(interval)
    rec = profiling.record()
    assert not errors
    assert rec["counters"]["bin.calls"] == 100 * n_threads
    for outer, inner in pairs:
        assert rec["spans"][inner]["parent"] == outer
        assert rec["spans"][inner]["n"] == 100 * n_threads // 2
        assert rec["spans"][outer]["n"] == 100 * n_threads // 2


def _literal_names(fn_name: str):
    """(file, name) of every string literal passed first to
    `profiling.<fn_name>(...)` in the port's package."""
    out = []
    for path in (ROOT / "dnsplatter_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == fn_name
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "profiling" and node.args
                    and isinstance(node.args[0], ast.Constant)):
                out.append((path.name, node.args[0].value))
    return out


def test_span_and_counter_names_are_declared():
    spans = _literal_names("span")
    assert {n for _, n in spans} == set(profiling.SPANS)
    counters = {n for _, n in _literal_names("count")}
    assert counters <= set(profiling.COUNTERS)
    assert {n for _, n in _literal_names("host_read")} == {
        "live_slots", "piece_bounds", "bin_scatter", "loss", "alive_count",
        "refine_rows", "cull", "eval", "view_flag"}


def test_no_span_is_named_as_a_harness_label():
    """The harness gives a device operation to the latest-starting range
    of its label: a program range of the same name would take operations
    from it. Its labels are the third element of each `SPANS` entry of
    benchmark/harness/trace.py, read without importing it."""
    tree = ast.parse((ROOT / "benchmark" / "harness" / "trace.py")
                     .read_text())
    labels = None
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "SPANS"):
            labels = {ast.literal_eval(e)[2] for e in node.value.elts}
    assert labels and "autograd_grad" in labels
    assert not labels & set(profiling.SPANS)
    for name in profiling.SPANS:
        assert re.fullmatch(r"[a-z]+\.[a-z_]+", name)


RECORD = {
    "spans": {
        "train.forward": {"n": 20, "host_ms": 300.0, "stream_ms": 180.0,
                          "parent": "train.step"},
        "train.backward": {"n": 20, "host_ms": 500.0, "stream_ms": 400.0,
                           "parent": "train.step"},
        "model.outputs": {"n": 20, "host_ms": 290.0, "stream_ms": 170.0,
                          "parent": "train.forward"},
    },
    "counters": {
        "bin.calls": 20, "bin.pairs_listed": 6_000_000,
        "bin.pair_capacity": 24_000_000, "project.rows": 25_000_000,
        "project.visible": 7_500_000, "bwd.pairs_listed": 5_000_000,
        "bwd.live_slots": 3_000_000, "sync.live_slots": 20, "sync.loss": 1,
        "sync.alive_count": 1, "launch.forward_tiles": 20,
    },
}
METRICS = {
    "train.pair_fill": 25.0, "render.pair_fill": 25.0,
    "train.visible_share": 30.0, "render.visible_share": 30.0,
    "train.live_pair_share": 60.0, "train.host_syncs": 1.1,
    "train.forward_stream_ms": 9.0, "train.backward_stream_ms": 20.0,
    "render.frame_stream_ms": 8.5,
}


@pytest.fixture
def harness_cells(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "benchmark"))
    from harness import cells

    return cells


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_metric_reads_the_record(metric, harness_cells, monkeypatch):
    bench = harness_cells.load_benchmark()
    entry = [m for m in bench["per_layer"] if m["name"] == metric]
    assert len(entry) == 1
    read = harness_cells.reader(metric)
    monkeypatch.setattr(profiling, "record", lambda: RECORD)
    assert read({"units": 20}) == pytest.approx(METRICS[metric])
    # nothing recorded: no number
    monkeypatch.setattr(profiling, "record",
                        lambda: {"spans": {}, "counters": {}})
    assert read({"units": 20}) is None
    # a program without the recorder (the parent of this change)
    monkeypatch.delattr(profiling, "record")
    assert read({"units": 20}) is None


def test_profile_frame_stage_device_time():
    """profile_frame gives a device operation to every span whose host
    range, on any thread, holds the runtime call that launched it."""
    from types import SimpleNamespace as NS

    from dnsplatter_torch.scripts.profile_frame import stage_device_us
    from torch.autograd import DeviceType

    def ev(name, dev, cid, start, end):
        return NS(name=name, device_type=dev, id=cid,
                  time_range=NS(start=start, end=end))

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        ev("model.outputs", cpu, 1, 0, 100),
        ev("raster.bin", cpu, 2, 10, 40),
        ev("raster.bin", cpu, 3, 60, 70),  # a second binning
        ev("cudaLaunchKernel", cpu, 7, 15, 16),
        ev("cuLaunchKernel", cpu, 8, 65, 66),  # a ctypes launch
        ev("cudaLaunchKernel", cpu, 9, 80, 81),
        ev("cudaLaunchKernel", cpu, 10, 150, 151),  # outside every span
        ev("sort_kernel", cuda, 7, 200, 205),
        ev("tiles_kernel", cuda, 8, 210, 230),
        ev("finish_kernel", cuda, 9, 240, 241),
        ev("late_kernel", cuda, 10, 250, 290),
        ev("raster.bin", cuda, 2, 200, 205),  # a mirrored annotation
    ]
    assert stage_device_us(events) == {"model.outputs": 26.0,
                                       "raster.bin": 25.0}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: stream times are read on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_stream_times_on_the_card(dev):
    tr = _trainer(device=dev)
    tr.train(2, log_every=1 << 30)
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        tr.train(3, log_every=1 << 30)
    sp = profiling.record()["spans"]
    for name, s in sp.items():
        assert s["stream_ms"] is not None and s["stream_ms"] > 0, name
    for name, parent in STEP_SPANS.items():
        if parent is not None and name in sp:
            assert sp[parent]["stream_ms"] >= sp[name]["stream_ms"], name
    assert sp["raster.backward"]["parent"] == "train.backward"
    c = profiling.record()["counters"]
    assert c["launch.forward_tiles"] == 3 and c["launch.backward_tiles"] == 3
