"""dnsplatter_torch's tool wrappers against the JAX package's: the command
lines they give ffmpeg, colmap, sai-cli, wget, unzip and tar (fake
binaries first on PATH record their argv; nothing reaches the network),
the SystemExit when a binary is missing, the COLMAP sparse model written
from known poses (byte-equal files), the LPIPS weight export through a
stub `lpips` module (equal npz files, which the port's LPIPS loads), and
the profiling helpers."""

import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from dnsplatter_torch.data import download_scripts as tdl
from dnsplatter_torch.scripts import comparison_video as tcv
from dnsplatter_torch.scripts import convert_colmap as tcc
from dnsplatter_torch.scripts import export_lpips_weights as tex
from dnsplatter_torch.scripts import poses_to_colmap_sfm as tps
from dnsplatter_torch.scripts import process_sai as tsai
from dnsplatter_tpu.data import download_scripts as jdl
from dnsplatter_tpu.scripts import comparison_video as jcv
from dnsplatter_tpu.scripts import convert_colmap as jcc
from dnsplatter_tpu.scripts import export_lpips_weights as jex
from dnsplatter_tpu.scripts import poses_to_colmap_sfm as jps
from dnsplatter_tpu.scripts import process_sai as jsai

torch.set_num_threads(1)
BINARIES = ("ffmpeg", "colmap", "sai-cli", "wget", "unzip", "tar")


@pytest.fixture
def fake_bin(tmp_path, monkeypatch):
    """Fake binaries first on PATH; returns a function that reads and
    clears the argv they recorded."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "argv.log"
    for name in BINARIES:
        exe = bindir / name
        exe.write_text(
            "#!/bin/sh\n"
            "{ printf '%s' \"$(basename \"$0\")\"; for a in \"$@\"; do "
            "printf '\\t%s' \"$a\"; done; printf '\\n'; } >> \"$FAKE_LOG\"\n")
        exe.chmod(0o755)
    monkeypatch.setenv("FAKE_LOG", str(log))
    monkeypatch.setenv("PATH", f"{bindir}:/usr/bin:/bin")

    def calls():
        if not log.exists():
            return []
        out = [line.split("\t") for line in log.read_text().splitlines()]
        log.unlink()
        return out

    return calls


@pytest.fixture
def no_bin(monkeypatch, tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))


def test_comparison_video_argv(fake_bin, tmp_path):
    for mod in (jcv, tcv):
        mod.main(["--left", str(tmp_path / "a"), "--right",
                  str(tmp_path / "b"), "--out", str(tmp_path / "v.mp4"),
                  "--fps", "24"])
    j, t = fake_bin()
    assert j == t and j[0] == "ffmpeg" and "hstack=inputs=2" in j


def test_convert_colmap_argv(fake_bin, tmp_path):
    got = [mod.run_colmap(tmp_path / "images", tmp_path / "out",
                          matcher="exhaustive") for mod in (jcc, tcc)]
    assert got[0] == got[1] == tmp_path / "out" / "sparse" / "0"
    calls = fake_bin()
    assert calls[:3] == calls[3:] and len(calls) == 6
    assert [c[1] for c in calls[:3]] == ["feature_extractor",
                                         "exhaustive_matcher", "mapper"]


def test_process_sai_argv_and_sorted_frames(fake_bin, tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    frames = [{"file_path": f"images/{i:03d}.png"} for i in (3, 1, 2)]
    results = []
    for mod in (jsai, tsai):
        (out / "transforms.json").write_text(json.dumps({"frames": frames}))
        mod.main(["--input", str(tmp_path / "in"), "--output", str(out),
                  "--fps", "5"])
        results.append((out / "transforms.json").read_bytes())
    j, t = fake_bin()
    assert j == t and j[:2] == ["sai-cli", "process"]
    assert results[0] == results[1]
    assert [f["file_path"] for f in json.loads(results[1])["frames"]] == [
        "images/001.png", "images/002.png", "images/003.png"]


def test_download_scripts_argv(fake_bin, tmp_path):
    assert tdl.DATASETS == jdl.DATASETS
    runs = (["mushroom", "--room", "honka"], ["replica"], ["dtu"],
            ["mushroom"])
    for argv in runs:
        for mod, sub in ((jdl, "j"), (tdl, "t")):
            mod.main(argv + ["--output-dir", str(tmp_path / sub)])
        calls = fake_bin()
        half = len(calls) // 2
        j = [[a.replace(str(tmp_path / "j"), "D") for a in c]
             for c in calls[:half]]
        t = [[a.replace(str(tmp_path / "t"), "D") for a in c]
             for c in calls[half:]]
        assert j == t, argv
    # the last run: every room, each a wget and an unzip
    assert [c[0] for c in t] == ["wget", "unzip"] * 8
    assert t[0][:4] == ["wget", "-c", "-O", "D/mushroom/coffee_room.zip"]


def test_missing_binaries_exit_alike(no_bin, tmp_path):
    calls = (
        lambda m: m.make_video(tmp_path, tmp_path, tmp_path / "v.mp4"),
        lambda m: m.run_colmap(tmp_path, tmp_path / "o"),
        lambda m: m.process(tmp_path, tmp_path / "o"),
        lambda m: m.run_colmap_triangulation(tmp_path, tmp_path / "s"),
    )
    for call, (jm, tm) in zip(calls, ((jcv, tcv), (jcc, tcc), (jsai, tsai),
                                      (jps, tps))):
        msgs = []
        for mod in (jm, tm):
            with pytest.raises(SystemExit) as e:
                call(mod)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and "not found" in msgs[1]


def _transforms(tmp_path, per_frame: bool):
    rng = np.random.default_rng(0)
    frames = []
    for i in range(4):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        q *= np.sign(np.linalg.det(q))
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = q, rng.normal(size=3)
        fr = {"file_path": f"images/frame_{i:05d}.jpg",
              "transform_matrix": (c2w[:3] if i == 2 else c2w).tolist()}
        if per_frame:
            fr.update(w=64, h=48, fl_x=50.0 + i, fl_y=51.0, cx=32.1, cy=23.9)
        frames.append(fr)
    data = {"frames": frames}
    if not per_frame:
        data.update(w=64, h=48, fl_x=50.5, fl_y=51.5, cx=32.0, cy=24.0,
                    camera_model="PINHOLE")
    path = tmp_path / "transforms.json"
    path.write_text(json.dumps(data))
    return path


@pytest.mark.parametrize("per_frame", [False, True])
@pytest.mark.parametrize("colmap_world", [True, False])
def test_write_sparse_model_byte_equal(tmp_path, per_frame, colmap_world):
    path = _transforms(tmp_path, per_frame)
    outs = [mod.write_sparse_model(path, tmp_path / name,
                                   colmap_world) for mod, name in
            ((jps, "j"), (tps, "t"))]
    for f in ("cameras.txt", "images.txt", "points3D.txt"):
        assert (outs[0] / f).read_bytes() == (outs[1] / f).read_bytes(), f
    assert len((outs[1] / "images.txt").read_text().splitlines()) == 8


def test_poses_to_colmap_sfm_main_argv(fake_bin, tmp_path):
    path = _transforms(tmp_path, False)
    for mod in (jps, tps):
        mod.main(["--transforms", str(path), "--run-colmap"])
    calls = fake_bin()
    assert calls[:3] == calls[3:] and len(calls) == 6
    assert [c[1] for c in calls[3:]] == ["feature_extractor",
                                         "exhaustive_matcher",
                                         "point_triangulator"]
    assert (tmp_path / "sparse" / "0" / "images.txt").exists()


class _StubLPIPS:
    """`lpips.LPIPS(net="vgg")`'s attributes the exporter reads: the five
    VGG16 slices (seeded Conv2d, ReLU, MaxPool) and the linear heads."""

    def __init__(self, net="vgg"):
        assert net == "vgg"
        torch.manual_seed(0)
        nn = torch.nn
        chans, convs, slices, in_ch = (64, 128, 256, 512, 512), \
            (2, 2, 3, 3, 3), [], 3
        for block, (c, n) in enumerate(zip(chans, convs)):
            layers = [nn.MaxPool2d(2)] if block else []
            for _ in range(n):
                layers += [nn.Conv2d(in_ch, c, 3, padding=1), nn.ReLU()]
                in_ch = c
            slices.append(nn.Sequential(*layers))
        self.net = types.SimpleNamespace(**{f"slice{i + 1}": s
                                            for i, s in enumerate(slices)})
        self.lins = [types.SimpleNamespace(model=nn.Sequential(
            nn.Dropout(), nn.Conv2d(c, 1, 1, bias=False))) for c in chans]


def test_export_lpips_weights_equal_and_loaded(tmp_path, monkeypatch):
    from dnsplatter_torch.eval.metrics import lpips_from_npz

    monkeypatch.setitem(sys.modules, "lpips",
                        types.SimpleNamespace(LPIPS=_StubLPIPS))
    jex.main(["--out", str(tmp_path / "j.npz")])
    tex.main(["--out", str(tmp_path / "t.npz")])
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        assert len(t.files) == 2 * 13 + 5
        for k in j.files:
            np.testing.assert_array_equal(j[k], t[k])
        assert t["conv0_w"].shape == (3, 3, 3, 64)
    lp = lpips_from_npz(tmp_path / "t.npz")
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.uniform(size=(32, 32, 3)), dtype=torch.float32)
    b = torch.as_tensor(rng.uniform(size=(32, 32, 3)), dtype=torch.float32)
    with torch.no_grad():
        assert float(lp(a, a)) == 0.0 and np.isfinite(float(lp(a, b)))


def test_export_lpips_weights_without_lpips_exits(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "lpips", None)
    with pytest.raises(SystemExit, match="lpips"):
        tex.main(["--out", str(tmp_path / "t.npz")])
    assert not Path(tmp_path / "t.npz").exists()


def test_profiling_trace_and_timers(tmp_path, monkeypatch):
    """`trace` writes a Chrome trace of the block and yields the profiler;
    the recorder's summary sums each span's host time as the JAX module's
    section timers do, on the same clock readings; rays/s is the JAX
    module's."""
    from dnsplatter_torch.utils import profiling as tprof
    from dnsplatter_tpu.utils import profiling as jprof

    with tprof.trace(tmp_path / "t") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.name for e in prof.events())
    assert json.loads((tmp_path / "t" / "trace.json").read_text())
    readings = [0.0, 0.25, 1.0, 1.5, 2.0, 2.125]
    clock = iter(readings)
    monkeypatch.setattr(jprof.time, "perf_counter", lambda: next(clock))
    timers = jprof.SectionTimers()
    for name in ("render", "loss", "render"):
        with timers.section(name):
            pass
    clock_ns = iter(int(r * 1e9) for r in readings)
    monkeypatch.setattr(tprof.time, "perf_counter_ns", lambda: next(clock_ns))
    with tprof.recording():
        for name in ("model.outputs", "train.loss", "model.outputs"):
            with tprof.span(name):
                pass
    spans = tprof.record()["spans"]
    for jname, tname in (("render", "model.outputs"), ("loss", "train.loss")):
        want = timers.summary()[jname]
        assert spans[tname]["n"] == want["count"]
        assert spans[tname]["host_ms"] == pytest.approx(1e3 * want["total_s"])
    assert spans["model.outputs"] == {"n": 2, "host_ms": 375.0,
                                      "stream_ms": None, "parent": None}
    assert tprof.rays_per_sec(64, 48, 0.5) == jprof.rays_per_sec(64, 48,
                                                                  0.5)
