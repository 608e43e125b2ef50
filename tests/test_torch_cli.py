"""dnsplatter_torch's CLI surface against the JAX package's: method presets,
the dataclass flags, value parsing, entry-point plugins, the tfevents
writer (crc32c, and files each package reads from the other), and one
chain through `python -m dnsplatter_torch.cli` on the CPU: `train` on a
48x48 MuSHRoom capture with TensorBoard on, `eval` with both protocols and
`--save-renders`, `render` on the same checkpoint (its renders equal to
eval's), `vis_errors` on its tree, `export dn`, then the MuSHRoom mesh protocol on the exported mesh (the port's
counterpart of tests/test_e2e_protocol.py).

Equality throughout, except the chain, which checks its outputs for
existence and finiteness (a 4-step model's numbers are not quality
figures), and the exported mesh scored against a jittered copy of itself.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dnsplatter_torch import cli as tcli
from dnsplatter_torch import configs as tconfigs
from dnsplatter_torch.data import io as tio
from dnsplatter_torch.data import parsers as tparsers
from dnsplatter_torch.utils import plugins as tplugins
from dnsplatter_torch.utils import writers as twriters
from dnsplatter_tpu import configs as jconfigs
from dnsplatter_tpu.utils import writers as jwriters

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
W = H = 48
FOCAL = 80.0


def test_method_presets_equal():
    assert tconfigs.METHOD_PRESETS == jconfigs.METHOD_PRESETS
    for m in tconfigs.METHOD_PRESETS:
        got = dataclasses.asdict(tconfigs.model_config_for_method(m))
        want = dataclasses.asdict(jconfigs.model_config_for_method(m))
        assert got == {k: want[k] for k in got}


def _flags(configs, cls, prefix):
    p = argparse.ArgumentParser()
    configs.add_dataclass_args(p, cls, prefix)
    return {a.option_strings[0]: a.dest for a in p._actions
            if a.option_strings and a.dest != "help"}


def test_dataclass_flags_equal_on_shared_fields():
    from dnsplatter_torch.data.parsers.mushroom import (
        MushroomParserConfig as TMush)
    from dnsplatter_torch.models.dn_model import ModelConfig as TModel
    from dnsplatter_torch.train.optim import OptimConfig as TOptim
    from dnsplatter_torch.train.trainer import TrainConfig as TTrain
    from dnsplatter_tpu.data.parsers.mushroom import (
        MushroomParserConfig as JMush)
    from dnsplatter_tpu.models.dn_model import ModelConfig as JModel
    from dnsplatter_tpu.train.optim import OptimConfig as JOptim
    from dnsplatter_tpu.train.trainer import TrainConfig as JTrain

    for tcls, jcls, prefix in ((TModel, JModel, "model"),
                               (TTrain, JTrain, "train"),
                               (TOptim, JOptim, "optim"),
                               (TMush, JMush, "parser")):
        got = _flags(tconfigs, tcls, prefix)
        want = _flags(jconfigs, jcls, prefix)
        shared = set(got) & set(want)
        assert len(shared) >= 0.9 * len(want), set(want) - set(got)
        assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
        args = argparse.Namespace(**{d: None for d in got.values()})
        assert tconfigs.build_dataclass(tcls, args, prefix, tcls(
            **({"data": Path(".")} if prefix == "parser" else {}))) == tcls(
            **({"data": Path(".")} if prefix == "parser" else {}))


@pytest.mark.parametrize("text,typ,want", [
    ("true", bool, True), ("On", bool, True), ("0", bool, False),
    ("no", bool, False), ("a/b", Path, Path("a/b")), ("xyz", str, "xyz"),
    ("3", int, 3), ("1e5", int, 100_000), ("2.0", int, 2),
    ("0.25", float, 0.25), ("1e-3", float, 1e-3)])
def test_parse_value_cases(text, typ, want):
    got = tconfigs._parse_value(text, typ)
    assert got == want == jconfigs._parse_value(text, typ)
    assert type(got) is type(want)


def test_parse_value_rejects():
    for mod in (tconfigs, jconfigs):
        with pytest.raises(ValueError, match="integer"):
            mod._parse_value("2.5", int)
        with pytest.raises(ValueError):
            mod._parse_value("abc", int)


# -- plugins (mirroring tests/test_plugins.py) ---------------------------------


class _EP:
    def __init__(self, name, obj):
        self.name = name
        self.value = f"fake.module:{name}"
        self._obj = obj

    def load(self):
        if isinstance(self._obj, Exception):
            raise self._obj
        return self._obj


@pytest.fixture
def fake_eps(monkeypatch):
    table = {}
    monkeypatch.setattr(tplugins, "iter_entry_points",
                        lambda group: table.get(group, []))
    before_methods = dict(tconfigs.METHOD_PRESETS)
    # every built-in parser registered before the snapshot: get_parser
    # imports (and so registers) them all, and a module imported during
    # the test would not register again after the restore
    tparsers.get_parser("mushroom")
    before_parsers = dict(tparsers.PARSERS)
    yield table
    tconfigs.METHOD_PRESETS.clear()
    tconfigs.METHOD_PRESETS.update(before_methods)
    tparsers.PARSERS.clear()
    tparsers.PARSERS.update(before_parsers)


def test_plugin_groups():
    assert tplugins.METHODS_GROUP == "dnsplatter_torch.methods"
    assert tplugins.DATAPARSERS_GROUP == "dnsplatter_torch.dataparsers"


def test_method_plugins(fake_eps):
    fake_eps[tplugins.METHODS_GROUP] = [
        _EP("my-method", dict(regularization_strategy="ags-mesh",
                              depth_lambda=0.5)),
        _EP("my-callable", lambda: dict(depth_lambda=0.25)),
        _EP("dn-splatter", dict(depth_lambda=99.0)),
        _EP("boom", ImportError("missing dep")),
        _EP("bad-fields", dict(not_a_model_field=1)),
    ]
    with pytest.warns(UserWarning) as rec:
        tconfigs.load_method_plugins()
    msgs = " ".join(str(w.message) for w in rec)
    assert "shadows a built-in" in msgs and "failed to load plugin" in msgs
    cfg = tconfigs.model_config_for_method("my-method")
    assert cfg.regularization_strategy == "ags-mesh"
    assert cfg.depth_lambda == 0.5
    assert tconfigs.model_config_for_method("my-callable").depth_lambda == 0.25
    assert tconfigs.model_config_for_method("dn-splatter").depth_lambda != 99
    assert "boom" not in tconfigs.METHOD_PRESETS
    assert "bad-fields" not in tconfigs.METHOD_PRESETS
    # a built config is a copy: the registry keeps the preset
    assert tconfigs.model_config_for_method(
        "my-method", depth_lambda=0.7).depth_lambda == 0.7
    assert tconfigs.METHOD_PRESETS["my-method"]["depth_lambda"] == 0.5
    # a second discovery pass does not mistake a loaded plugin for a
    # built-in
    fake_eps[tplugins.METHODS_GROUP] = fake_eps[tplugins.METHODS_GROUP][:2]
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tconfigs.load_method_plugins()


def test_dataparser_plugin_loaded_by_get_parser(fake_eps):
    def sentinel(cfg, split):
        return ("parsed", split)

    fake_eps[tplugins.DATAPARSERS_GROUP] = [_EP("my-format", sentinel),
                                            _EP("replica", sentinel)]
    with pytest.warns(UserWarning, match="shadows a built-in"):
        parse = tparsers.get_parser("my-format")
    assert parse("cfg", "train") == ("parsed", "train")
    assert tparsers.get_parser("replica") is not sentinel
    with pytest.raises(KeyError, match="unknown dataparser"):
        tparsers.get_parser("no-such-format")
    # the CLI finds it too, with no config class and no device argument
    assert tcli._parser_config_cls("my-format") == (sentinel, None)
    ns = argparse.Namespace(dataparser="my-format", data=Path("."),
                            device="cpu")
    assert tcli._load_dataset(ns, None, "val") == ("parsed", "val")


# -- the tfevents writer ---------------------------------------------------------


def test_crc32c_vectors():
    for data, want in ((b"", 0x0), (b"a", 0xC1D04330),
                       (b"123456789", 0xE3069283),
                       (bytes(32), 0x8A9136AA),
                       (b"\xff" * 32, 0x62A8AB43)):
        assert twriters.crc32c(data) == want == jwriters.crc32c(data)
        assert twriters._masked_crc(data) == jwriters._masked_crc(data)


def test_tfevents_read_across_packages(tmp_path):
    rows = [(1, {"loss": 0.5, "psnr": np.float32(21.5), "n": 7}),
            (20, {"loss": 0.25, "skip": "text"}), (300, {})]
    for writer_mod, reader_mod, name in ((twriters, jwriters, "t"),
                                         (jwriters, twriters, "j")):
        w = writer_mod.TensorboardWriter(tmp_path / name, run_name="x")
        for step, scalars in rows:
            w.write_scalars(step, scalars)
        w.close()
        events = reader_mod.read_tfevents_scalars(w.path)
        assert events[0]["file_version"] == "brain.Event:2"
        assert [e["step"] for e in events[1:]] == [1, 20]
        assert events[1]["scalars"] == {"loss": 0.5, "psnr": 21.5, "n": 7.0}
        assert events[2]["scalars"] == {"loss": 0.25}
    a = twriters.read_tfevents_scalars(next((tmp_path / "t").iterdir()))
    b = jwriters.read_tfevents_scalars(next((tmp_path / "j").iterdir()))
    assert [e["scalars"] for e in a] == [e["scalars"] for e in b]
    jl = twriters.JsonlWriter(tmp_path / "jl")
    jl.write_scalars(3, {"loss": np.float32(0.5), "tag": "x"})
    jl.close()
    assert json.loads((tmp_path / "jl" / "metrics.jsonl").read_text()) == {
        "step": 3, "loss": 0.5, "tag": "x"}


# -- the command chain -------------------------------------------------------------


def _write_capture(root: Path):
    """A MuSHRoom iphone capture of a synthetic scene: five long-capture
    views (test.txt names one), two short ones, and a seed cloud near the
    scene's Gaussians (tests/test_e2e_protocol.py's layout)."""
    from dnsplatter_torch.data.synthetic import make_gt_gaussians, ring_cameras
    from dnsplatter_torch.ops.rasterize import RasterizeConfig
    from dnsplatter_torch.ops.render import render

    rng = np.random.default_rng(0)
    gt, alive = make_gt_gaussians(rng, 150, device="cpu")
    seeds = gt.means.numpy() + rng.normal(0, 0.02, (150, 3))
    tio.write_ply(root / "iphone_pointcloud.ply", seeds.astype(np.float32),
                  colors=rng.uniform(0, 1, (150, 3)).astype(np.float32))
    cams = ring_cameras(7, radius=3.0, width=W, img_height=H, focal=FOCAL,
                        device="cpu")
    cfg = RasterizeConfig(width=W, height=H, chunk=32, tile_block=4,
                          pair_capacity=1 << 13)
    for capture, idx in (("long_capture", [0, 1, 2, 4, 5]),
                         ("short_capture", [3, 6])):
        cdir = root / "iphone" / capture
        (cdir / "images").mkdir(parents=True)
        (cdir / "depth").mkdir()
        frames = []
        for j, i in enumerate(idx):
            with torch.no_grad():
                out, _ = render(gt, alive, cams[i], cfg,
                                background=torch.zeros(3))
            depth = torch.where(out.accumulation > 0.5, out.depth, 0.0)
            tio.write_image(cdir / "images" / f"{j:04d}.png",
                            out.rgb.numpy())
            tio.write_depth_png(cdir / "depth" / f"{j:04d}.png",
                                depth.numpy())
            frames.append({"file_path": f"images/{j:04d}.png",
                           "depth_file_path": f"depth/{j:04d}.png",
                           "transform_matrix": cams[i].c2w.numpy().tolist()})
        (cdir / "transformations.json").write_text(json.dumps(
            {"fl_x": FOCAL, "fl_y": FOCAL, "cx": W / 2, "cy": H / 2, "w": W,
             "h": H, "frames": frames}))
    (root / "iphone" / "long_capture" / "test.txt").write_text("0004\n")


def _cli(*args, timeout=600):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-m", "dnsplatter_torch.cli", *args],
                       capture_output=True, text=True, env=env,
                       timeout=timeout, cwd=REPO)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-2500:]
    return r


def test_cli_chain_on_the_cpu(tmp_path):
    _write_capture(tmp_path)
    out_dir = tmp_path / "run"
    _cli("train", "dn-splatter", "mushroom", "--data", str(tmp_path),
         "--output-dir", str(out_dir), "--max-iterations", "4",
         "--device", "cpu", "--parser.num-init-points", "512",
         "--model.use-depth-loss", "true", "--model.use-normal-loss", "true",
         "--model.sh-degree", "1", "--train.chunk", "32",
         "--train.tile-block", "2", "--train.steps-per-eval-image", "0",
         "--train.tensorboard", "true")
    ckpts = sorted(out_dir.glob("ckpt_*.npz"))
    assert [c.name for c in ckpts] == ["ckpt_000004.npz"]
    assert list((tmp_path / "iphone/long_capture/normals_from_depth")
                .glob("*.png"))
    (tb,) = (out_dir / "tb").iterdir()
    events = jwriters.read_tfevents_scalars(tb)
    losses = [e["scalars"]["loss"] for e in events if "loss" in e["scalars"]]
    assert losses and np.isfinite(losses).all()
    assert (out_dir / "metrics.jsonl").exists()

    _cli("eval", "--checkpoint", str(ckpts[-1]), "--dataparser", "mushroom",
         "--data", str(tmp_path), "--split", "val", "--pair-capacity",
         "4096", "--parser.eval-mode", "all", "--device", "cpu",
         "--output-dir", str(tmp_path / "evald"), "--save-renders")
    metrics = json.loads((tmp_path / "evald" / "metrics.json").read_text())
    for key in ("within_rgb_psnr", "with_rgb_psnr", "rgb_psnr",
                "within_depth_rmse", "with_depth_rmse"):
        assert np.isfinite(metrics[key]), key
    assert metrics["within_num_images"] == 1
    assert metrics["with_num_images"] == 2

    # `render` on the same checkpoint and split: the renders of `eval
    # --save-renders`, plus depth colormaps, and error maps over the tree
    _cli("render", "--checkpoint", str(ckpts[-1]), "--dataparser",
         "mushroom", "--data", str(tmp_path), "--split", "val",
         "--pair-capacity", "4096", "--parser.eval-mode", "all",
         "--device", "cpu", "--output-dir", str(tmp_path / "renders"))
    rendered = sorted((tmp_path / "renders" / "pred" / "rgb").glob("*.png"))
    assert len(rendered) == 3
    for sub, pattern in (("pred/rgb", "*.png"), ("pred/normal", "*.png"),
                         ("gt/rgb", "*.png"), ("pred/depth", "*.npy")):
        got = sorted((tmp_path / "renders" / sub).glob(pattern))
        want = sorted((tmp_path / "evald" / sub).glob(pattern))
        assert [p.name for p in got] == [p.name for p in want], sub
        for a, b in zip(got, want):
            if a.suffix == ".npy":
                np.testing.assert_array_equal(np.load(a), np.load(b))
            else:
                np.testing.assert_array_equal(tio.read_image(a),
                                              tio.read_image(b))
    maps = sorted((tmp_path / "renders" / "pred" / "depth_colormaps")
                  .glob("*.png"))
    assert len(maps) == 3 and tio.read_image(maps[0]).shape == (H, W, 3)
    from dnsplatter_torch.scripts import vis_errors

    assert vis_errors.main(["--renders", str(tmp_path / "renders")]) == 9

    _cli("export", "dn", "--checkpoint", str(ckpts[-1]), "--dataparser",
         "mushroom", "--data", str(tmp_path), "--parser.num-init-points",
         "512", "--output-dir", str(tmp_path / "exports"),
         "--poisson-resolution", "32", "--pair-capacity", "4096",
         "--device", "cpu")
    mesh = tio.read_ply(tmp_path / "exports"
                        / "DepthAndNormals_poisson_mesh.ply")
    assert (tmp_path / "exports" / "TSDFfusion_mesh.ply").exists()
    pred_v, pred_f = mesh["points"], mesh["faces"]
    assert len(pred_f) > 0 and np.isfinite(pred_v).all()
    assert pred_f.max() < len(pred_v)

    from dnsplatter_torch.data.parsers.mushroom import (
        MushroomParserConfig, parse)
    from dnsplatter_torch.eval.mesh_mushroom import evaluate_mesh_mushroom

    ds = parse(MushroomParserConfig(data=tmp_path, num_init_points=512),
               "train", device="cpu")
    cams = [ds.camera(i) for i in range(len(ds))]
    depths = [ds.get(i)[1]["sensor_depth"] for i in range(len(ds))]
    gt_v = pred_v + np.random.default_rng(0).normal(0, 1e-3, pred_v.shape)
    m = evaluate_mesh_mushroom(pred_v, pred_f, gt_v, pred_f, cams,
                               gt_depths=depths, icp_transform=np.eye(4),
                               subdivide=False, num_samples=4000,
                               obs_threshold=1, device="cpu")
    assert np.isfinite(m["chamfer_l1"]) and m["chamfer_l1"] < 0.2
    assert m["fscore"] > 0.5


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("capture")
    _write_capture(root)
    return root


@pytest.mark.parametrize("method", ["gnerfacto", "gdepthfacto", "gneusfacto"])
def test_cli_trains_the_baselines_on_the_cpu(method, capture, tmp_path):
    """`train <baseline> mushroom` at the methods' full widths, 2 steps: the
    checkpoint's leaves have the shapes of the JAX package's, in its
    flatten order, and the history is written."""
    import jax

    from dnsplatter_tpu.baselines import nerfacto as jnf
    from dnsplatter_tpu.baselines import neusfacto as jns

    out_dir = tmp_path / "run"
    params, history = tcli.cmd_train([
        method, "mushroom", "--data", str(capture), "--output-dir",
        str(out_dir), "--max-iterations", "2", "--device", "cpu",
        "--parser.num-init-points", "512"])
    mod, cfg = ((jns, jns.NeuSConfig()) if method == "gneusfacto"
                else (jnf, jnf.NerfactoConfig()))
    init = jax.eval_shape(lambda k: mod.init_params(k, cfg),
                          jax.random.PRNGKey(0))
    with np.load(out_dir / f"baseline_{method}.npz") as z:
        shapes = [z[f"leaf_{j}"].shape for j in range(len(z.files))]
        assert all(np.isfinite(z[k]).all() for k in z.files)
    assert shapes == [x.shape for x in jax.tree.leaves(init)]
    rows = json.loads((out_dir / f"baseline_{method}_history.json")
                      .read_text())
    assert rows == history and rows[-1]["step"] == 2
    assert np.isfinite(rows[-1]["loss"])
    assert next(params.parameters()).device.type == "cpu"


def test_unported_commands_name_their_items(tmp_path):
    # ported since: in one process, dp 2 names the launch it needs
    with pytest.raises(ValueError, match="torchrun"):
        tcli.cmd_train(["dn-splatter", "my-format", "--data", str(tmp_path),
                        "--device", "cpu", "--train.dp", "2"])


@pytest.fixture(autouse=True)
def _my_format(request, monkeypatch):
    """A dataparser of two synthetic frames under the name `my-format`."""
    if request.node.name != "test_unported_commands_name_their_items":
        return
    from dnsplatter_torch.data.synthetic import make_synthetic_scene

    def parse(cfg, split, device=None):
        return make_synthetic_scene(n_gaussians=50, n_cameras=2, width=32,
                                    height=32, device=device)

    monkeypatch.setitem(tparsers.PARSERS, "my-format", parse)
