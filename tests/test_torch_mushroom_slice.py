"""The data-to-metrics slice on both packages: a MuSHRoom iphone capture
rendered from a synthetic scene and written to disk (images, 16-bit depth,
transformations.json, test.txt; no normals, masks or seed cloud), parsed by
each package in its own copy, three training steps from the same state,
then `evaluate` of one trained model on the test split with the default
LPIPS, point-cloud extraction against the regenerated seed cloud, ICP and
the with / within protocols.

Tolerances: the three losses rel 1e-3 (test_torch_train.py's trajectory
rule); the metrics rel 1e-4 and their stds rel 1e-3 beside 1e-4 of the
mean (test_torch_eval.py's rule); the seed cloud exactly.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from dnsplatter_torch.data import io as tio
from dnsplatter_torch.data.parsers import get_parser as t_get_parser
from dnsplatter_torch.data.parsers.mushroom import (
    MushroomParserConfig as TMushroomConfig)
from dnsplatter_torch.data.synthetic import make_gt_gaussians, ring_cameras
from dnsplatter_torch.eval.evaluator import evaluate as t_evaluate
from dnsplatter_torch.models import dn_model as tdn
from dnsplatter_torch.models import gaussians as tg
from dnsplatter_torch.ops.rasterize import RasterizeConfig
from dnsplatter_torch.ops.render import render
from dnsplatter_torch.train import trainer as ttr
from dnsplatter_tpu.data.parsers import get_parser as j_get_parser
from dnsplatter_tpu.data.parsers.mushroom import (
    MushroomParserConfig as JMushroomConfig)
from dnsplatter_tpu.eval.evaluator import evaluate as j_evaluate
from dnsplatter_tpu.models import dn_model as jdn
from dnsplatter_tpu.train import trainer as jtr

from test_torch_parsers import register_builtin_parsers  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _builtin_parsers():
    """The built-in parsers registered whatever earlier tests in the
    process left (test_torch_parsers.register_builtin_parsers)."""
    with pytest.MonkeyPatch.context() as mp:
        register_builtin_parsers(mp)
        yield
W, H = 64, 48
FOCAL = 45.0
N_SEEDS = 1500
STEPS = 3
PARSE_KW = dict(eval_mode="all", num_init_points=N_SEEDS,
                load_depth_confidence_masks=True)
MODEL_KW = dict(use_depth_loss=True, depth_lambda=0.2, use_normal_loss=True,
                normal_lambda=0.1, warmup_length=10_000, sh_degree=1,
                num_downscales=0, background_color="black")
# tile_block 256: the key layout in which the two packages' depth bits agree
# (test_torch_train.py)
TRAIN_KW = dict(pair_capacity=1 << 14, chunk=32, tile_block=256, seed=3,
                steps_per_eval_image=0)


def write_capture(root):
    """Eight ring views of a 400-Gaussian scene: six in the long capture
    (two of them named in test.txt), two in the short one."""
    rng = np.random.default_rng(0)
    gt, alive = make_gt_gaussians(rng, 400, extent=1.0, device="cpu")
    cams = ring_cameras(8, radius=3.0, width=W, img_height=H, focal=FOCAL,
                        device="cpu")
    cfg = RasterizeConfig(width=W, height=H, chunk=32, tile_block=4,
                          pair_capacity=1 << 14)
    captures = {"long_capture": [0, 1, 2, 4, 5, 6], "short_capture": [3, 7]}
    for capture, idx in captures.items():
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
    (root / "iphone" / "long_capture" / "test.txt").write_text("0001\n0004\n")


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mushroom")
    write_capture(tmp / "src")
    for pkg in ("jax", "torch"):
        shutil.copytree(tmp / "src", tmp / pkg)
    jparse, tparse = j_get_parser("mushroom"), t_get_parser("mushroom")
    jcfg = JMushroomConfig(data=tmp / "jax", **PARSE_KW)
    tcfg = TMushroomConfig(data=tmp / "torch", **PARSE_KW)
    jtrain, jtest = jparse(jcfg, "train"), jparse(jcfg, "test")
    ttrain = tparse(tcfg, "train", device="cpu")
    ttest = tparse(tcfg, "test", device="cpu")

    jt = jtr.Trainer(jtrain, jtrain.seed(),
                     model_cfg=jdn.ModelConfig(**MODEL_KW),
                     train_cfg=jtr.TrainConfig(**TRAIN_KW))
    tt = ttr.Trainer(ttrain, ttrain.seed(),
                     model_cfg=tdn.ModelConfig(**MODEL_KW),
                     train_cfg=ttr.TrainConfig(**TRAIN_KW), device="cpu")
    to_port = lambda p: tg.params_from_numpy(  # noqa: E731
        {f: np.asarray(getattr(p, f)) for f in tg.FIELDS}, device="cpu")
    tt.params = to_port(jt.params)
    jh = jt.train(num_steps=STEPS, log_every=1)
    th = tt.train(num_steps=STEPS, log_every=1)

    # one trained model, evaluated by both packages
    kw = dict(pair_capacity=1 << 14, extract_pointcloud=True,
              run_icp_if_missing=True, pcd_stride=2)
    jm = j_evaluate(jt.params, jt.alive, jtest,
                    reference_points=jtrain.seed_points, **kw)
    tm = t_evaluate(to_port(jt.params), torch.as_tensor(
        np.asarray(jt.alive)), ttest, reference_points=ttrain.seed_points,
        device="cpu", **kw)
    return dict(jtrain=jtrain, ttrain=ttrain, jtest=jtest, ttest=ttest,
                jh=jh, th=th, jm=jm, tm=tm)


def test_parsed_capture_matches_jax(slice_run):
    jtrain, ttrain = slice_run["jtrain"], slice_run["ttrain"]
    assert len(ttrain) == len(jtrain) == 4
    assert slice_run["ttest"].protocols == slice_run["jtest"].protocols == [
        "within", "within", "with", "with"]
    assert ttrain.seed_points.shape == (N_SEEDS, 3)
    np.testing.assert_array_equal(ttrain.seed_points, jtrain.seed_points)
    np.testing.assert_array_equal(ttrain.seed_colors, jtrain.seed_colors)
    _, tb = ttrain.get(0)
    _, jb = jtrain.get(0)
    assert sorted(tb) == sorted(jb) == ["confidence", "image", "normal",
                                        "sensor_depth"]
    assert (tb["sensor_depth"] > 0).mean() > 0.2  # the scene fills the view


def test_training_on_the_parsed_capture_matches_jax(slice_run):
    jl = [h["loss"] for h in slice_run["jh"]]
    tl = [h["loss"] for h in slice_run["th"]]
    assert len(tl) == STEPS and all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert [h["n_gaussians"] for h in slice_run["th"]] == [
        h["n_gaussians"] for h in slice_run["jh"]]


def test_evaluation_of_the_parsed_capture_matches_jax(slice_run):
    jm, tm = slice_run["jm"], slice_run["tm"]
    assert set(tm) == set(jm)
    assert tm["lpips_kind"] == jm["lpips_kind"] == "random-vgg(relative-only)"
    assert tm["within_num_images"] == tm["with_num_images"] == 2
    for k in ("pd_accuracy", "pd_completeness", "pd_icp_rmse",
              "within_rgb_lpips", "with_rgb_lpips", "depth_abs_rel"):
        assert np.isfinite(tm[k]), k
    for k, v in jm.items():
        if k == "lpips_kind" or any(t in k for t in ("fps", "num_rays")):
            continue
        if k.endswith("_std"):
            np.testing.assert_allclose(tm[k], v, rtol=1e-3,
                                       atol=1e-4 * abs(jm[k[:-4]]),
                                       err_msg=k)
        else:
            np.testing.assert_allclose(tm[k], v, rtol=1e-4, err_msg=k)
