"""The slice as a whole: a checkpoint in the JAX package's npz format,
served by both packages through load_checkpoint_arrays + evaluate, and
get_outputs against the JAX kernel path.

Tolerances: renders atol 1e-5 (float32 compositing in another summation
order). The saved expected depth is accumulated depth over alpha, so its
error is both errors over alpha: rtol 5e-5 beside atol 1e-5 there, since
the JAX evaluator composites on its XLA backend here, which multiplies
transmittances where the port adds their logarithms. Shared metrics rel
1e-4 (they reduce those renders); saved 8-bit PNGs within one level (a
value within 1e-5 of a quantization step may round either way).
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dnsplatter_torch
from dnsplatter_torch.data.synthetic import render_batches
from dnsplatter_torch.eval.evaluator import evaluate as t_evaluate
from dnsplatter_torch.models.dn_model import ModelConfig as TModelConfig
from dnsplatter_torch.models.dn_model import get_outputs as t_get_outputs
from dnsplatter_torch.ops.camera import Camera as TCamera
from dnsplatter_torch.ops.rasterize import RasterizeConfig as TRasterConfig
from dnsplatter_torch.train.trainer import (
    load_checkpoint_arrays as t_load,
)
from dnsplatter_tpu.eval.evaluator import evaluate as j_evaluate
from dnsplatter_tpu.models.dn_model import ModelConfig as JModelConfig
from dnsplatter_tpu.models.dn_model import get_outputs as j_get_outputs
from dnsplatter_tpu.ops.camera import Camera as JCamera
from dnsplatter_tpu.ops.camera import look_at
from dnsplatter_tpu.ops.normals import (
    surface_normal_output as j_surface_normal,
)
from dnsplatter_tpu.ops.rasterize import RasterizeConfig as JRasterConfig
from dnsplatter_tpu.train.trainer import load_checkpoint_arrays as j_load

W, H = 96, 72
CAPACITY = 1 << 14  # a multiple of both evaluators' chunk


def _gaussians(rng, n=500, degree=3):
    """The fields of make_gt_gaussians, plus real higher-order SH."""
    b = (degree + 1) ** 2
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return {
        "means": rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32),
        "scales": rng.uniform(-4.2, -2.8, (n, 3)).astype(np.float32),
        "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
        "features_dc": rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32),
        "features_rest": rng.normal(0.0, 0.3, (n, b - 1, 3)).astype(
            np.float32),
        "opacities": rng.uniform(1.0, 3.0, n).astype(np.float32),
        "normals": np.zeros((n, 3), np.float32),
    }


def _c2ws(num=3):
    out = []
    for i in range(num):
        ang = 2.0 * np.pi * i / num
        eye = (3.0 * np.cos(ang), 0.8, 3.0 * np.sin(ang))
        out.append(np.array(look_at(eye, (0.0, 0.0, 0.0))))
    return out


class _Data:
    def __init__(self, cams, batches):
        self.cams, self.batches = cams, batches

    def __len__(self):
        return len(self.cams)

    def get(self, i):
        return self.cams[i], self.batches[i]


def _write_ckpt(path, fields, n_dead=20):
    """JAX Trainer.save_checkpoint's keys; the last `n_dead` slots dead."""
    n = fields["means"].shape[0]
    alive = np.ones(n, np.float32)
    alive[-n_dead:] = 0.0
    flat = {f"params.{k}": v for k, v in fields.items()}
    np.savez_compressed(path, alive=alive, step=np.asarray(1234), **flat)


def _lpips_stub(pred, gt):
    return float(np.mean(np.abs(np.asarray(pred) - np.asarray(gt))))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(0)
    gt = _gaussians(rng)
    c2ws = _c2ws()
    t_cams = [TCamera.create(80.0, 80.0, W / 2, H / 2, m, W, H,
                             device="cpu") for m in c2ws]
    gt_params, _, _ = t_load_fields(gt, tmp)
    batches = render_batches(
        gt_params, torch.ones(gt["means"].shape[0]), t_cams,
        lambda cam: TRasterConfig(width=W, height=H, chunk=32, tile_block=4,
                                  pair_capacity=CAPACITY), sh_degree=3)
    # evaluate a perturbed copy, so every metric is finite and nontrivial
    pert = {k: v.copy() for k, v in gt.items()}
    pert["means"] += rng.normal(0.0, 0.01, pert["means"].shape).astype(
        np.float32)
    pert["features_dc"] += 0.05
    ckpt = tmp / "ckpt.npz"
    _write_ckpt(ckpt, pert)

    j_params, j_alive, j_step = j_load(ckpt)
    j_cams = [JCamera.create(80.0, 80.0, W / 2, H / 2, m, W, H)
              for m in c2ws]
    j_metrics = j_evaluate(j_params, j_alive, _Data(j_cams, batches),
                           pair_capacity=CAPACITY, lpips_fn=_lpips_stub,
                           output_dir=tmp / "jax", save_renders=True)
    t_params, t_alive, t_step = t_load(ckpt, device="cpu")
    t_metrics = t_evaluate(t_params, t_alive, _Data(t_cams, batches),
                           pair_capacity=CAPACITY, lpips_fn=_lpips_stub,
                           output_dir=tmp / "torch", save_renders=True,
                           device="cpu")
    return dict(tmp=tmp, j_metrics=j_metrics, t_metrics=t_metrics,
                steps=(j_step, t_step), ckpt=ckpt, c2ws=c2ws,
                n_images=len(c2ws))


def t_load_fields(fields, tmp):
    path = tmp / "gt.npz"
    _write_ckpt(path, fields, n_dead=0)
    return t_load(path, device="cpu")


def test_evaluate_metrics_match_jax(served):
    jm, tm = served["j_metrics"], served["t_metrics"]
    assert served["steps"] == (1234, 1234)
    shared = {k for k in jm if not k.startswith(("fps", "num_rays"))}
    assert shared <= set(tm)
    means = [k for k in shared if not k.endswith("_std")
             and isinstance(jm[k], float)]
    assert {"rgb_psnr", "rgb_ssim", "rgb_lpips", "depth_abs_rel",
            "normal_mae"} <= set(means)
    for k in means:
        assert np.isfinite(tm[k]), k
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(tm[f"{k}_std"], jm[f"{k}_std"],
                                   rtol=1e-3, atol=1e-4 * abs(jm[k]),
                                   err_msg=f"{k}_std")
    assert tm["num_images"] == jm["num_images"] == served["n_images"]
    assert "lpips_kind" not in tm  # an lpips_fn was given
    assert (served["tmp"] / "torch" / "metrics.json").exists()


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path)).astype(np.int16)


def test_saved_renders_match_jax(served):
    jd, td = served["tmp"] / "jax", served["tmp"] / "torch"
    for i in range(served["n_images"]):
        stem = f"{i:05d}"
        np.testing.assert_allclose(np.load(td / "pred/depth" / f"{stem}.npy"),
                                   np.load(jd / "pred/depth" / f"{stem}.npy"),
                                   rtol=5e-5, atol=1e-5)
        for sub in ("pred/rgb", "pred/normal", "gt/rgb", "gt/normal"):
            a = _png(td / sub / f"{stem}.png")
            b = _png(jd / sub / f"{stem}.png")
            assert a.shape == b.shape, sub
            diff = np.abs(a - b)
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, sub
        np.testing.assert_array_equal(
            np.load(td / "gt/depth" / f"{stem}.npy"),
            np.load(jd / "gt/depth" / f"{stem}.npy"))


def test_evaluate_without_lpips_reports_not_ported(served):
    """Without an `lpips_fn`, both evaluators score with their default
    LPIPS, the seeded random VGG where no weights file is found: the same
    finite `rgb_lpips` (rel 1e-5) and the same `lpips_kind`."""
    params, alive, _ = t_load(served["ckpt"], device="cpu")
    cam = TCamera.create(80.0, 80.0, W / 2, H / 2, served["c2ws"][0], W, H,
                         device="cpu")
    batch = {"image": np.full((H, W, 3), 0.3, np.float32)}
    m = t_evaluate(params, alive, _Data([cam], [batch]),
                   pair_capacity=CAPACITY, device="cpu")
    jp, ja, _ = j_load(served["ckpt"])
    jm = j_evaluate(jp, ja, _Data([JCamera.create(
        80.0, 80.0, W / 2, H / 2, served["c2ws"][0], W, H)], [batch]),
        pair_capacity=CAPACITY)
    assert np.isfinite(m["rgb_lpips"]) and m["rgb_lpips"] > 0.0
    np.testing.assert_allclose(m["rgb_lpips"], jm["rgb_lpips"], rtol=1e-5)
    assert m["lpips_kind"] == jm["lpips_kind"] == "random-vgg(relative-only)"
    assert np.isfinite(m["rgb_psnr"])


@pytest.mark.parametrize("mode", ["classic", "antialiased"])
def test_get_outputs_matches_jax_kernel_path(served, mode):
    """Against the JAX get_outputs on its pallas backend (interpreted), with
    a crop box and a non-black background."""
    jp, ja, _ = j_load(served["ckpt"])
    tp, ta, _ = t_load(served["ckpt"], device="cpu")
    m = served["c2ws"][1]
    lo, hi = np.array([-0.8, -1.0, -0.9], np.float32), np.ones(3, np.float32)
    bg = np.array([0.2, 0.5, 0.7], np.float32)
    jcfg = JRasterConfig(width=W, height=H, chunk=32, tile_block=4,
                         pair_capacity=CAPACITY, backend="pallas")
    j_out, _ = j_get_outputs(
        jp, ja, JCamera.create(80.0, 80.0, W / 2, H / 2, m, W, H),
        JModelConfig(rasterize_mode=mode), jcfg, sh_degree=3,
        background=jnp.asarray(bg), training=False,
        crop_box=(jnp.asarray(lo), jnp.asarray(hi)))
    with torch.no_grad():
        t_out, _ = t_get_outputs(
            tp, ta, TCamera.create(80.0, 80.0, W / 2, H / 2, m, W, H,
                                   device="cpu"),
            TModelConfig(rasterize_mode=mode),
            TRasterConfig(**jcfg._asdict()), sh_degree=3,
            background=torch.as_tensor(bg),
            crop_box=(torch.as_tensor(lo), torch.as_tensor(hi)))
    assert set(t_out) == set(j_out)
    got = {k: v.numpy() for k, v in t_out.items()}
    want = {k: np.asarray(v) for k, v in j_out.items()}
    for k in ("rgb", "normal", "accumulation", "background"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    # Expected depth divides the accumulated depth by alpha, which turns
    # 1e-6 absolute differences at alpha ~ 1e-3 into 1e-5 relative ones:
    # hold the accumulated depth at atol 1e-5, the quotient at rtol 5e-5.
    acc = got["accumulation"]
    np.testing.assert_allclose(got["depth"] * acc,
                               want["depth"] * want["accumulation"],
                               rtol=1e-5, atol=1e-5, err_msg="depth * alpha")
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=5e-5,
                               atol=1e-5, err_msg="depth")
    # surface_normal differentiates that depth (cross products of
    # neighbour differences), so it is held as a function of it: the JAX
    # head applied to the port's depth.
    np.testing.assert_allclose(
        got["surface_normal"],
        np.asarray(j_surface_normal(jnp.asarray(got["depth"]), 80.0, 80.0,
                                    W / 2, H / 2)),
        rtol=1e-5, atol=1e-5, err_msg="surface_normal")
    assert (acc > 0.5).mean() > 0.05 and (acc < 0.01).mean() > 0.05


def test_port_imports_no_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "before = set(sys.modules)\n"
        "import dnsplatter_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'dnsplatter_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dnsplatter_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 84, names\n"
        "print(len(names))\n"
    )
    root = Path(dnsplatter_torch.__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
