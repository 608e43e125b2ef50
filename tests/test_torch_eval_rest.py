"""The rest of dnsplatter_torch's evaluation against the JAX package's:
LPIPS (the seeded random VGG and an HWIO npz), point-cloud accuracy and
completeness, ICP, the offline evaluators, protocol aggregation, and
`evaluate` with point-cloud extraction, ICP and MuSHRoom protocol labels.

Tolerances: LPIPS rel 1e-5 (float32 convolutions in another summation
order); the random weights, pd_metrics on the same points, ICP on the same
points and the aggregation exactly (the same numpy and scipy code); the
metrics of `evaluate` rel 1e-4 as in test_torch_eval.py, the ICP rmse and
the point-cloud metrics among them, since the two packages' renders, and so
the clouds backprojected from them, differ at float32 rounding.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnsplatter_torch.data.synthetic import render_batches
from dnsplatter_torch.eval import icp as ticp
from dnsplatter_torch.eval import metrics as tM
from dnsplatter_torch.eval import offline as toff
from dnsplatter_torch.eval.evaluator import evaluate as t_evaluate
from dnsplatter_torch.ops.camera import Camera as TCamera
from dnsplatter_torch.ops.rasterize import RasterizeConfig as TRasterConfig
from dnsplatter_torch.train.trainer import load_checkpoint_arrays as t_load
from dnsplatter_tpu.data import io as jio
from dnsplatter_tpu.eval import icp as jicp
from dnsplatter_tpu.eval import metrics as jM
from dnsplatter_tpu.eval import offline as joff
from dnsplatter_tpu.eval.evaluator import evaluate as j_evaluate
from dnsplatter_tpu.ops.camera import Camera as JCamera
from dnsplatter_tpu.ops.camera import look_at
from dnsplatter_tpu.train.trainer import load_checkpoint_arrays as j_load

torch.set_num_threads(1)
W, H = 96, 72
CAPACITY = 1 << 14
LPIPS_RTOL = 1e-5
EVAL_RTOL = 1e-4


def _pair(rng, h=48, w=64):
    gt = rng.uniform(size=(h, w, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0.0, 0.08, gt.shape), 0, 1).astype(
        np.float32)
    return pred, gt


# -- LPIPS -------------------------------------------------------------------


def test_random_vgg_weights_bit_equal_to_jax():
    tp = tM.random_vgg_lpips_params()
    jp = jM.random_vgg_lpips_params()
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tp[k].dtype == np.float32, k
        np.testing.assert_array_equal(tp[k], np.asarray(jp[k]), err_msg=k)
    assert tp["conv0_w"].shape == (3, 3, 3, 64)  # HWIO
    assert len([k for k in tp if k.startswith("conv") and k.endswith("_w")
                ]) == 13


def test_default_lpips_matches_jax():
    """No weights file on the search paths: both packages fall back to the
    random VGG, with the same kind and the same values."""
    assert tM.default_lpips_kind() == jM.default_lpips_kind() == (
        "random-vgg(relative-only)")
    rng = np.random.default_rng(0)
    for h, w in ((48, 64), (72, 96), (16, 16)):
        pred, gt = _pair(rng, h, w)
        got = float(tM.default_lpips()(torch.as_tensor(pred),
                                       torch.as_tensor(gt)))
        want = float(jM.default_lpips()(jnp.asarray(pred), jnp.asarray(gt)))
        assert got > 0.0
        np.testing.assert_allclose(got, want, rtol=LPIPS_RTOL)
    same = float(tM.default_lpips()(torch.as_tensor(gt), torch.as_tensor(gt)))
    assert same == 0.0
    m = tM.rgb_metrics(torch.as_tensor(pred), torch.as_tensor(gt))
    np.testing.assert_allclose(m["lpips"], got, rtol=1e-6)


def test_lpips_from_npz_matches_jax(tmp_path, monkeypatch):
    """Weights in the JAX package's HWIO layout, with non-uniform heads."""
    rng = np.random.default_rng(1)
    params = jM.random_vgg_lpips_params(seed=5)
    arrays = {k: np.asarray(v) for k, v in params.items()}
    for k in arrays:
        if k.startswith("lin"):
            arrays[k] = rng.uniform(0.0, 0.1, arrays[k].shape).astype(
                np.float32)
        elif k.endswith("_b"):
            arrays[k] = rng.normal(0.0, 0.05, arrays[k].shape).astype(
                np.float32)
    path = tmp_path / "lpips_vgg.npz"
    np.savez(path, **arrays)
    t_fn, j_fn = tM.lpips_from_npz(path), jM.lpips_from_npz(path)
    assert isinstance(t_fn, torch.nn.Module)
    for _ in range(2):
        pred, gt = _pair(rng)
        np.testing.assert_allclose(
            float(t_fn(torch.as_tensor(pred), torch.as_tensor(gt))),
            float(j_fn(jnp.asarray(pred), jnp.asarray(gt))), rtol=LPIPS_RTOL)
    monkeypatch.setenv("DNSPLATTER_LPIPS_WEIGHTS", str(path))
    paths = tM.lpips_weight_search_paths()
    assert paths[0] == path and paths[-1].parts[-2:] == (
        "dnsplatter_torch", "lpips_vgg.npz")
    assert paths[1].parent.name == "weights"


# -- point clouds and ICP ------------------------------------------------------


def _box_cloud(n=4000, seed=0):
    """A noisy box surface, so ICP has geometry to lock to."""
    rng = np.random.default_rng(seed)
    face = rng.integers(0, 6, n)
    uv = rng.uniform(-1, 1, (n, 2))
    pts = np.zeros((n, 3))
    for f in range(6):
        m = face == f
        axis, others = f // 2, [a for a in range(3) if a != f // 2]
        pts[m, axis] = 1.0 if f % 2 == 0 else -1.0
        pts[m, others[0]] = uv[m, 0]
        pts[m, others[1]] = uv[m, 1]
    return pts + rng.normal(0, 0.005, (n, 3))


def _se3(rx, ry, rz, t):
    c, s = np.cos, np.sin
    r = (np.array([[c(rz), -s(rz), 0], [s(rz), c(rz), 0], [0, 0, 1]])
         @ np.array([[c(ry), 0, s(ry)], [0, 1, 0], [-s(ry), 0, c(ry)]])
         @ np.array([[1, 0, 0], [0, c(rx), -s(rx)], [0, s(rx), c(rx)]]))
    m = np.eye(4)
    m[:3, :3] = r
    m[:3, 3] = t
    return m


@pytest.mark.parametrize("method", ["point_to_point", "point_to_plane"])
def test_icp_matches_jax(method):
    target = _box_cloud()
    normals = np.zeros_like(target)
    idx = np.abs(target).argmax(1)
    normals[np.arange(len(target)), idx] = np.sign(
        target[np.arange(len(target)), idx])
    gt = _se3(0.06, -0.04, 0.09, np.array([0.08, -0.05, 0.12]))
    source = ticp.transform_points(target, np.linalg.inv(gt))
    kw = dict(method=method, max_correspondence_distance=0.5,
              target_normals=normals if method == "point_to_plane" else None)
    t_est, t_rmse = ticp.icp(source, target, **kw)
    j_est, j_rmse = jicp.icp(source, target, **kw)
    np.testing.assert_array_equal(t_est, j_est)
    assert t_rmse == j_rmse
    err = np.abs(ticp.transform_points(source, t_est) - target).max()
    assert err < 0.03, err
    # subsampled clouds: the same seeded draws
    sub = dict(kw, max_points=1500, seed=4)
    np.testing.assert_array_equal(ticp.icp(source, target, **sub)[0],
                                  jicp.icp(source, target, **sub)[0])
    if method == "point_to_point":
        with pytest.raises(ValueError, match="target_normals"):
            ticp.icp(source, target, method="point_to_plane")


def test_icp_json_and_pd_metrics_match_jax(tmp_path):
    t = _se3(0.1, 0.2, 0.3, np.array([1.0, 2.0, 3.0]))
    ticp.save_icp_json(tmp_path / "sub" / "icp_iphone.json", t)
    np.testing.assert_allclose(
        jicp.load_icp_json(tmp_path / "sub" / "icp_iphone.json"), t)
    jicp.save_icp_json(tmp_path / "j.json", t)
    np.testing.assert_array_equal(ticp.load_icp_json(tmp_path / "j.json"),
                                  jicp.load_icp_json(tmp_path / "j.json"))
    rng = np.random.default_rng(2)
    gt = _box_cloud(3000, seed=1)
    pred = gt[rng.permutation(3000)[:2000]] + rng.normal(0, 0.03, (2000, 3))
    for thresh in (0.05, 0.02):
        got = tM.pd_metrics(pred, gt, thresh)
        assert got == jM.pd_metrics(pred, gt, thresh)
        assert 0.0 < got["completeness"] < 1.0 and got["accuracy"] > 0.0


# -- offline evaluation ------------------------------------------------------


def _render_tree(tmp: Path, n=3, noise=0.05):
    rng = np.random.default_rng(0)
    for sub in ("pred/rgb", "gt/rgb", "pred/depth", "gt/depth", "faro"):
        (tmp / sub).mkdir(parents=True)
    for i in range(n):
        gt = rng.uniform(size=(24, 32, 3))
        jio.write_image(tmp / f"gt/rgb/{i:05d}.png", gt)
        jio.write_image(tmp / f"pred/rgb/{i:05d}.png",
                        np.clip(gt + rng.normal(0, noise, gt.shape), 0, 1))
        d = rng.uniform(1, 3, (24, 32, 1)).astype(np.float32)
        np.save(tmp / f"gt/depth/{i:05d}.npy", d)
        np.save(tmp / f"pred/depth/{i:05d}.npy", d * 1.02)
        jio.write_depth_png(tmp / f"faro/{i:05d}.png", d * 0.98)


def _assert_aggregates_close(got, want):
    """Means rel EVAL_RTOL; a std (of float32 values that differ by ~1e-7)
    as test_torch_eval.py holds it: rel 1e-3 beside 1e-4 of its mean."""
    assert sorted(got) == sorted(want)
    for k in want:
        if k.endswith("_std"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                       atol=1e-4 * abs(want[k[:-4]]),
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=EVAL_RTOL,
                                       err_msg=k)


def test_offline_eval_matches_jax(tmp_path, capsys):
    _render_tree(tmp_path)
    r = tmp_path
    t_rgb = toff.rgb_eval(r / "pred/rgb", r / "gt/rgb", device="cpu")
    j_rgb = joff.rgb_eval(r / "pred/rgb", r / "gt/rgb")
    _assert_aggregates_close(t_rgb, j_rgb)
    assert t_rgb["num_images"] == 3
    assert 15 < t_rgb["psnr"] < 40 and t_rgb["lpips"] > 0
    for t_fn, j_fn, args in (
            (toff.depth_eval, joff.depth_eval,
             (r / "pred/depth", r / "gt/depth")),
            (toff.depth_eval_faro, joff.depth_eval_faro,
             (r / "pred/depth", r / "faro"))):
        _assert_aggregates_close(t_fn(*args, device="cpu"), j_fn(*args))
    assert abs(toff.depth_eval(r / "pred/depth", r / "gt/depth",
                               device="cpu")["abs_rel"] - 0.02) < 0.005
    assert toff.rgb_eval(r / "gt/rgb", r / "nowhere",
                         device="cpu") == {"num_images": 0}
    toff.main(["--renders", str(r), "--faro-depths", str(r / "faro"),
               "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["lpips_kind"] == "random-vgg(relative-only)"
    assert sorted(out) == ["depth", "faro_depth", "lpips_kind", "rgb"]
    np.testing.assert_allclose(out["rgb"]["psnr"], t_rgb["psnr"])


def test_protocol_aggregation_matches_jax():
    rng = np.random.default_rng(3)
    rows = [{"psnr": float(v), "ssim": float(s)}
            for v, s in zip(rng.uniform(20, 40, 5), rng.uniform(0, 1, 5))]
    labels = ["with", "within", "within", "with", "within"]
    got = toff.aggregate_protocols(rows, labels)
    assert got == joff.aggregate_protocols(rows, labels)
    agg = toff.aggregate_protocols(
        [{"psnr": 20.0}, {"psnr": 30.0}, {"psnr": 40.0}],
        ["with", "within", "within"])
    assert (agg["with_psnr"], agg["within_psnr"], agg["psnr"]) == (
        20.0, 35.0, 30.0)
    assert agg["within_num_images"] == 2 and agg["num_images"] == 3


# -- evaluate: point clouds, ICP, protocols ----------------------------------


class _Data:
    def __init__(self, cams, batches, protocols=None):
        self.cams, self.batches, self.protocols = cams, batches, protocols

    def __len__(self):
        return len(self.cams)

    def get(self, i):
        return self.cams[i], self.batches[i]


def _fields(rng, n=500):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return {
        "means": rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32),
        "scales": rng.uniform(-3.6, -2.6, (n, 3)).astype(np.float32),
        "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
        "features_dc": rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32),
        "features_rest": rng.normal(0.0, 0.3, (n, 15, 3)).astype(np.float32),
        "opacities": rng.uniform(1.0, 3.0, n).astype(np.float32),
        "normals": np.zeros((n, 3), np.float32),
    }


def _ckpt(path, fields):
    np.savez(path, alive=np.ones(len(fields["means"]), np.float32),
             step=np.asarray(7), **{f"params.{k}": v
                                    for k, v in fields.items()})


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pcd")
    rng = np.random.default_rng(0)
    gt = _fields(rng)
    c2ws = [np.array(look_at((3.0 * np.cos(a), 0.8, 3.0 * np.sin(a)),
                             (0.0, 0.0, 0.0)))
            for a in np.linspace(0, 2 * np.pi, 4, endpoint=False)]
    _ckpt(tmp / "gt.npz", gt)
    gt_params, gt_alive, _ = t_load(tmp / "gt.npz", device="cpu")
    t_cams = [TCamera.create(80.0, 80.0, W / 2, H / 2, m, W, H, device="cpu")
              for m in c2ws]
    batches = render_batches(
        gt_params, gt_alive, t_cams,
        lambda cam: TRasterConfig(width=W, height=H, chunk=32, tile_block=4,
                                  pair_capacity=CAPACITY), sh_degree=3)
    pert = {k: v.copy() for k, v in gt.items()}
    pert["means"] += rng.normal(0.0, 0.01, pert["means"].shape).astype(
        np.float32)
    pert["features_dc"] += 0.05
    _ckpt(tmp / "ckpt.npz", pert)
    j_cams = [JCamera.create(80.0, 80.0, W / 2, H / 2, m, W, H)
              for m in c2ws]
    labels = ["within", "with", "within"]
    # the reference cloud: the ground truth's centres, displaced by a known
    # SE(3), so that ICP has a transform to find
    reg = _se3(0.02, -0.03, 0.01, np.array([0.05, -0.02, 0.03]))
    ref = ticp.transform_points(gt["means"].astype(np.float64), reg)
    kw = dict(pair_capacity=CAPACITY, extract_pointcloud=True,
              reference_points=ref, run_icp_if_missing=True, pcd_stride=3)
    jp, ja, _ = j_load(tmp / "ckpt.npz")
    tp, ta, _ = t_load(tmp / "ckpt.npz", device="cpu")
    jm = j_evaluate(jp, ja, _Data(j_cams[:3], batches[:3], labels),
                    pcd_train_data=_Data(j_cams[3:], batches[3:]), **kw)
    tm = t_evaluate(tp, ta, _Data(t_cams[:3], batches[:3], labels),
                    pcd_train_data=_Data(t_cams[3:], batches[3:]),
                    device="cpu", **kw)
    return dict(jm=jm, tm=tm, tp=tp, ta=ta, t_cams=t_cams, batches=batches,
                labels=labels, ref=ref, reg=reg, kw=kw, tmp=tmp)


def test_evaluate_pointcloud_and_protocols_match_jax(served):
    jm, tm = served["jm"], served["tm"]
    assert set(tm) == set(jm)
    assert tm["lpips_kind"] == jm["lpips_kind"] == "random-vgg(relative-only)"
    for prefix in ("within_", "with_", ""):
        assert f"{prefix}rgb_psnr" in tm and f"{prefix}rgb_lpips" in tm
    assert tm["within_num_images"] == 2 and tm["with_num_images"] == 1
    assert tm["num_images"] == 3
    # everything but the timings
    kept = {k for k in jm if k != "lpips_kind"
            and not any(t in k for t in ("fps", "num_rays"))}
    for k in kept:
        assert np.isfinite(tm[k]), k
    _assert_aggregates_close(
        {k: v for k, v in tm.items() if k in kept},
        {k: v for k, v in jm.items() if k in kept})
    for k in ("pd_accuracy", "pd_completeness", "pd_icp_rmse"):
        assert np.isfinite(tm[k]) and tm[k] >= 0.0, k
    # the registration undid most of the displacement
    assert tm["pd_completeness"] > 0.5, tm["pd_completeness"]


def test_evaluate_icp_from_argument_and_json(served):
    """The transform from `icp_transform`, then from an icp json: no ICP
    runs, so no pd_icp_rmse; the same pd metrics either way, and the JAX
    evaluator's on the same transform."""
    kw = dict(served["kw"], run_icp_if_missing=False)
    data = _Data(served["t_cams"][:3], served["batches"][:3])
    reg = served["reg"]
    by_arg = t_evaluate(served["tp"], served["ta"], data, icp_transform=reg,
                        lpips_fn=lambda a, b: 0.0, device="cpu", **kw)
    path = served["tmp"] / "icp_iphone.json"
    ticp.save_icp_json(path, reg)
    by_json = t_evaluate(served["tp"], served["ta"], data, icp_json=path,
                         lpips_fn=lambda a, b: 0.0, device="cpu", **kw)
    assert "pd_icp_rmse" not in by_arg and "lpips_kind" not in by_arg
    for k in ("pd_accuracy", "pd_completeness"):
        assert by_arg[k] == by_json[k], k
    none = t_evaluate(served["tp"], served["ta"], data,
                      lpips_fn=lambda a, b: 0.0, device="cpu", **kw)
    assert none["pd_accuracy"] > by_arg["pd_accuracy"]
    jp, ja, _ = j_load(served["tmp"] / "ckpt.npz")
    j_cams = [JCamera.create(float(c.fx), float(c.fy), float(c.cx),
                             float(c.cy), c.c2w.numpy(), c.width, c.height)
              for c in served["t_cams"][:3]]
    jm = j_evaluate(jp, ja, _Data(j_cams, served["batches"][:3]),
                    icp_transform=reg, lpips_fn=lambda a, b: 0.0, **kw)
    for k in ("pd_accuracy", "pd_completeness"):
        np.testing.assert_allclose(by_arg[k], jm[k], rtol=EVAL_RTOL,
                                   err_msg=k)
