"""dnsplatter_torch's loss stack against the JAX package: every loss of
models/losses.py, both regularization strategies with the AGS gates, and
`compute_loss`, on the same numpy inputs, values at rtol 1e-5 and gradients
(torch.autograd against jax.grad) at rtol 1e-4 of each array's largest
magnitude."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnsplatter_torch.models import dn_model as tdn
from dnsplatter_torch.models import losses as TL
from dnsplatter_torch.models import regularization as treg
from dnsplatter_torch.models.gaussians import params_from_numpy
from dnsplatter_torch.ops.camera import Camera as TCamera
from dnsplatter_tpu.models import dn_model as jdn
from dnsplatter_tpu.models import losses as JL
from dnsplatter_tpu.models import regularization as jreg
from dnsplatter_tpu.models.gaussians import GaussianParams as JParams
from dnsplatter_tpu.ops.camera import Camera as JCamera

# one process per core already: no intra-op threads on top
torch.set_num_threads(1)
H, W = 32, 40
VAL_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _data(seed=42):
    rng = np.random.default_rng(seed)
    d = {}
    d["pred"] = rng.uniform(0.5, 3.0, (H, W, 1)).astype(np.float32)
    d["gt"] = rng.uniform(0.5, 3.0, (H, W, 1)).astype(np.float32)
    hole = rng.uniform(size=(H, W, 1)) < 0.4
    d["gt_sparse"] = np.where(hole, 0.0, d["gt"]).astype(np.float32)
    d["rgb"] = rng.uniform(size=(H, W, 3)).astype(np.float32)
    d["rgb2"] = np.clip(d["rgb"] + rng.normal(0, 0.1, (H, W, 3)), 0,
                        1).astype(np.float32)
    d["conf"] = (rng.uniform(size=(H, W, 1)) > 0.3).astype(np.float32)
    gtn = rng.normal(size=(H, W, 3)).astype(np.float32)
    gtn /= np.linalg.norm(gtn, axis=-1, keepdims=True)
    predn = gtn + rng.normal(0, 0.05, gtn.shape).astype(np.float32)
    predn /= np.linalg.norm(predn, axis=-1, keepdims=True)
    d["gtn"], d["predn"] = gtn, predn.astype(np.float32)
    d["scales"] = np.log(rng.uniform(0.01, 0.1, (64, 3))).astype(np.float32)
    d["opac"] = rng.normal(0, 2.0, 64).astype(np.float32)
    d["alive"] = (rng.uniform(size=64) > 0.2).astype(np.float32)
    return d


D = _data()
MASK = D["gt"] > 1.0

# name -> (JAX fn, torch fn, differentiated input, other inputs)
CASES = {
    "mse": (JL.mse_loss, TL.mse_loss, "pred", ("gt",)),
    "mse_masked": (lambda p, g: JL.mse_loss(p, g, jnp.asarray(MASK)),
                   lambda p, g: TL.mse_loss(p, g, torch.as_tensor(MASK)),
                   "pred", ("gt",)),
    "l1": (JL.l1_loss, TL.l1_loss, "pred", ("gt",)),
    "log_l1": (JL.log_l1_loss, TL.log_l1_loss, "pred", ("gt",)),
    "edge_aware_log_l1": (JL.edge_aware_log_l1_loss,
                          TL.edge_aware_log_l1_loss, "pred", ("gt", "rgb")),
    "edge_aware_log_l1_masked": (
        lambda p, g, r: JL.edge_aware_log_l1_loss(p, g, r, jnp.asarray(MASK)),
        lambda p, g, r: TL.edge_aware_log_l1_loss(p, g, r,
                                                  torch.as_tensor(MASK)),
        "pred", ("gt", "rgb")),
    "huber_l1": (JL.huber_l1_loss, TL.huber_l1_loss, "pred", ("gt_sparse",)),
    "tv": (JL.tv_loss, TL.tv_loss, "pred", ()),
    "edge_aware_tv": (JL.edge_aware_tv_loss, TL.edge_aware_tv_loss, "pred",
                      ("rgb",)),
    "pearson": (JL.pearson_depth_loss, TL.pearson_depth_loss, "pred",
                ("gt",)),
    "ssim": (JL.ssim, TL.ssim, "rgb", ("rgb2",)),
    "rgb_main": (JL.rgb_main_loss, TL.rgb_main_loss, "rgb", ("rgb2",)),
    "dssim_l1_per_pixel": (
        lambda a, b: jnp.sum(JL.dssim_l1_per_pixel(a, b) ** 2),
        lambda a, b: torch.sum(TL.dssim_l1_per_pixel(a, b) ** 2),
        "rgb", ("rgb2",)),
    "normal_l1": (JL.normal_l1_loss, TL.normal_l1_loss, "predn", ("gtn",)),
    "normal_tv": (JL.normal_tv_loss, TL.normal_tv_loss, "predn", ()),
    "normal_cosine": (JL.normal_cosine_loss, TL.normal_cosine_loss, "predn",
                      ("gtn",)),
    "adaptive_normal_14999": (
        lambda p, g: JL.adaptive_normal_loss(p, g, step=14999),
        lambda p, g: TL.adaptive_normal_loss(p, g, step=14999),
        "predn", ("gtn",)),
    "adaptive_normal_15000": (
        lambda p, g: JL.adaptive_normal_loss(p, g, step=15000),
        lambda p, g: TL.adaptive_normal_loss(p, g, step=15000),
        "predn", ("gtn",)),
    "adaptive_depth_6999": (
        lambda p, g, r, c: JL.adaptive_depth_loss(p, g, r, g > 0, c, 6999),
        lambda p, g, r, c: TL.adaptive_depth_loss(p, g, r, g > 0, c, 6999),
        "pred", ("gt", "rgb", "conf")),
    "adaptive_depth_7000": (
        lambda p, g, r, c: JL.adaptive_depth_loss(p, g, r, g > 0, c, 7000),
        lambda p, g, r, c: TL.adaptive_depth_loss(p, g, r, g > 0, c, 7000),
        "pred", ("gt", "rgb", "conf")),
    "scale_flatten": (JL.scale_flatten_loss, TL.scale_flatten_loss, "scales",
                      ("alive",)),
    "physgauss_scale_reg": (
        lambda s, a: JL.physgauss_scale_reg(s, a, 3.0),
        lambda s, a: TL.physgauss_scale_reg(s, a, 3.0), "scales", ("alive",)),
    "sparse_opacity": (JL.sparse_opacity_loss, TL.sparse_opacity_loss, "opac",
                       ("alive",)),
}


def _both(jfn, tfn, x, others):
    """(value, gradient wrt x) from each side."""
    jv, jg = jax.value_and_grad(lambda v: jfn(v, *map(jnp.asarray, others)))(
        jnp.asarray(x))
    xt = torch.as_tensor(x).clone().requires_grad_(True)
    tv = tfn(xt, *map(torch.as_tensor, others))
    (tg,) = torch.autograd.grad(tv, xt)
    return float(jv), np.asarray(jg), float(tv.detach()), tg.numpy()


def _assert_close(jv, jg, tv, tg, name=""):
    np.testing.assert_allclose(tv, jv, rtol=VAL_RTOL, atol=1e-7, err_msg=name)
    scale = max(np.abs(jg).max(), 1e-12)
    np.testing.assert_allclose(tg / scale, jg / scale, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL, err_msg=name)
    assert np.isfinite(tg).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(name):
    jfn, tfn, arg, others = CASES[name]
    _assert_close(*_both(jfn, tfn, D[arg], [D[k] for k in others]), name)


def test_local_pearson_with_the_jax_draws():
    """The box corners the JAX function draws from its key, handed to the
    port as an argument."""
    rng = np.random.default_rng(3)
    pred = rng.uniform(0.5, 3.0, (160, 192)).astype(np.float32)
    gt = (pred * 1.7 + 0.3 + rng.normal(0, 0.8, pred.shape)).astype(
        np.float32)
    key = jax.random.PRNGKey(7)
    box, n_corr = TL.local_pearson_boxes(160, 192, 64, 0.5)
    assert (box, n_corr) == (64, 3)
    kx, ky = jax.random.split(key)
    corners = (np.asarray(jax.random.randint(kx, (n_corr,), 0, 160 - 64)),
               np.asarray(jax.random.randint(ky, (n_corr,), 0, 192 - 64)))
    _assert_close(*_both(
        lambda p, g: JL.local_pearson_depth_loss(p, g, key, box_p=64),
        lambda p, g: TL.local_pearson_depth_loss(p, g, corners=corners,
                                                 box_p=64),
        pred, [gt]))
    # drawn from a generator: the right number of boxes, a finite loss
    v = TL.local_pearson_depth_loss(
        torch.as_tensor(pred), torch.as_tensor(gt),
        generator=torch.Generator().manual_seed(0), box_p=64)
    assert np.isfinite(float(v))
    with pytest.raises(ValueError, match="corners"):
        TL.local_pearson_depth_loss(torch.as_tensor(pred),
                                    torch.as_tensor(gt),
                                    corners=(corners[0][:1], corners[1][:1]),
                                    box_p=64)


def test_find_edges_and_dilate_match_jax():
    n = D["gtn"]
    np.testing.assert_array_equal(
        treg.find_edges(torch.as_tensor(n)).numpy(),
        np.asarray(jreg.find_edges(jnp.asarray(n))))
    e = (D["conf"] > 0).astype(np.float32)
    np.testing.assert_allclose(
        treg.dilate_edge(torch.as_tensor(e), 2).numpy(),
        np.asarray(jreg.dilate_edge(jnp.asarray(e), 2)), atol=1e-6)


@pytest.mark.parametrize("depth_loss_type", [
    "edge_aware_log_l1", "mse", "l1", "log_l1", "huber_l1", "pearson"])
def test_dn_regularization_matches_jax(depth_loss_type):
    """The DN strategy with each depth loss, TV and cosine normal terms on;
    gradients wrt the rendered depth and normal."""
    kw = dict(depth_loss_type=depth_loss_type, depth_lambda=0.5,
              use_normal_cosine_loss=True)
    jcfg = jreg.RegularizationConfig(**kw)
    tcfg = treg.RegularizationConfig(**kw)
    key = jax.random.PRNGKey(3)
    box, n_corr = TL.local_pearson_boxes(H, W)
    kx, ky = jax.random.split(key)
    corners = (
        np.asarray(jax.random.randint(kx, (n_corr,), 0, max(1, H - box))),
        np.asarray(jax.random.randint(ky, (n_corr,), 0, max(1, W - box))))
    pn01 = (D["predn"] + 1.0) * 0.5
    gn01 = (D["gtn"] + 1.0) * 0.5

    def jfn(pd, pn):
        return jreg.dn_regularization_loss(
            jcfg, pred_depth=pd, gt_depth=jnp.asarray(D["gt_sparse"]),
            pred_normal=pn, gt_normal=jnp.asarray(gn01),
            scales=jnp.asarray(D["scales"]), gt_img=jnp.asarray(D["rgb"]),
            alive=jnp.asarray(D["alive"]), key=key)

    jv, (jgd, jgn) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(D["pred"]), jnp.asarray(pn01))
    pd = torch.as_tensor(D["pred"]).clone().requires_grad_(True)
    pn = torch.as_tensor(pn01).clone().requires_grad_(True)
    tv = treg.dn_regularization_loss(
        tcfg, pred_depth=pd, gt_depth=torch.as_tensor(D["gt_sparse"]),
        pred_normal=pn, gt_normal=torch.as_tensor(gn01),
        scales=torch.as_tensor(D["scales"]), gt_img=torch.as_tensor(D["rgb"]),
        alive=torch.as_tensor(D["alive"]), pearson_corners=corners)
    tgd, tgn = torch.autograd.grad(tv, (pd, pn))
    _assert_close(float(jv), np.asarray(jgd), float(tv), tgd.numpy(), "depth")
    _assert_close(float(jv), np.asarray(jgn), float(tv), tgn.numpy(), "normal")


@pytest.mark.parametrize("step", [6999, 7000, 7001, 14999, 15000])
def test_ags_regularization_matches_jax_across_the_gates(step):
    """The AGS strategy on both sides of its 7k and 15k gates; gradients
    wrt the rendered depth and the predicted normal."""
    jcfg = jreg.RegularizationConfig(depth_lambda=0.2, normal_lambda=0.1)
    tcfg = treg.RegularizationConfig(depth_lambda=0.2, normal_lambda=0.1)
    rng = np.random.default_rng(5)
    surf = D["gtn"] + rng.normal(0, 0.05, D["gtn"].shape).astype(np.float32)
    surf /= np.linalg.norm(surf, axis=-1, keepdims=True)

    def jfn(pd, pn):
        return jreg.ags_regularization_loss(
            jcfg, step=jnp.asarray(step), pred_depth=pd,
            gt_depth=jnp.asarray(D["gt"]), confidence=jnp.asarray(D["conf"]),
            surf_normal=jnp.asarray(surf), gt_normal=jnp.asarray(D["gtn"]),
            pred_normal=pn, scales=jnp.asarray(D["scales"]),
            gt_img=jnp.asarray(D["rgb"]))

    jv, (jgd, jgn) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(D["pred"]), jnp.asarray(D["predn"]))
    pd = torch.as_tensor(D["pred"]).clone().requires_grad_(True)
    pn = torch.as_tensor(D["predn"]).clone().requires_grad_(True)
    tv = treg.ags_regularization_loss(
        tcfg, step=step, pred_depth=pd, gt_depth=torch.as_tensor(D["gt"]),
        confidence=torch.as_tensor(D["conf"]),
        surf_normal=torch.as_tensor(surf), gt_normal=torch.as_tensor(D["gtn"]),
        pred_normal=pn, scales=torch.as_tensor(D["scales"]),
        gt_img=torch.as_tensor(D["rgb"]))
    tgd, tgn = torch.autograd.grad(tv, (pd, pn), allow_unused=True)
    _assert_close(float(jv), np.asarray(jgd), float(tv), tgd.numpy(), "depth")
    tgn = np.zeros_like(D["predn"]) if tgn is None else tgn.numpy()
    _assert_close(float(jv), np.asarray(jgn), float(tv), tgn, "normal")


def _loss_inputs(seed=9, n=48):
    rng = np.random.default_rng(seed)
    outputs = {
        "rgb": rng.uniform(size=(H, W, 3)).astype(np.float32),
        "depth": rng.uniform(0.5, 3.0, (H, W, 1)).astype(np.float32),
        "normal": rng.uniform(0.1, 0.9, (H, W, 3)).astype(np.float32),
        "surface_normal": rng.uniform(0.1, 0.9, (H, W, 3)).astype(np.float32),
        "accumulation": rng.uniform(size=(H, W, 1)).astype(np.float32),
        "background": np.zeros(3, np.float32),
    }
    batch = {
        "image": rng.uniform(size=(H, W, 3)).astype(np.float32),
        "sensor_depth": np.where(rng.uniform(size=(H, W, 1)) < 0.2, 0.0,
                                 rng.uniform(0.5, 3.0, (H, W, 1))).astype(
                                     np.float32),
        "normal": rng.uniform(size=(H, W, 3)).astype(np.float32),
        "confidence": (rng.uniform(size=(H, W, 1)) * 255).astype(np.float32),
        "mask": (rng.uniform(size=(H, W, 1)) > 0.1).astype(np.float32),
    }
    params = {
        "means": rng.normal(size=(n, 3)), "quats": rng.normal(size=(n, 4)),
        "scales": np.log(rng.uniform(0.01, 0.3, (n, 3))),
        "features_dc": rng.normal(size=(n, 3)),
        "features_rest": rng.normal(size=(n, 3, 3)),
        "opacities": rng.normal(0, 2, n), "normals": rng.normal(size=(n, 3)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    alive = (rng.uniform(size=n) > 0.2).astype(np.float32)
    return outputs, batch, params, alive


COMPUTE_LOSS_CASES = {
    "dn": (dict(use_depth_loss=True, depth_lambda=0.2), 40),
    "dn_every_term": (dict(
        use_depth_loss=True, depth_lambda=0.2, use_normal_cosine_loss=True,
        use_scale_regularization=True, max_gauss_ratio=3.0,
        use_depth_smooth_loss=True, smooth_loss_type="edge_aware_tv",
        use_sparse_loss=True), 40),
    "dn_normals_from_depth": (dict(use_depth_loss=True, depth_lambda=0.2,
                                   normal_supervision="depth"), 41),
    "ags_before_gates": (dict(regularization_strategy="ags-mesh",
                              use_depth_loss=True, depth_lambda=0.2), 100),
    "ags_after_7000": (dict(regularization_strategy="ags-mesh",
                            use_depth_loss=True, depth_lambda=0.2), 7001),
    "ags_after_15000": (dict(regularization_strategy="ags-mesh",
                             use_depth_loss=True, depth_lambda=0.2), 15000),
}


@pytest.mark.parametrize("name", sorted(COMPUTE_LOSS_CASES))
def test_compute_loss_matches_jax(name):
    """`compute_loss` under both strategies: the total, every entry of the
    loss dict, and the gradients wrt the rendered rgb, depth and normal
    and wrt the scales and opacities."""
    model_kw, step = COMPUTE_LOSS_CASES[name]
    outputs, batch, params, alive = _loss_inputs()
    c2w = np.eye(4, dtype=np.float32)
    jcam = JCamera.create(50.0, 50.0, W / 2, H / 2, jnp.asarray(c2w), W, H)
    tcam = TCamera.create(50.0, 50.0, W / 2, H / 2, c2w, W, H, device="cpu")
    jcfg = jdn.ModelConfig(**model_kw)
    tcfg = tdn.ModelConfig(**model_kw)
    diff = ("rgb", "depth", "normal")

    def jfn(rgb, depth, normal, scales, opac):
        out = dict({k: jnp.asarray(v) for k, v in outputs.items()},
                   rgb=rgb, depth=depth, normal=normal)
        p = JParams(**dict({k: jnp.asarray(v) for k, v in params.items()},
                           scales=scales, opacities=opac))
        return jdn.compute_loss(
            out, {k: jnp.asarray(v) for k, v in batch.items()}, p,
            jnp.asarray(alive), jcam, jcfg, jnp.asarray(step),
            jax.random.PRNGKey(0))

    (jv, jld), jgrads = jax.value_and_grad(
        jfn, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(outputs[k]) for k in diff),
        jnp.asarray(params["scales"]), jnp.asarray(params["opacities"]))

    leaves = [torch.as_tensor(outputs[k]).clone().requires_grad_(True)
              for k in diff]
    tp = params_from_numpy(params, device="cpu")
    scales = tp.scales.clone().requires_grad_(True)
    opac = tp.opacities.clone().requires_grad_(True)
    tp = dataclasses.replace(tp, scales=scales, opacities=opac)
    out = dict({k: torch.as_tensor(v) for k, v in outputs.items()},
               **dict(zip(diff, leaves)))
    tv, tld = tdn.compute_loss(
        out, {k: torch.as_tensor(v) for k, v in batch.items()}, tp,
        torch.as_tensor(alive), tcam, tcfg, step)
    tgrads = torch.autograd.grad(tv, leaves + [scales, opac],
                                 allow_unused=True)
    assert set(tld) == set(jld)
    for k in jld:
        np.testing.assert_allclose(float(tld[k]), float(jld[k]),
                                   rtol=VAL_RTOL, atol=1e-7, err_msg=k)
    for nm, jg, tg in zip(diff + ("scales", "opacities"), jgrads, tgrads):
        tg = np.zeros_like(np.asarray(jg)) if tg is None else tg.numpy()
        _assert_close(float(jv), np.asarray(jg), float(tv), tg, nm)


@pytest.mark.parametrize("step,expect_snap", [(100, False), (6300, True),
                                              (6100, False)])
def test_apply_binary_opacities_matches_jax(step, expect_snap):
    """Snapping runs after the warm-up and outside the 200 steps that
    follow each opacity reset; dead slots keep their logits."""
    _, _, params, alive = _loss_inputs()
    kw = dict(use_binary_opacities=True, warmup_length=500, refine_every=100,
              reset_alpha_every=30)
    jp = JParams(**{k: jnp.asarray(v) for k, v in params.items()})
    want = np.asarray(jdn.apply_binary_opacities(
        jp, jnp.asarray(alive), jdn.ModelConfig(**kw),
        jnp.asarray(step)).opacities)
    got = tdn.apply_binary_opacities(
        params_from_numpy(params, device="cpu"), torch.as_tensor(alive),
        tdn.ModelConfig(**kw), step).opacities.numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.abs(got[alive > 0.5]) == 15.0).all() == expect_snap
    off = tdn.apply_binary_opacities(
        params_from_numpy(params, device="cpu"), torch.as_tensor(alive),
        tdn.ModelConfig(), 6300).opacities.numpy()
    np.testing.assert_array_equal(off, params["opacities"])
