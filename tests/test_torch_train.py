"""dnsplatter_torch's training slice against the JAX package: the state
initialisation, the per-field Adam, the refinement transforms with shared
draws, one train step and a short loss trajectory, checkpoints carried
across the two packages, and the mirrors of the JAX package's training
smoke tests on the port with device="cpu"."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnsplatter_torch.data.synthetic import SyntheticScene
from dnsplatter_torch.models import dn_model as tdn
from dnsplatter_torch.models import gaussians as tg
from dnsplatter_torch.ops.camera import Camera as TCamera
from dnsplatter_torch.ops.rasterize import RasterizeConfig as TRasterizeConfig
from dnsplatter_torch.train import optim as topt
from dnsplatter_torch.train import strategy as tst
from dnsplatter_torch.train import trainer as ttr
from dnsplatter_tpu.data.synthetic import make_synthetic_scene
from dnsplatter_tpu.models import dn_model as jdn
from dnsplatter_tpu.models import gaussians as jg
from dnsplatter_tpu.train import optim as jopt
from dnsplatter_tpu.train import strategy as jst
from dnsplatter_tpu.train import trainer as jtr

FIELDS = tg.FIELDS
# The test run has one process per core already; intra-op threads on top
# of that only contend.
torch.set_num_threads(1)


def _jparams_np(p):
    return {f: np.asarray(getattr(p, f)) for f in FIELDS}


def _to_port_params(p):
    return tg.params_from_numpy(_jparams_np(p), device="cpu")


def _port_scene(jscene):
    cams = [TCamera.create(float(c.fx), float(c.fy), float(c.cx), float(c.cy),
                           np.asarray(c.c2w), c.width, c.height, device="cpu")
            for c in jscene.cameras]
    return SyntheticScene(cameras=cams, batches=jscene.batches,
                          gt_params=_to_port_params(jscene.gt_params),
                          gt_alive=torch.ones(jscene.gt_params.means.shape[0]))


@pytest.fixture(scope="module")
def scene():
    js = make_synthetic_scene(seed=0, n_gaussians=300, n_cameras=4, width=64,
                              height=48, pair_capacity=1 << 14)
    pts, cols = js.seed_points(jax.random.PRNGKey(1), noise=0.03)
    return js, _port_scene(js), pts, cols


MODEL_KW = dict(use_depth_loss=True, depth_lambda=0.2, use_normal_loss=True,
                normal_lambda=0.1, warmup_length=10_000, sh_degree=1,
                num_downscales=0)
TRAIN_KW = dict(pair_capacity=1 << 14, chunk=32, tile_block=4, seed=3,
                steps_per_eval_image=0)


def _port_trainer(scene, model_kw=None, train_kw=None, **kw):
    _, ts, pts, cols = scene
    return ttr.Trainer(
        ts, (pts, cols),
        model_cfg=tdn.ModelConfig(**dict(MODEL_KW, **(model_kw or {}))),
        train_cfg=ttr.TrainConfig(**dict(TRAIN_KW, **(train_kw or {}))),
        device="cpu", **kw)


def _jax_trainer(scene, model_kw=None, train_kw=None, **kw):
    js, _, pts, cols = scene
    return jtr.Trainer(
        js, (pts, cols),
        model_cfg=jdn.ModelConfig(**dict(MODEL_KW, **(model_kw or {}))),
        train_cfg=jtr.TrainConfig(**dict(TRAIN_KW, **(train_kw or {}))), **kw)


# -- state initialisation ---------------------------------------------------


def test_init_from_points_matches_jax():
    """With normals the init is deterministic (flattest axis onto the
    normal); without, the quaternions the JAX package drew are passed in.
    atol 1e-6: log of the 3-NN distances in float32 on both sides."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    cols = rng.uniform(size=(200, 3)).astype(np.float32)
    nrm = rng.normal(size=(200, 3)).astype(np.float32)
    nrm[0] = (0.0, 0.0, -1.0)  # antiparallel to the z axis
    np.testing.assert_allclose(tg.knn_mean_dist(pts), jg.knn_mean_dist(pts),
                               rtol=1e-6)
    for normals in (nrm, None):
        jp, jalive, jn = jg.init_from_points(jax.random.PRNGKey(0), pts, cols,
                                             normals, sh_degree=2,
                                             capacity=256)
        quats = None if normals is not None else np.asarray(jp.quats)[:200]
        tp, talive, tn = tg.init_from_points(
            np.random.default_rng(0), pts, cols, normals, sh_degree=2,
            capacity=256, device="cpu", quats=quats)
        assert tn == jn == 200 and tp.capacity == 256
        np.testing.assert_array_equal(talive.numpy(), np.asarray(jalive))
        for f in FIELDS:
            a, b = getattr(tp, f).numpy(), np.asarray(getattr(jp, f))
            if f == "quats" and normals is not None:
                sign = np.sign(np.sum(a * b, -1, keepdims=True))  # q ~ -q
                a = a * np.where(sign == 0, 1.0, sign)
            np.testing.assert_allclose(a, b, atol=2e-6, err_msg=f)
    # default capacity and the random fallback
    tp, talive, tn = tg.init_random(np.random.default_rng(1), num_points=500,
                                    extent=2.0, sh_degree=1, device="cpu")
    assert tp.capacity == 4096 and tn == 500 and int(talive.sum()) == 500
    assert float(tp.means.abs().max()) <= 2.0
    assert tp.features_rest.shape == (4096, 3, 3)
    with pytest.raises(ValueError, match="capacity"):
        tg.init_from_points(np.random.default_rng(0), pts, cols, capacity=100,
                            device="cpu")


def test_grow_capacity_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    jp, jalive, _ = jg.init_from_points(jax.random.PRNGKey(0), pts,
                                        capacity=64, sh_degree=1)
    jp2, jalive2 = jg.grow_capacity(jp, jalive, 96)
    tp2, talive2 = tg.grow_capacity(_to_port_params(jp),
                                    torch.as_tensor(np.asarray(jalive)), 96)
    np.testing.assert_array_equal(talive2.numpy(), np.asarray(jalive2))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tp2, f).numpy(),
                                      np.asarray(getattr(jp2, f)), err_msg=f)
    same, _ = tg.grow_capacity(tp2, talive2, 80)
    assert same is tp2


# -- Adam -------------------------------------------------------------------


def _adam_to_port(jadam):
    flat = {}
    for name in ("mu", "nu", "count", "accum"):
        for f in FIELDS:
            flat[f"adam.{name}.{f}"] = np.asarray(
                getattr(getattr(jadam, name), f))
    return topt.adam_from_numpy(flat, device="cpu")


def test_adam_step_matches_jax_over_12_steps():
    """Twelve steps cross one 10-step apply of features_dc / features_rest.
    Float32 on both sides; rtol 2e-5 / atol 1e-7 on the parameters covers
    the bias-correction powers and the means' decaying rate computed by
    two libraries, rtol 1e-4 on the moments a fused against an unfused
    multiply-add in `b * m + (1 - b) * g` where the two terms cancel."""
    rng = np.random.default_rng(0)
    n = 40
    shapes = {"means": (n, 3), "scales": (n, 3), "quats": (n, 4),
              "features_dc": (n, 3), "features_rest": (n, 3, 3),
              "opacities": (n,), "normals": (n, 3)}
    p0 = {f: rng.normal(size=s).astype(np.float32) for f, s in shapes.items()}
    jp = jg.GaussianParams(**{f: jnp.asarray(v) for f, v in p0.items()})
    tp = tg.params_from_numpy(p0, device="cpu")
    jadam, tadam = jopt.init_adam(jp), topt.init_adam(tp)
    jcfg, tcfg = jopt.OptimConfig(max_steps=20), topt.OptimConfig(max_steps=20)
    jstep = jax.jit(lambda p, g, a, s: jopt.adam_step(jcfg, p, g, a, s))
    for step in range(12):
        g = {f: (rng.normal(size=s) * 10.0 ** rng.uniform(-6, 0)).astype(
            np.float32) for f, s in shapes.items()}
        jp, jadam = jstep(jp, jg.GaussianParams(
            **{f: jnp.asarray(v) for f, v in g.items()}), jadam,
            jnp.asarray(step, jnp.int32))
        tp, tadam = topt.adam_step(tcfg, tp, tg.params_from_numpy(
            g, device="cpu"), tadam, step)
        for f in FIELDS:
            np.testing.assert_allclose(
                getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                rtol=2e-5, atol=1e-7, err_msg=f"{f} at step {step}")
    assert tadam.count["features_dc"] == 1 and tadam.count["means"] == 12
    for name in ("mu", "nu", "accum"):
        for f in FIELDS:
            np.testing.assert_allclose(
                getattr(getattr(tadam, name), f).numpy(),
                np.asarray(getattr(getattr(jadam, name), f)), rtol=1e-4,
                atol=1e-9, err_msg=f"{name}.{f}")
    # features_dc moved once (at step 9), features_rest holds 2 steps' sum
    assert float(tadam.accum.features_rest.abs().sum()) > 0.0
    # the state carried across: port -> numpy (JAX keys) -> port
    back = topt.adam_from_numpy(topt.adam_to_numpy(tadam), device="cpu")
    assert back.count == tadam.count
    np.testing.assert_array_equal(back.nu.quats.numpy(),
                                  tadam.nu.quats.numpy())
    lr = topt.lr_tree(tcfg, 10)
    np.testing.assert_allclose(lr["means"], float(jopt.lr_tree(
        jcfg, jnp.asarray(10)).means), rtol=1e-6)


def test_zero_moments_match_jax():
    rng = np.random.default_rng(1)
    p0 = {"means": (30, 3), "scales": (30, 3), "quats": (30, 4),
          "features_dc": (30, 3), "features_rest": (30, 3, 3),
          "opacities": (30,), "normals": (30, 3)}
    mk = lambda: jg.GaussianParams(**{  # noqa: E731
        f: jnp.asarray(rng.normal(size=s).astype(np.float32))
        for f, s in p0.items()})
    counts = jg.GaussianParams(**{f: jnp.asarray(3, jnp.int32) for f in p0})
    jadam = jopt.AdamState(mu=mk(), nu=mk(), count=counts, accum=mk())
    tadam = _adam_to_port(jadam)
    idx = np.array([0, 7, 7, 29, 30, 45])  # past the capacity: dropped
    jz = jopt.zero_moments_at(jadam, jnp.asarray(idx))
    tz = topt.zero_moments_at(tadam, torch.as_tensor(idx))
    jz = jopt.zero_moments_field(jz, "opacities")
    tz = topt.zero_moments_field(tz, "opacities")
    for name in ("mu", "nu", "accum"):
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(getattr(tz, name), f).numpy(),
                np.asarray(getattr(getattr(jz, name), f)))
    assert tz.count["means"] == 3


# -- refinement transforms --------------------------------------------------


def _refine_state(seed=0, capacity=256, n=64):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    jp, jalive, _ = jg.init_from_points(jax.random.PRNGKey(0), pts, cols,
                                        capacity=capacity, sh_degree=1)
    c = capacity
    big = jnp.where(jnp.arange(c) < 16, jnp.log(0.05), jp.scales[:, 0])
    opac = jnp.where(jnp.arange(c) % 5 == 4, -3.0, jp.opacities + 1.0)
    jp = dataclasses.replace(jp, scales=jnp.stack([big] * 3, -1),
                             opacities=opac)
    jstats = jst.RefineStats(
        grad_sum=jnp.where(jnp.arange(c) < 32, 100.0, 0.0),
        vis_count=jnp.ones((c,)),
        max_2d=jnp.asarray(rng.uniform(0, 0.2, c).astype(np.float32)))
    mk = lambda: jax.tree.map(  # noqa: E731
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)),
        jp)
    jadam = jopt.AdamState(mu=mk(), nu=mk(),
                           count=jopt.init_adam(jp).count, accum=mk())
    return jp, jalive, jadam, jstats


def _split_draws(key, n_samples, capacity):
    """The normal draws `densify_and_cull` of the JAX package makes."""
    draws = []
    for _ in range(n_samples):
        key, ks = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(ks, (capacity, 3))))
    return torch.as_tensor(np.stack(draws))


@pytest.mark.parametrize("step,capacity", [(3000, 256), (3500, 256),
                                           (5000, 256), (3500, 80)])
def test_densify_and_cull_matches_jax_slot_for_slot(step, capacity):
    """Before and after the first opacity reset (step 3000), past
    stop_screen_size_at, and with too few free slots for every child
    (capacity 80): alive mask and the moments' zero pattern exact, the
    parameters exact up to the float32 child offsets (atol 1e-6)."""
    jp, jalive, jadam, jstats = _refine_state(capacity=capacity)
    key = jax.random.PRNGKey(1)
    jcfg, tcfg = jdn.ModelConfig(), tdn.ModelConfig()
    jp2, ja2, jad2, jst2 = jst.densify_and_cull(
        jcfg, jp, jalive, jadam, jstats, key, step, 64.0)
    tp2, ta2, tad2, tst2 = tst.densify_and_cull(
        tcfg, _to_port_params(jp), torch.as_tensor(np.asarray(jalive)),
        _adam_to_port(jadam), tst.stats_from_numpy(
            {k: np.asarray(v) for k, v in jstats._asdict().items()},
            device="cpu"),
        step, 64.0, draws=_split_draws(key, jcfg.n_split_samples, capacity))
    np.testing.assert_array_equal(ta2.numpy(), np.asarray(ja2))
    assert int(ta2.sum()) != int(np.asarray(jalive).sum())
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tp2, f).numpy(),
                                   np.asarray(getattr(jp2, f)), atol=1e-6,
                                   err_msg=f)
    for name in ("mu", "nu", "accum"):
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(getattr(tad2, name), f).numpy(),
                np.asarray(getattr(getattr(jad2, name), f)),
                err_msg=f"{name}.{f}")
    assert float(tst2.grad_sum.abs().sum()) == 0.0 == float(
        jnp.abs(jst2.grad_sum).sum())


def test_densify_draws_from_a_generator():
    jp, jalive, jadam, jstats = _refine_state()
    args = lambda: (  # noqa: E731
        tdn.ModelConfig(), _to_port_params(jp),
        torch.as_tensor(np.asarray(jalive)), _adam_to_port(jadam),
        tst.stats_from_numpy({k: np.asarray(v) for k, v in
                              jstats._asdict().items()}, device="cpu"),
        3000, 64.0)
    a = tst.densify_and_cull(*args(),
                             generator=torch.Generator().manual_seed(5))
    b = tst.densify_and_cull(*args(),
                             generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(a[0].means.numpy(), b[0].means.numpy())
    n0 = int(np.asarray(jalive).sum())
    # 16 split (die, 2 children each) + 16 duplicates, 13 culled by alpha
    assert int(a[1].sum()) > n0


@pytest.mark.parametrize("step", [2000, 3500, 16000])
def test_cull_only_and_reset_opacity_match_jax(step):
    jp, jalive, jadam, jstats = _refine_state()
    jcfg, tcfg = jdn.ModelConfig(), tdn.ModelConfig()
    tstats = tst.stats_from_numpy(
        {k: np.asarray(v) for k, v in jstats._asdict().items()}, device="cpu")
    _, ja, _, _ = jst.cull_only(jcfg, jp, jalive, jadam, jstats, step)
    _, ta, _, ts2 = tst.cull_only(tcfg, _to_port_params(jp),
                                  torch.as_tensor(np.asarray(jalive)),
                                  _adam_to_port(jadam), tstats, step)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert float(ts2.max_2d.sum()) == 0.0
    jp4, jad4 = jst.reset_opacity(jcfg, jp, jadam)
    tp4, tad4 = tst.reset_opacity(tcfg, _to_port_params(jp),
                                  _adam_to_port(jadam))
    np.testing.assert_array_equal(tp4.opacities.numpy(),
                                  np.asarray(jp4.opacities))
    assert float(tad4.mu.opacities.abs().sum()) == 0.0
    np.testing.assert_array_equal(tad4.mu.means.numpy(),
                                  np.asarray(jad4.mu.means))


def test_update_stats_matches_jax():
    rng = np.random.default_rng(2)
    c = 50
    grad = rng.normal(size=(c, 2)).astype(np.float32)
    radii = rng.uniform(0, 30, c).astype(np.float32)
    valid = rng.uniform(size=c) > 0.3
    js = jst.update_stats(jst.init_stats(c), jnp.asarray(grad),
                          jnp.asarray(radii), jnp.asarray(valid), 64.0)
    ts = tst.update_stats(tst.init_stats(c, "cpu"), torch.as_tensor(grad),
                          torch.as_tensor(radii), torch.as_tensor(valid), 64.0)
    for k, v in tst.stats_to_numpy(ts).items():
        np.testing.assert_allclose(v, np.asarray(getattr(js, k)), rtol=1e-6)


# -- the step against the JAX package ---------------------------------------


# Below 255 padded tiles the JAX package's depthq quantizer can swap the
# deepest and the shallowest Gaussian of neighbouring tiles (ROADMAP.md
# section C), which moves its loss by 0.2% on this scene; the port does
# not copy that. Padding the 12 tiles to 256 leaves 23 depth bits, where
# the two packages agree.
PARITY_TRAIN_KW = dict(tile_block=256)


def test_train_step_loss_and_gradients_match_jax(scene):
    """One step at SH degree 1 with the random background of the JAX key:
    the loss of `make_train_step` (rtol 1e-5), its densification
    statistics, and the parameter gradients of the same loss through
    jax.grad on the exact XLA backend, per field scaled by its largest
    magnitude at rtol 2e-2 / atol 2e-3 (the port packs per-pair gradients
    to bf16, the JAX package's sortpack tolerance)."""
    js, ts, pts, cols = scene
    jt = _jax_trainer(scene, train_kw=PARITY_TRAIN_KW)
    tt = _port_trainer(scene, train_kw=PARITY_TRAIN_KW)
    assert tt.train_cfg.pair_capacity == jt.train_cfg.pair_capacity
    tt.params = _to_port_params(jt.params)
    cam, batch = js.get(1)
    tcam, _ = ts.get(1)
    rcfg = jt._raster_cfg(cam)
    key = jax.random.PRNGKey(11)
    kbg, kloss = jax.random.split(key)
    bg = np.asarray(jax.random.uniform(kbg, (3,)))
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p, sink):
        out, info = jdn.get_outputs(p, jt.alive, cam, jt.model_cfg, rcfg,
                                    sh_degree=1, absgrad_sink=sink,
                                    training=True, rng=kbg)
        loss, _ = jdn.compute_loss(out, batch_j, p, jt.alive, cam,
                                   jt.model_cfg, jnp.asarray(1), kloss)
        return loss

    jgrads, jabs = jax.grad(loss_fn, argnums=(0, 1))(
        jt.params, jnp.zeros_like(jt.params.means[:, :2]))
    step_fn = jtr.make_train_step(jt.model_cfg, jt.optim_cfg, rcfg, 1)
    _, _, jstats, jloss, jld, _ = step_fn(
        jt.params, jt.alive, jt.adam, jt.stats, cam, batch_j,
        jnp.asarray(1, jnp.int32), key, jt.cam_opt, jnp.asarray(1, jnp.int32))

    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    trcfg = tt._raster_cfg(tcam)
    loss, ld, gparams, gabs, _ = ttr.loss_and_grads(
        tt.model_cfg, trcfg, 1, tt.params, tt.alive, tcam, tb, 1,
        background=torch.as_tensor(bg))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in jld:
        np.testing.assert_allclose(float(ld[k]), float(jld[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for f in FIELDS:
        gj = np.asarray(getattr(jgrads, f))
        scale = max(np.abs(gj).max(), 1e-12)
        np.testing.assert_allclose(getattr(gparams, f).numpy() / scale,
                                   gj / scale, rtol=2e-2, atol=2e-3,
                                   err_msg=f)
    scale = float(np.abs(np.asarray(jabs)).max())
    np.testing.assert_allclose(gabs.numpy() / scale, np.asarray(jabs) / scale,
                               rtol=2e-2, atol=2e-3)
    assert float(np.abs(np.asarray(jgrads.features_rest)).max()) > 0.0

    # the whole step: statistics as the JAX step leaves them
    _, _, tstats, tloss, _ = ttr.train_step(
        tt.model_cfg, tt.optim_cfg, trcfg, 1, tt.params, tt.alive, tt.adam,
        tt.stats, tcam, tb, 1, background=torch.as_tensor(bg))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(tstats.vis_count.numpy(),
                                  np.asarray(jstats.vis_count))
    np.testing.assert_allclose(tstats.max_2d.numpy(),
                               np.asarray(jstats.max_2d), rtol=1e-5)
    gs = np.asarray(jstats.grad_sum)
    np.testing.assert_allclose(tstats.grad_sum.numpy() / gs.max(),
                               gs / gs.max(), rtol=2e-2, atol=2e-3)


def test_five_step_loss_trajectory_matches_jax(scene):
    """Five steps through `Trainer.train` on both sides from the same
    state, with the fixed background (a random one would need the JAX key
    chain): losses within rel 1e-3. Losses, not parameters: Adam turns a
    rounding-level gradient difference into a full-size step."""
    kw = dict(background_color="black")
    jt = _jax_trainer(scene, model_kw=kw, train_kw=PARITY_TRAIN_KW)
    tt = _port_trainer(scene, model_kw=kw, train_kw=PARITY_TRAIN_KW)
    tt.params = _to_port_params(jt.params)
    jh = jt.train(num_steps=5, log_every=1)
    th = tt.train(num_steps=5, log_every=1)
    jl = [h["loss"] for h in jh]
    tl = [h["loss"] for h in th]
    assert len(tl) == 5 and tt.step == 5
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert [h["n_gaussians"] for h in th] == [h["n_gaussians"] for h in jh]


def test_camera_opt_maps_and_update_match_jax():
    """so3_exp / exp_map_so3xr3 at zero, near zero and at large angles,
    values and gradients; then `cam_opt_update` over 6 steps with an
    accumulation window of 2 against the JAX update."""
    from dnsplatter_torch.models import camera_opt as tco
    from dnsplatter_tpu.models import camera_opt as jco

    rng = np.random.default_rng(0)
    tang = rng.normal(0.0, 1.0, (7, 6)).astype(np.float32)
    tang[0] = 0.0
    tang[1, 3:] = 1e-4
    tang[2, 3:] *= 3.0
    want = np.asarray(jco.exp_map_so3xr3(jnp.asarray(tang)))
    t = torch.as_tensor(tang).requires_grad_(True)
    got = tco.exp_map_so3xr3(t)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    w = rng.normal(size=want.shape).astype(np.float32)
    jgrad = jax.grad(lambda x: jnp.sum(jco.exp_map_so3xr3(x) * w))(
        jnp.asarray(tang))
    (got * torch.as_tensor(w)).sum().backward()
    assert torch.isfinite(t.grad).all()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-6)

    cfg_kw = dict(accum_camera_opt=2, max_steps=10)
    jstate = jopt.init_cam_opt(4)
    tstate = topt.init_cam_opt(4, device="cpu")
    for step in range(6):
        g = rng.normal(size=6).astype(np.float32)
        jstate = jopt.cam_opt_update(
            jopt.OptimConfig(**cfg_kw), jstate, jnp.asarray(step % 4),
            jnp.asarray(g), jnp.asarray(step, jnp.int32))
        topt.cam_opt_update(topt.OptimConfig(**cfg_kw), tstate, step % 4,
                            torch.as_tensor(g), step)
        for f in ("adj", "accum", "mu", "nu"):
            np.testing.assert_allclose(getattr(tstate, f).numpy(),
                                       np.asarray(getattr(jstate, f)),
                                       rtol=1e-5, atol=1e-8, err_msg=f)
        assert tstate.count == int(jstate.count)
    assert tstate.count == 3 and float(tstate.adj.abs().sum()) > 0


def test_camera_opt_trajectory_matches_jax(scene, tmp_path):
    """Three steps with camera_optimizer_mode "SO3xR3" and a pose update
    every step, against the JAX Trainer from the same state with the fixed
    background: losses within rel 1e-3, the pose tangents within 2e-2 of
    their largest value (Adam's first steps have the size of the learning
    rate whatever the gradient's, so only its sign and ratio matter). The
    state goes through a checkpoint and back."""
    kw = dict(background_color="black", camera_optimizer_mode="SO3xR3")
    jt = _jax_trainer(scene, model_kw=kw, train_kw=PARITY_TRAIN_KW,
                      optim_cfg=jopt.OptimConfig(accum_camera_opt=1))
    tt = _port_trainer(scene, model_kw=kw, train_kw=PARITY_TRAIN_KW,
                       optim_cfg=topt.OptimConfig(accum_camera_opt=1))
    tt.params = _to_port_params(jt.params)
    jl = [h["loss"] for h in jt.train(num_steps=3, log_every=1)]
    tl = [h["loss"] for h in tt.train(num_steps=3, log_every=1)]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    jadj = np.asarray(jt.cam_adj)
    assert np.abs(jadj[:3]).max() > 1e-4 and (jadj[3] == 0).all()
    np.testing.assert_allclose(tt.cam_adj.numpy(), jadj,
                               atol=2e-2 * np.abs(jadj).max())
    assert tt.cam_opt.count == 3 == int(jt.cam_opt.count)
    path = tt.save_checkpoint(tmp_path / "pose.npz")
    with np.load(path) as z:
        np.testing.assert_array_equal(z["cam_opt.adj"], tt.cam_adj.numpy())
        np.testing.assert_array_equal(z["cam_adj"], z["cam_opt.adj"])
        assert int(z["cam_opt.count"]) == 3
    jt.load_checkpoint(path)
    np.testing.assert_array_equal(np.asarray(jt.cam_opt.mu),
                                  tt.cam_opt.mu.numpy())
    t2 = _port_trainer(scene, model_kw=kw)
    t2.load_checkpoint(path)
    assert t2.cam_opt.count == 3
    np.testing.assert_array_equal(t2.cam_opt.nu.numpy(),
                                  tt.cam_opt.nu.numpy())


def test_steps_per_dispatch_trajectory_matches_jax(scene):
    """steps_per_dispatch = 2: two steps between looks at the cadence and
    the log. Against the JAX Trainer's scan of two steps over four steps
    (losses within rel 1e-3, one log row per dispatch), and against the
    port's own single-step run, which takes the very same steps."""
    kw = dict(background_color="black", refine_every=4)
    tkw = dict(PARITY_TRAIN_KW, steps_per_dispatch=2)
    jt = _jax_trainer(scene, model_kw=kw, train_kw=tkw)
    tt = _port_trainer(scene, model_kw=kw, train_kw=tkw)
    t1 = _port_trainer(scene, model_kw=kw, train_kw=PARITY_TRAIN_KW)
    tt.params = _to_port_params(jt.params)
    t1.params = _to_port_params(jt.params)
    jh = jt.train(num_steps=4, log_every=1)
    th = tt.train(num_steps=4, log_every=1)
    h1 = t1.train(num_steps=4, log_every=1)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [2, 4]
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=1e-3)
    assert [h["loss"] for h in th] == [h1[1]["loss"], h1[3]["loss"]]
    for f in FIELDS:
        assert torch.equal(getattr(tt.params, f), getattr(t1.params, f))


def test_checkpoints_resume_across_the_two_packages(scene, tmp_path):
    """A checkpoint written by either package is read by the other, key
    for key, and training goes on from it."""
    tt = _port_trainer(scene, out_dir=tmp_path / "port")
    tt.train(num_steps=3, log_every=3)
    path = tt.save_checkpoint()
    assert (path.parent / "config.json").exists()
    assert (path.parent / "metrics.jsonl").read_text().count("\n") >= 1

    jt = _jax_trainer(scene)
    jt.save_checkpoint(tmp_path / "jax_ref.npz")
    with np.load(path) as a, np.load(tmp_path / "jax_ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].shape == b[k].shape, k
            assert a[k].dtype.kind == b[k].dtype.kind, k
    jt.load_checkpoint(path)
    assert jt.step == 3
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jt.params, f)),
                                      getattr(tt.params, f).numpy())
        np.testing.assert_array_equal(np.asarray(getattr(jt.adam.nu, f)),
                                      getattr(tt.adam.nu, f).numpy())
    assert int(jt.adam.count.means) == 3
    jh = jt.train(num_steps=2, log_every=1)
    assert jt.step == 5 and np.isfinite([h["loss"] for h in jh]).all()

    jpath = jt.save_checkpoint(tmp_path / "jax_5.npz")
    t2 = _port_trainer(scene)
    t2.load_checkpoint(jpath)
    assert t2.step == 5 and t2.adam.count["means"] == 5
    np.testing.assert_array_equal(t2.adam.mu.means.numpy(),
                                  np.asarray(jt.adam.mu.means))
    np.testing.assert_array_equal(t2.params.quats.numpy(),
                                  np.asarray(jt.params.quats))
    th = t2.train(num_steps=2, log_every=1)
    assert t2.step == 7 and np.isfinite([h["loss"] for h in th]).all()
    p, alive, step = ttr.load_checkpoint_arrays(jpath, device="cpu")
    assert step == 5 and int(alive.sum()) == 300


# -- mirrors of the JAX package's training smoke tests ----------------------


def test_loss_decreases(scene):
    tt = _port_trainer(scene)
    hist = tt.train(num_steps=30, log_every=1)
    losses = [h["loss"] for h in hist]
    assert np.isfinite(losses).all()
    # Each step sees another camera and another random background, so
    # single losses are noisy: compare the first and the last round of the
    # four cameras (the JAX package's run of this scene falls by 11%).
    assert np.mean(losses[-4:]) < 0.95 * np.mean(losses[:4]), (
        f"no learning: {losses}")
    for f in FIELDS:
        assert torch.isfinite(getattr(tt.params, f)).all()


def test_ags_mesh_strategy_runs(scene):
    tt = _port_trainer(scene,
                       model_kw=dict(regularization_strategy="ags-mesh"))
    hist = tt.train(num_steps=6, log_every=3)
    assert np.isfinite([h["loss"] for h in hist]).all()


def test_resume_continues_training(scene, tmp_path):
    tt = _port_trainer(scene, out_dir=tmp_path)
    tt.train(num_steps=6, log_every=3)
    p = tt.save_checkpoint()
    mu0 = tt.adam.mu.means.numpy().copy()
    t2 = _port_trainer(scene, out_dir=tmp_path)
    t2.load_checkpoint(p)
    np.testing.assert_array_equal(t2.adam.mu.means.numpy(), mu0)
    np.testing.assert_array_equal(t2.params.means.numpy(),
                                  tt.params.means.numpy())
    hist = t2.train(num_steps=10 - t2.step, log_every=2)
    assert t2.step == 10
    assert np.isfinite([h["loss"] for h in hist]).all()


def test_refinement_cadence_and_capacity_growth(scene):
    """Start tight and grow when a densify event fills >= 95% of the
    capacity, through the real cadence; training goes on at the new
    shapes; grown slots stay dead; and, unlike the JAX package, the pair
    capacity is audited again after the growth."""
    tt = _port_trainer(
        scene,
        model_kw=dict(warmup_length=2, refine_every=4,
                      reset_alpha_every=1000, densify_grad_thresh=1e-9,
                      densify_size_thresh=1e9, use_depth_loss=False),
        train_kw=dict(capacity=320, capacity_growth=1.5,
                      auto_capacity_margin=2.0))
    assert tt.params.capacity == 320
    n0, pairs0 = int(tt.alive.sum()), tt.audited_pairs
    hist = tt.train(num_steps=30, log_every=10)
    assert tt.params.capacity > 320, "growth never triggered"
    assert tt.params.capacity % 4096 == 0
    n1 = int(tt.alive.sum())
    assert n0 < n1 <= tt.params.capacity
    assert np.isfinite([h["loss"] for h in hist]).all()
    assert tt.adam.mu.means.shape[0] == tt.params.capacity
    assert tt.stats.grad_sum.shape[0] == tt.params.capacity
    # more Gaussians make more pairs: the audit after the growth saw them
    assert tt.audited_pairs > 2 * pairs0
    assert tt.audited_pairs * 2.0 <= tt.train_cfg.pair_capacity + 32


def test_opacity_reset_and_cull_fire_on_their_steps(scene):
    tt = _port_trainer(scene, model_kw=dict(
        warmup_length=1, refine_every=2, reset_alpha_every=3,
        stop_split_at=9, use_depth_loss=False))
    cam, _ = tt.data.get(0)
    tt.params = dataclasses.replace(
        tt.params, opacities=torch.full_like(tt.params.opacities, 4.0))
    tt.step = 2  # 2 % 6 == refine_every: the reset, and no densify
    tt._refinement(cam)
    max_logit = float(np.log(0.2 / 0.8))
    assert float(tt.params.opacities.max()) <= max_logit + 1e-6
    n0 = int(tt.alive.sum())
    tt.params = dataclasses.replace(
        tt.params, opacities=torch.where(
            torch.arange(tt.params.capacity) < 10, -5.0, 0.0))
    tt.step = 10  # past stop_split_at: cull only
    tt._refinement(cam)
    assert int(tt.alive.sum()) == n0 - 10


def test_default_capacity_margin_and_auto_pair_capacity(scene):
    js, ts, pts, cols = scene
    big = ttr.Trainer(ts, (np.tile(pts, (40, 1)), np.tile(cols, (40, 1))),
                      model_cfg=tdn.ModelConfig(sh_degree=1),
                      train_cfg=ttr.TrainConfig(
                          pair_capacity=1 << 14, chunk=32, tile_block=4,
                          auto_pair_capacity=False), device="cpu")
    n_seed = 40 * pts.shape[0]
    assert big.params.capacity == int(np.ceil(1.25 * n_seed / 4096) * 4096)
    assert big.train_cfg.pair_capacity == 1 << 14

    jt = jtr.Trainer(js, (pts, cols),
                     model_cfg=jdn.ModelConfig(sh_degree=1, warmup_length=100),
                     train_cfg=jtr.TrainConfig(
                         pair_capacity=1 << 20, chunk=32, tile_block=4,
                         steps_per_eval_image=0, auto_capacity_margin=2.0))
    tt = _port_trainer(scene, model_kw=dict(warmup_length=100),
                       train_kw=dict(pair_capacity=1 << 20,
                                     auto_capacity_margin=2.0))
    tt.params = _to_port_params(jt.params)
    cap = tt._audit_pair_capacity()
    # the same count as the JAX audit (float32 tile arithmetic on both)
    assert cap == jt.train_cfg.pair_capacity
    assert cap < (1 << 20) and cap % 32 == 0
    h = tt.train(num_steps=4, log_every=4)
    assert np.isfinite(h[-1]["loss"])


def test_normal_loss_grads_finite_with_empty_pixels():
    """A norm has no gradient at exactly zero; the composited normals of
    empty pixels must not put NaN into whole tiles of the backward."""
    js = make_synthetic_scene(seed=0, n_gaussians=120, n_cameras=1, width=64,
                              height=64, pair_capacity=1 << 12)
    ts = _port_scene(js)
    cam, batch = ts.get(0)
    pts, cols = js.seed_points(jax.random.PRNGKey(1), noise=0.03)
    params, alive, _ = tg.init_from_points(np.random.default_rng(0), pts,
                                           cols, sh_degree=1, device="cpu")
    alive[12:] = 0.0  # a dozen Gaussians leave some pixels empty
    mc = tdn.ModelConfig(use_normal_loss=True, warmup_length=10_000,
                         sh_degree=1)
    cfg = TRasterizeConfig(width=64, height=64, tile_size=16, chunk=32,
                           tile_block=2, pair_capacity=1 << 12,
                           sort_scheme="depthq")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, _, grads, gabs, _ = ttr.loss_and_grads(
        mc, cfg, 1, params, alive, cam, tb, 0, background=torch.zeros(3))
    out, _ = tdn.get_outputs(params, alive, cam, mc, cfg, sh_degree=1,
                             background=torch.zeros(3))
    assert int((out["accumulation"] == 0).sum()) > 16  # empty pixels exist
    assert np.isfinite(float(loss))
    for f in FIELDS:
        assert torch.isfinite(getattr(grads, f)).all(), f
    assert float(grads.quats.abs().sum()) > 0.0


def test_unported_options_raise(scene):
    _, ts, pts, cols = scene

    def make(model_kw, train_kw):
        return ttr.Trainer(ts, (pts, cols),
                           model_cfg=tdn.ModelConfig(**model_kw),
                           train_cfg=ttr.TrainConfig(**train_kw),
                           device="cpu")

    # multi-device training runs one process a device: in one process,
    # devices=2 and dp=2 name the launch they need, and distributed alone
    # is the degenerate single process (as in the JAX package)
    for train_kw in (dict(devices=2), dict(dp=2)):
        with pytest.raises(ValueError, match="torchrun"):
            make({}, train_kw)
    assert make({}, dict(distributed=True)).mesh.shape == {"dp": 1,
                                                           "gauss": 1}
    with pytest.raises(ValueError, match="parallel_strategy"):
        make({}, dict(parallel_strategy="pipeline"))
    # the TensorBoard writer (utils/writers.py) has landed: with an out_dir
    # it writes a tfevents file under out_dir/tb, without one nothing
    assert make({}, dict(tensorboard=True))._writers == []
    # ported since: the pose optimizer and multi-step dispatch construct,
    # and refuse only what the JAX package asserts against
    assert make(dict(camera_optimizer_mode="SO3xR3"), {}).cam_adj.shape \
        == (4, 6)
    assert make({}, dict(steps_per_dispatch=2)).step == 0
    tr = make({}, dict(viewer=True, viewer_port=0))  # the live viewer
    assert tr.viewer.port > 0
    tr.viewer.close()
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        make({}, dict(steps_per_dispatch=3))
    with pytest.raises(ValueError, match="camera_optimizer_mode"):
        make(dict(camera_optimizer_mode="SE3"), {})


def test_train_config_fields_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jtr.TrainConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ttr.TrainConfig)}
    assert jf == tf
    jo = {f.name: f.default for f in dataclasses.fields(jopt.OptimConfig)}
    to = {f.name: f.default for f in dataclasses.fields(topt.OptimConfig)}
    assert jo == to


def test_downscale_schedule(scene):
    tt = _port_trainer(scene, model_kw=dict(num_downscales=1,
                                            resolution_schedule=3))
    assert tt._downscale_factor() == 2
    cam, batch = tt.data.get(0)
    cam2, batch2 = tt._downscaled(0, cam, batch, 2)
    assert (cam2.width, cam2.height) == (32, 24)
    assert batch2["image"].shape == (24, 32, 3)
    assert batch2["sensor_depth"].shape == (24, 32, 1)
    np.testing.assert_allclose(float(cam2.fx), float(cam.fx) / 2)
    hist = tt.train(num_steps=4, log_every=1)  # steps 0-2 at half size
    assert tt._downscale_factor() == 1
    assert np.isfinite([h["loss"] for h in hist]).all()
