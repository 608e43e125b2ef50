"""dnsplatter_torch's baselines (gnerfacto, gdepthfacto, gneusfacto) against
the JAX package's: the hash encoding, the fields, the pdf resampling, both
ray marchers, the sensor-depth loss, one train step of each method
(loss, gradients, parameters after Adam), checkpoints carried across.

Both sides get the same weights and the JAX package's draws (pixels,
jitter, the pdf's uniforms). The JAX functions run under jit on the CPU.
Tolerances: forward values rtol 1e-5 (atol 1e-6 of the output's largest
magnitude, for sums that cancel); gradients atol 1e-5 x the leaf's largest
|g|; parameters after one Adam step (optax.adam on the JAX side) within
1e-3 x lr where the JAX gradient is above 1e-3 of the leaf's largest, and
within 2 x lr everywhere: the first step is -lr g / (|g| + eps), so an
entry whose gradient is rounding noise may flip its sign.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnsplatter_torch.baselines import fields as tF
from dnsplatter_torch.baselines import nerfacto as tnf
from dnsplatter_torch.baselines import neusfacto as tns
from dnsplatter_torch.baselines import runner as trun
from dnsplatter_torch.ops.camera import Camera as TCamera
from dnsplatter_tpu.baselines import fields as jF
from dnsplatter_tpu.baselines import nerfacto as jnf
from dnsplatter_tpu.baselines import neusfacto as jns
from dnsplatter_tpu.baselines import runner as jrun
from dnsplatter_tpu.ops.camera import Camera as JCamera
from dnsplatter_tpu.ops.camera import look_at as jlook_at

torch.set_num_threads(1)

HASH = dict(n_levels=4, log2_table_size=10, max_res=64)
NERF = dict(n_coarse=8, n_fine=8)
NEUS = dict(n_samples=16)
# NeuS runs at 2 hash levels: its JAX programs compile superlinearly in
# the levels (the loss's gradient, a gradient through vmap(value_and_grad),
# 4.4-4.8 s at 2 levels and 12.8-13.4 s at 4 on one CPU worker). Both of
# its levels (resolutions 16 and 64) wrap the uint32 hash.
NEUS_HASH = dict(HASH, n_levels=2)
RTOL = 1e-5
GRAD_ATOL = 1e-5
GRAD_RAYS = 64


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _close(got, want, rtol=RTOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale,
                               err_msg=what)


def _grad_close(got, want, what=""):
    want = np.asarray(want)
    got = got.detach().numpy()
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_ATOL * scale,
                               err_msg=what)


def _jax_params(method, key=0):
    """The JAX package's config and initial params."""
    if method == "gneusfacto":
        cfg = jns.NeuSConfig(hash=jF.HashGridConfig(**NEUS_HASH), **NEUS)
    else:
        cfg = jnf.NerfactoConfig(hash=jF.HashGridConfig(**HASH),
                                 use_depth_loss=method == "gdepthfacto",
                                 **NERF)
    return cfg, _jax_jitted("init_params", cfg)(jax.random.PRNGKey(key))


def _port_cfg(jcfg):
    h = tF.HashGridConfig(**dataclasses.asdict(jcfg.hash))
    if isinstance(jcfg, jns.NeuSConfig):
        return tns.NeuSConfig(hash=h, **NEUS)
    return tnf.NerfactoConfig(hash=h, use_depth_loss=jcfg.use_depth_loss,
                              **NERF)


def _port_params(method, jparams, jcfg):
    return trun.params_from_jax(jparams, _port_cfg(jcfg), device="cpu")


def _jax_jitted(name, cfg):
    """The JAX baseline function `name(params-or-key, cfg, *args)` at `cfg`,
    jitted once for all the tests that call it at that config (op by op,
    the JAX init alone compiles dozens of small programs)."""
    if hasattr(cfg, "use_depth_loss"):  # read by nerfacto's step alone
        cfg = dataclasses.replace(cfg, use_depth_loss=False)
    return _jax_jitted_at(name, cfg)


@functools.lru_cache(maxsize=None)
def _jax_jitted_at(name, cfg):
    fn = getattr(jns if hasattr(cfg, "n_samples") else jnf, name)
    return jax.jit(lambda first, *args: fn(first, cfg, *args))


def _rays(n=32, seed=0):
    """Rays from inside the [-4, 4] box outward: every ray leaves it before
    the far plane, so samples beyond the box are clipped."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


# -- fields -------------------------------------------------------------------


@pytest.mark.parametrize("hash_kw", [HASH, dict(n_levels=3,
                                                log2_table_size=12,
                                                base_res=512, max_res=4096)])
def test_hash_encode_matches_jax(hash_kw):
    jcfg, tcfg = jF.HashGridConfig(**hash_kw), tF.HashGridConfig(**hash_kw)
    tables = np.asarray(jax.jit(lambda k: jF.init_hash_grid(k, jcfg))(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (257, 3)).astype(np.float32)
    x[:4] = [[0, 0, 0], [1, 1, 1], [1, 0, 0.5], [0.999999, 1, 0]]
    # the uint32 hash wraps: a corner's y product exceeds 2^32
    res = tF.level_resolutions(tcfg)
    assert res == [int(jcfg.base_res * np.exp(
        (np.log(jcfg.max_res) - np.log(jcfg.base_res))
        / max(jcfg.n_levels - 1, 1)) ** lvl) for lvl in range(jcfg.n_levels)]
    assert np.floor(x[:, 1] * res[-1]).max() * tF.PRIMES[1] > 2**32
    cot = rng.normal(size=(257, jcfg.n_levels * 2)).astype(np.float32)

    def jloss(t, xx):
        enc = jF.hash_encode(t, xx, jcfg)
        return jnp.sum(enc * cot), enc

    (_, want), (gt_want, gx_want) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(tables, x)

    tt = _t(tables).requires_grad_(True)
    tx = _t(x).requires_grad_(True)
    got = tF.hash_encode(tt, tx, tcfg)
    _close(got, want, what="features")
    gt, gx = torch.autograd.grad((got * _t(cot)).sum(), (tt, tx))
    _grad_close(gt, gt_want, "d tables")
    _grad_close(gx, gx_want, "d x")


def test_mlp_and_direction_encoding_match_jax():
    x = np.random.default_rng(0).normal(size=(9, 5)).astype(np.float32)
    p, want, want_sh = jax.jit(lambda k, xx: (
        (p := jF.init_mlp(k, (5, 16, 4))), jF.mlp(p, xx, jax.nn.sigmoid),
        jF.sh_dir_encode(xx[:, :3])))(jax.random.PRNGKey(3), x)
    m = tF.MLP((5, 16, 4))
    m.load_state_dict({k: _t(v) for k, v in p.items()})
    _close(tF.mlp(m, _t(x), torch.sigmoid), want)
    _close(tF.sh_dir_encode(_t(x[:, :3])), want_sh)


# -- nerfacto -----------------------------------------------------------------


def test_nerfacto_field_matches_jax():
    jcfg, jp = _jax_params("gnerfacto")
    tp = _port_params("gnerfacto", jp, jcfg)
    rng = np.random.default_rng(2)
    pts = rng.uniform(-6, 6, (64, 3)).astype(np.float32)  # some outside
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dens, rgb = jax.jit(lambda a, b: jnf.field(jp, jcfg, a, b))(pts, dirs)
    tdens, trgb = tnf.field(tp, _port_cfg(jcfg), _t(pts), _t(dirs))
    _close(tdens, dens, what="density")
    _close(trgb, rgb, what="rgb")


def test_sample_pdf_matches_jax():
    rng = np.random.default_rng(4)
    ts = np.sort(rng.uniform(0.05, 12, (16, 8)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (16, 8)).astype(np.float32)
    w[3] = 0.0  # a ray with no weight: the 1e-5 floor makes it uniform
    key = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key, (16, 8)))
    want = jax.jit(lambda a, b: jnf._sample_pdf(key, a, b, 8))(ts, w)
    _close(tnf._sample_pdf(_t(ts), _t(w), _t(u)), want)


def _nerf_draws(key, r, cfg):
    kc, kf = jax.random.split(key)
    return {"jitter": _t(jax.random.uniform(kc, (r, cfg.n_coarse))),
            "u": _t(jax.random.uniform(kf, (r, cfg.n_fine)))}


def test_nerfacto_render_rays_matches_jax():
    jcfg, jp = _jax_params("gnerfacto")
    tp = _port_params("gnerfacto", jp, jcfg)
    o, d = _rays()
    key = jax.random.PRNGKey(6)
    want = _jax_jitted("render_rays", jcfg)(jp, o, d, key)
    got = tnf.render_rays(tp, _port_cfg(jcfg), _t(o), _t(d),
                          draws=_nerf_draws(key, len(o), jcfg))
    for k in ("rgb", "depth", "accumulation"):
        _close(got[k], want[k], what=k)


# -- NeuS ---------------------------------------------------------------------


def test_neus_sdf_geo_and_grad_matches_jax():
    jcfg, jp = _jax_params("gneusfacto")
    tp = _port_params("gneusfacto", jp, jcfg)
    rng = np.random.default_rng(7)
    pts = rng.uniform(-6, 6, (8, 6, 3)).astype(np.float32)  # some outside
    sdf, geo, grad = jax.jit(
        lambda a: jns.sdf_geo_and_grad(jp, jcfg, a))(pts)
    with torch.no_grad():
        tsdf, tgeo, tgrad = tns.sdf_geo_and_grad(tp, _port_cfg(jcfg),
                                                 _t(pts))
    _close(tsdf, sdf, what="sdf")
    _close(tgeo, geo, what="geo")
    _close(tgrad, grad, what="grad")
    _close(tns.sdf_fn(tp, _port_cfg(jcfg), _t(pts)), sdf, what="sdf_fn")


def test_neus_render_rays_and_sensor_depth_loss_match_jax():
    jcfg, jp = _jax_params("gneusfacto")
    tp = _port_params("gneusfacto", jp, jcfg)
    o, d = _rays(seed=1)
    key = jax.random.PRNGKey(8)
    depth = np.random.default_rng(9).uniform(0.5, 5, (len(o), 1))
    depth[:5] = 0.0  # invalid rays
    depth = depth.astype(np.float32)

    want = _jax_jitted("render_rays", jcfg)(jp, o, d, key)
    want_loss = jax.jit(jns.sensor_depth_loss, static_argnums=2)(
        want, depth, 0.5)
    jitter = _t(jax.random.uniform(key, (len(o), jcfg.n_samples)))
    with torch.no_grad():
        got = tns.render_rays(tp, _port_cfg(jcfg), _t(o), _t(d),
                              jitter=jitter)
    for k in ("rgb", "depth", "normal", "accumulation", "eikonal", "sdf",
              "ts", "w"):
        _close(got[k], want[k], what=k)
    _close(tns.sensor_depth_loss(got, _t(depth), 0.5), want_loss,
           what="sensor depth loss")


# -- one train step of each method --------------------------------------------


def _frame(w=40, h=30, seed=10):
    rng = np.random.default_rng(seed)
    c2w = np.asarray(jlook_at(jnp.array([0.3, 0.2, 2.5]), jnp.zeros(3)))
    jcam = JCamera.create(30.0, 31.0, w / 2 - 0.3, h / 2 + 0.2, c2w, w, h)
    tcam = TCamera.create(30.0, 31.0, w / 2 - 0.3, h / 2 + 0.2, c2w, w, h,
                          device="cpu")
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    dep = rng.uniform(0.5, 4, (h, w, 1)).astype(np.float32)
    dep[rng.uniform(size=(h, w)) < 0.2] = 0.0
    nrm = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    return jcam, tcam, img, dep, nrm


def _jax_nerf_ts(jp, cfg, o, d, key):
    """The sample distances of the JAX marcher (its render_rays up to the
    sort), from its own functions."""
    r = o.shape[0]
    kc, kf = jax.random.split(key)
    t_coarse = jnp.broadcast_to(jnp.linspace(cfg.near, cfg.far, cfg.n_coarse),
                                (r, cfg.n_coarse))
    t_coarse = t_coarse + jax.random.uniform(kc, (r, cfg.n_coarse)) * (
        (cfg.far - cfg.near) / cfg.n_coarse)
    pts = o[:, None] + t_coarse[..., None] * d[:, None]
    dens_c, _ = jnf.field(jp, cfg, pts,
                          jnp.broadcast_to(d[:, None], pts.shape))
    w_c = jnf._render_weights(dens_c, t_coarse)
    t_fine = jnf._sample_pdf(kf, t_coarse, w_c, cfg.n_fine)
    return jnp.sort(jnp.concatenate([t_coarse, t_fine], -1), -1)


def _jax_loss_fn(method, cfg, cam, img, dep, nrm, px, kray, ts=None):
    """The loss of the JAX step (make_train_step's loss_fn) on given draws;
    with `ts`, the nerfacto marcher renders at those sample distances (its
    render_rays after the sort). Returns (loss, sample distances)."""
    img, dep, nrm = jnp.asarray(img), jnp.asarray(dep), jnp.asarray(nrm)

    def loss_fn(p):
        o, d = jnf.camera_rays(cam, px)
        gt = img[px[:, 1], px[:, 0]]
        if method == "gneusfacto":
            out = jns.render_rays(p, cfg, o, d, kray)
            loss = jnp.mean((out["rgb"] - gt) ** 2) + 0.1 * out["eikonal"]
            loss = loss + cfg.depth_lambda * jns.sensor_depth_loss(
                out, dep[px[:, 1], px[:, 0]], cfg.freespace_trunc)
            ngt = 2.0 * nrm[px[:, 1], px[:, 0]] - 1.0
            return loss + cfg.normal_lambda * jnp.mean(
                jnp.abs(out["normal"] - ngt)), out["ts"]
        pts = o[:, None] + ts[..., None] * d[:, None]
        dens, rgb = jnf.field(p, cfg, pts,
                              jnp.broadcast_to(d[:, None], pts.shape))
        w = jnf._render_weights(dens, ts)
        acc = jnp.sum(w, axis=1, keepdims=True)
        depth = jnp.sum(w * ts, axis=1, keepdims=True) / jnp.maximum(acc,
                                                                     1e-8)
        loss = jnp.mean((jnp.sum(w[..., None] * rgb, axis=1) - gt) ** 2)
        if cfg.use_depth_loss:
            dgt = dep[px[:, 1], px[:, 0]]
            mask = (dgt[:, 0] > 0.1).astype(jnp.float32)
            loss = loss + cfg.depth_lambda * jnp.sum(
                mask * jnp.abs(depth[:, 0] - dgt[:, 0])
            ) / jnp.maximum(mask.sum(), 1.0)
        return loss, ts

    return loss_fn


@pytest.mark.parametrize("method", ["gnerfacto", "gdepthfacto", "gneusfacto"])
def test_train_step_matches_jax(method):
    """The JAX step's loss (its make_train_step's loss_fn) and jax.grad on
    GRAD_RAYS of its pixel draws, at the JAX marcher's own sample distances
    (XLA's CPU division and fused products place samples a few ulps from
    PyTorch's, and a hash table's gradient moves with a sample's cell and
    corner weights); then the port's step function on the same rays against
    optax.adam(lr) applied to the JAX gradients."""
    import optax

    jcfg, jp = _jax_params(method, key=11)
    tcfg = _port_cfg(jcfg)
    tp = _port_params(method, jp, jcfg)
    jcam, tcam, img, dep, nrm = _frame()
    lr = trun.BASELINE_METHODS[method]
    neus = method == "gneusfacto"
    mod = tns if neus else tnf
    frame = (tcam, _t(img), _t(dep)) + ((_t(nrm),) if neus else ())
    kpix, kray = jax.random.split(jax.random.PRNGKey(12))
    n_rays = tns.N_RAYS if neus else tnf.N_RAYS
    px = jax.jit(lambda k: jax.random.randint(
        k, (n_rays, 2), 0, jnp.array([40, 30]))[:GRAD_RAYS])(kpix)
    ts = None
    if not neus:
        ts = jax.jit(lambda p: _jax_nerf_ts(
            p, jcfg, *jnf.camera_rays(jcam, px), kray))(jp)
    (jloss, jts), jgrads = jax.jit(jax.value_and_grad(_jax_loss_fn(
        method, jcfg, jcam, img, dep, nrm, px, kray, ts), has_aux=True))(jp)
    draws = {"px": torch.as_tensor(np.asarray(px), dtype=torch.int64),
             "ts": _t(jts)}
    loss = mod.train_loss(tp, tcfg, *frame, draws)
    _close(loss, jloss, what="loss")
    grads = torch.autograd.grad(loss, trun.leaves_like_jax(tp))
    for j, (g, want) in enumerate(zip(grads, jax.tree.leaves(jgrads))):
        _grad_close(g, want, f"leaf {j}")

    opt = optax.adam(lr)
    new_jp = jax.jit(lambda p, g: optax.apply_updates(
        p, opt.update(g, opt.init(p), p)[0]))(jp, jgrads)
    step, make_opt = mod.make_train_step(tcfg, lr=lr)
    _close(step(tp, make_opt(tp), *frame, draws=draws), jloss,
           what="step loss")
    for j, (got, want, g) in enumerate(zip(trun.leaves_like_jax(tp),
                                           jax.tree.leaves(new_jp),
                                           jax.tree.leaves(jgrads))):
        got, want, g = got.detach().numpy(), np.asarray(want), np.abs(g)
        diff = np.abs(got - want)
        assert diff.max() <= 2 * lr * (1 + 1e-5), f"leaf {j}"
        firm = g > 1e-3 * g.max()
        assert diff[firm].max(initial=0) <= 1e-3 * lr, (j, diff[firm].max())


# -- checkpoints across the packages ------------------------------------------


@pytest.mark.parametrize("method", ["gnerfacto", "gneusfacto"])
def test_params_carry_across_both_ways(method):
    jcfg, jp = _jax_params(method, key=13)
    tp = _port_params(method, jp, jcfg)
    jleaves = jax.tree.leaves(jp)
    tleaves = trun.leaves_like_jax(tp)
    assert len(tleaves) == len(jleaves) == (10 if method == "gneusfacto"
                                            else 11)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    # and back: the port's leaves unflatten into the JAX NamedTuple
    back = jax.tree.unflatten(jax.tree.structure(jp),
                              [a.detach().numpy() for a in tleaves])
    for a, b in zip(jax.tree.leaves(back), jleaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # numpy leaves give the same module as the NamedTuple
    tp2 = trun.params_from_jax([np.asarray(x) for x in jleaves],
                               _port_cfg(jcfg), device="cpu")
    for a, b in zip(trun.leaves_like_jax(tp2), tleaves):
        assert torch.equal(a.cpu(), b)
    with pytest.raises(ValueError, match="leaves"):
        trun.params_from_jax(jleaves[:-1], _port_cfg(jcfg), device="cpu")


class _OneFrame:
    def __init__(self, cam, img, dep, nrm):
        self.item = (cam, {"image": img, "sensor_depth": dep, "normal": nrm})

    def __len__(self):
        return 1

    def get(self, i):
        return self.item


@pytest.mark.parametrize("method", ["gdepthfacto", "gneusfacto"])
def test_jax_checkpoint_renders_the_same_in_the_port(method, tmp_path,
                                                     monkeypatch):
    """A `train_baseline` checkpoint of the JAX package (small fields),
    loaded by the port: the same render on the same draws; and the port's
    own `train_baseline` writes the same leaf shapes."""
    import dataclasses
    import json

    jcfg, jinit = _jax_params(method)
    tcfg = _port_cfg(jcfg)
    small = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
             if f.name in ("hash", *NERF, *NEUS)}
    jmod = jns if method == "gneusfacto" else jnf
    cls = jcfg.__class__
    monkeypatch.setattr(jmod, cls.__name__,
                        lambda **kw: cls(**{**small, **kw}))
    jcam, tcam, img, dep, nrm = _frame()
    # no steps: its step compiles for seconds, and the leaves are distinct
    # draws either way
    jrun.train_baseline(method, _OneFrame(jcam, img, dep, nrm), num_steps=0,
                        out_dir=tmp_path / "j", log_every=1)
    with np.load(tmp_path / "j" / f"baseline_{method}.npz") as z:
        leaves = [z[f"leaf_{j}"] for j in range(len(z.files))]
    tp = trun.params_from_jax(leaves, tcfg, device="cpu")
    jp = jax.tree.unflatten(jax.tree.structure(jinit),
                            [jnp.asarray(x) for x in leaves])
    o, d = _rays(32, seed=3)
    key = jax.random.PRNGKey(14)
    want = _jax_jitted("render_rays", jcfg)(jp, o, d, key)
    with torch.no_grad():
        if method == "gneusfacto":
            got = tns.render_rays(tp, tcfg, _t(o), _t(d), jitter=_t(
                jax.random.uniform(key, (32, jcfg.n_samples))))
        else:
            got = tnf.render_rays(tp, tcfg, _t(o), _t(d),
                                  draws=_nerf_draws(key, 32, jcfg))
    for k in ("rgb", "depth"):
        _close(got[k], want[k], what=k)

    # the port's runner at the same small config: same files, leaf shapes
    monkeypatch.setattr(trun, "method_config", lambda m: tcfg)
    params, hist = trun.train_baseline(
        method, _OneFrame(tcam, img, dep, nrm), num_steps=2,
        out_dir=tmp_path / "t", log_every=1, device="cpu")
    with np.load(tmp_path / "t" / f"baseline_{method}.npz") as z:
        assert [z[f"leaf_{j}"].shape for j in range(len(z.files))] == \
            [x.shape for x in leaves]
    rows = json.loads((tmp_path / "t" / f"baseline_{method}_history.json")
                      .read_text())
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert rows == hist
