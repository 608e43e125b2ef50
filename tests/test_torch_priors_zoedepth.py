"""dnsplatter_torch's ZoeDepth-NYU against the JAX package's functions, on
the CPU, at the narrow configuration of the JAX package's
tests/test_zoedepth.py (`zoedepth.SMALL_CONFIG`), with the same random
weights: numpy arrays for every persistent key of the port module's
`state_dict()` (the relative-position indices are non-persistent
buffers), loaded strictly into it and passed to JAX as its parameter dict.

Stages: the BEiT tokens, the relative-position bias, the neck, the
relative head, the metric head, the log-binomial.
Tolerances, with atol taken of each array's largest magnitude where that
is above 1 (float32 sums in another order err in proportion to the
activations' scale; a BiT feature near zero among values of order 3 missed
a bare 1e-5 by 1.1e-6): each stage (BEiT tokens, the relative-position bias, the neck's
fusion outputs and bottleneck, the relative head, the log-binomial)
rtol 1e-4 / atol 1e-5; end to end (`zoedepth_forward`, `predict_depth`)
rtol 1e-3 / atol 1e-4. The JAX graphs run under jax.jit, except the
package's `_log_binomial`, which returns NaN under jit on the CPU (its
`predict_depth` runs eagerly and is unaffected): it runs eagerly, in a
host callback, inside the jitted graph.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnsplatter_torch.priors import common as C
from dnsplatter_torch.priors import zoedepth as T
from dnsplatter_tpu.priors import zoedepth as J

torch.set_num_threads(1)
STAGE = dict(rtol=1e-4, atol=1e-5)
END = dict(rtol=1e-3, atol=1e-4)


def _close(got, want, rtol, atol, err_msg=""):
    """assert_allclose with atol taken of the array's largest magnitude
    (when above 1): float32 sums in another order err in proportion to the
    activations' scale, an element near zero among large ones too."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=err_msg)
JCFG = J.ZoeDepthNYUConfig(**{f.name: getattr(T.SMALL_CONFIG, f.name)
                              for f in dataclasses.fields(J.ZoeDepthNYUConfig)})


def _eager_log_binomial(prob, temp, n_bins):
    shape = jax.ShapeDtypeStruct(prob.shape[:-1] + (n_bins,), jnp.float32)
    return jax.pure_callback(
        lambda p, t: np.asarray(_LOG_BINOMIAL(p, t, n_bins), np.float32),
        shape, prob, temp)


_LOG_BINOMIAL = J._log_binomial


@pytest.fixture(scope="module")
def net():
    model = T.ZoeDepth(T.SMALL_CONFIG).eval()
    arrays = C.random_arrays(model, 2)
    C.params_from_numpy(model, arrays)
    return model, arrays


@pytest.fixture(scope="module")
def jax_forward():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "_log_binomial", _eager_log_binomial)
        forward = J.zoedepth_forward
        fwd = jax.jit(lambda p, x: forward(p, JCFG, x))
        yield fwd


def _img(seed, h, w):
    return np.random.default_rng(seed).uniform(size=(1, 3, h, w)).astype(
        np.float32)


def _nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


def test_config_defaults_equal():
    got = dataclasses.asdict(T.ZoeDepthNYUConfig())
    want = dataclasses.asdict(J.ZoeDepthNYUConfig())
    assert {k: got[k] for k in want} == want


def test_state_dict_leaves_out_the_position_index(net):
    model, arrays = net
    assert not any(k.endswith("relative_position_index") for k in arrays)
    assert any(k.endswith("relative_position_index")
               for k, _ in model.named_buffers())


@pytest.mark.parametrize("window", [(6, 6), (8, 10), (4, 5), (24, 32)],
                         ids=["trained", "grown", "shrunk", "predict"])
def test_relative_position_bias_matches_jax(net, window):
    model, arrays = net
    rpb = model.backbone.encoder.layer[1].attention.attention \
        .relative_position_bias
    with torch.inference_mode():
        got = rpb(*window).numpy()
    key = ("backbone.encoder.layer.1.attention.attention."
           "relative_position_bias.relative_position_bias_table")
    want = np.asarray(J._rel_pos_bias(arrays[key], (6, 6), window))
    t = window[0] * window[1] + 1
    assert got.shape == (1, JCFG.num_heads, t, t)
    _close(got, want, **STAGE)


def test_rel_pos_index_equal():
    for wh, ww in ((6, 6), (3, 5)):
        np.testing.assert_array_equal(T._rel_pos_index(wh, ww),
                                      J._rel_pos_index(wh, ww))


def test_beit_backbone_matches_jax(net):
    model, arrays = net
    img = np.random.default_rng(0).normal(size=(1, 3, 96, 96)).astype(
        np.float32)
    with torch.inference_mode():
        got, grid = T.beit_backbone(model, torch.as_tensor(img))
    want, jgrid = jax.jit(lambda p, x: J.beit_backbone(p, JCFG, x))(
        arrays, img.transpose(0, 2, 3, 1))
    assert grid == (6, 6) and tuple(jgrid) == (6, 6)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), np.asarray(w),
                                   err_msg=f"stage {i}", **STAGE)


def test_neck_and_relative_head_match_jax(net):
    model, arrays = net
    rng = np.random.default_rng(1)
    hidden = [rng.normal(size=(1, 1 + 8 * 10, 32)).astype(np.float32)
              for _ in range(4)]

    def jax_part(p, hid):
        fused, bottleneck = J.zoedepth_neck(p, JCFG, hid, 8, 10)
        return fused, bottleneck, J.relative_head(p, fused[-1])

    with torch.inference_mode():
        fused, bottleneck = T.zoedepth_neck(
            model, [torch.as_tensor(h) for h in hidden], 8, 10)
        rel, feats = model.relative_head(fused[-1])
    jfused, jbottleneck, (jrel, jfeats) = jax.jit(jax_part)(arrays, hidden)
    for i, (g, w) in enumerate(zip(fused, jfused)):
        _close(g.numpy(), _nchw(w), err_msg=f"fusion {i}",
                                   **STAGE)
    _close(bottleneck.numpy(), _nchw(jbottleneck),
                               **STAGE)
    _close(rel.numpy(), np.asarray(jrel), **STAGE)
    _close(feats.numpy(), _nchw(jfeats), **STAGE)


def test_metric_head_matches_jax(net):
    """The bins head on the neck's and the relative head's outputs of an
    8x10 patch grid (four scales, attractors, the log-binomial)."""
    model, arrays = net
    rng = np.random.default_rng(6)
    hidden = [rng.normal(size=(1, 1 + 8 * 10, 32)).astype(np.float32)
              for _ in range(4)]
    with torch.inference_mode():
        fused, bottleneck = T.zoedepth_neck(
            model, [torch.as_tensor(h) for h in hidden], 8, 10)
        rel, feats = model.relative_head(fused[-1])
        got = model.metric_head(feats, bottleneck, fused, rel).numpy()

    def nhwc(t):
        return t.numpy().transpose(0, 2, 3, 1)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "_log_binomial", _eager_log_binomial)
        want = jax.jit(lambda p, *a: J.metric_head(p, JCFG, *a))(
            arrays, nhwc(feats), nhwc(bottleneck), [nhwc(f) for f in fused],
            rel.numpy())
    assert got.shape == (1, 128, 160) and np.asarray(want).std() > 1e-3
    _close(got, np.asarray(want), **STAGE)


def test_log_binomial_matches_jax():
    rng = np.random.default_rng(2)
    prob = rng.uniform(0, 1, (1, 1, 9, 11)).astype(np.float32)
    temp = rng.uniform(0.03, 50, (1, 1, 9, 11)).astype(np.float32)
    got = T._log_binomial(torch.as_tensor(prob), torch.as_tensor(temp),
                          16).numpy()
    want = np.asarray(J._log_binomial(prob.transpose(0, 2, 3, 1),
                                      temp.transpose(0, 2, 3, 1), 16))
    _close(got, want.transpose(0, 3, 1, 2), **STAGE)


@pytest.mark.parametrize("hw", [(96, 96), (128, 160)],
                         ids=["trained-grid", "off-grid"])
def test_zoedepth_forward_matches_jax(net, jax_forward, hw):
    model, arrays = net
    img = _img(3, *hw)
    with torch.inference_mode():
        got = T.zoedepth_forward(model, torch.as_tensor(img)).numpy()
    want = np.asarray(jax_forward(arrays, img.transpose(0, 2, 3, 1)))
    assert got.shape == (1,) + hw
    assert want.std() > 1e-3  # a map, not a constant
    _close(got, want, **END)


def test_predict_depth_shrinking_matches_jax(net, jax_forward, monkeypatch):
    """400x560 shrinks to the network's 384x512 (antialiased, as
    jax.image.resize does) and the flip-averaged depth grows back."""
    model, arrays = net
    rgb = np.random.default_rng(4).uniform(size=(400, 560, 3)).astype(
        np.float32)
    monkeypatch.setattr(J, "zoedepth_forward",
                        lambda p, cfg, x: jax_forward(p, x))
    got = T.predict_depth(model, rgb)
    want = J.predict_depth(arrays, rgb, JCFG)
    assert got.shape == (400, 560) and np.isfinite(got).all()
    _close(got, want, **END)


def test_depth_from_pretrain_matches_jax(net, jax_forward, tmp_path,
                                         monkeypatch):
    """`depth_from_pretrain` over a folder of three frames, two with
    sensor depths of their size (aligned), the weights an npz written
    here, against the JAX package's `run_monocular_depth`: depths and
    aligned depths rtol 1e-3 / atol 1e-4 as the network end to end. Both
    scripts default to the published configuration; the test points both
    at the narrow one."""
    from dnsplatter_torch.data import io as tio
    from dnsplatter_torch.scripts import depth_from_pretrain as TDP
    from dnsplatter_tpu.scripts import depth_from_pretrain as JDP

    model, arrays = net
    sizes = [(40, 56), (40, 56), (36, 48)]
    rng = np.random.default_rng(8)
    for root in (tmp_path / "t", tmp_path / "j"):
        (root / "images").mkdir(parents=True)
        for i, (h, w) in enumerate(sizes):
            tio.write_image(root / "images" / f"frame_{i}.png",
                            np.random.default_rng(i).uniform(size=(h, w, 3)))
    (tmp_path / "depth").mkdir()
    for i, (h, w) in enumerate(sizes[:2]):
        tio.write_depth_png(tmp_path / "depth" / f"frame_{i}.png",
                            rng.uniform(0.8, 2.5, (h, w)))
    np.savez(tmp_path / "zoe.npz", **arrays)
    monkeypatch.setattr(T, "ZoeDepthNYUConfig", lambda: T.SMALL_CONFIG)
    monkeypatch.setattr(J, "ZoeDepthNYUConfig", lambda: JCFG)
    monkeypatch.setattr(J, "zoedepth_forward",
                        lambda p, cfg, x: jax_forward(p, x))
    assert TDP.main(["--data", str(tmp_path / "t"), "--ckpt",
                     str(tmp_path / "zoe.npz"), "--device", "cpu",
                     "--sensor-dir", str(tmp_path / "depth")]) == 3
    JDP.run_monocular_depth(tmp_path / "j" / "images",
                            tmp_path / "j" / "mono_depth",
                            tmp_path / "depth",
                            ckpt_path=tmp_path / "zoe.npz")
    names = sorted(p.name for p in (tmp_path / "t/mono_depth").glob("*"))
    assert names == sorted(p.name for p in
                           (tmp_path / "j/mono_depth").glob("*"))
    assert len(names) == 5  # three predictions, two aligned
    for n in names:
        got = np.load(tmp_path / "t/mono_depth" / n)
        want = np.load(tmp_path / "j/mono_depth" / n)
        assert got.shape == want.shape and np.isfinite(got).all()
        _close(got, want, **END)
