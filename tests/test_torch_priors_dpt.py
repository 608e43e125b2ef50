"""dnsplatter_torch's DPT-Hybrid (Omnidata's normal network) against the JAX
package's functions, on the CPU, at the narrow configuration of the JAX
package's tests/test_dpt.py (`dpt.SMALL_CONFIG`), with the same random
weights: numpy arrays for every key of the port module's `state_dict()`,
loaded strictly into it and passed to JAX as its parameter dict. The port
is NCHW, the JAX package NHWC: transposed here only.

Stages: the BiT backbone, the ViT readouts, the neck, the head.
Tolerances, with atol taken of each array's largest magnitude where that
is above 1 (float32 sums in another order err in proportion to the
activations' scale; a BiT feature near zero among values of order 3 missed
a bare 1e-5 by 1.1e-6): each stage (BiT features, the readout tokens, the fusion
outputs of the neck) rtol 1e-4 / atol 1e-5; end to end (`dpt_forward`,
`run_normals`) rtol 1e-3 / atol 1e-4. The JAX graphs run under jax.jit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dnsplatter_torch.priors import common as C
from dnsplatter_torch.priors import dpt as T
from dnsplatter_tpu.priors import dpt as J

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


def _jax_cfg(cfg):
    return J.DPTHybridConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module", params=[1, 3], ids=["depth", "normals"])
def net(request):
    cfg = dataclasses.replace(T.SMALL_CONFIG, out_channels=request.param)
    model = T.DPTHybrid(cfg).eval()
    arrays = C.random_arrays(model, request.param)
    C.params_from_numpy(model, arrays)
    return model, arrays, _jax_cfg(cfg)


def _img(seed, h=96, w=96):
    return np.random.default_rng(seed).uniform(size=(1, 3, h, w)).astype(
        np.float32)


def _nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


def test_config_fields_and_defaults_equal():
    assert dataclasses.asdict(T.DPTHybridConfig()) == dataclasses.asdict(
        J.DPTHybridConfig())


def test_bit_backbone_matches_jax(net):
    model, arrays, jcfg = net
    img = _img(0)
    with torch.inference_mode():
        got = T.bit_backbone(model, torch.as_tensor(img))
    want = jax.jit(lambda p, x: J.bit_backbone(p, jcfg, x))(
        arrays, img.transpose(0, 2, 3, 1))
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), _nchw(w), err_msg=f"stage {i}",
                                   **STAGE)


def test_vit_encoder_matches_jax(net):
    model, arrays, jcfg = net
    feats = np.random.default_rng(1).normal(size=(1, 32, 6, 6)).astype(
        np.float32)
    with torch.inference_mode():
        got = T.vit_encoder(model, torch.as_tensor(feats))
    want = jax.jit(lambda p, x: J.vit_encoder(p, jcfg, x))(
        arrays, feats.transpose(0, 2, 3, 1))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w), **STAGE)


def _jax_neck(p, cfg, s1, s2, t8, t11, gh, gw):
    """The neck of J.dpt_forward, composed from its own helpers."""
    hidden = [s1, s2, J._reassemble(p, cfg, t8, 2, gh, gw),
              J._reassemble(p, cfg, t11, 3, gh, gw)]
    feats = [J._conv(h, p[f"neck.convs.{i}.weight"], 1, ((1, 1), (1, 1)))
             for i, h in enumerate(hidden)]
    fused, outs = None, []
    for i, h in enumerate(feats[::-1]):
        fused = J._fusion_layer(p, f"neck.fusion_stage.layers.{i}",
                                h if fused is None else fused,
                                None if fused is None else h)
        outs.append(fused)
    return outs


def test_neck_matches_jax(net):
    model, arrays, jcfg = net
    rng = np.random.default_rng(2)
    s1 = rng.normal(size=(1, 8, 24, 24)).astype(np.float32)
    s2 = rng.normal(size=(1, 16, 12, 12)).astype(np.float32)
    t8, t11 = (rng.normal(size=(1, 37, 16)).astype(np.float32)
               for _ in range(2))
    with torch.inference_mode():
        got = model.neck_forward(*(torch.as_tensor(a)
                                   for a in (s1, s2, t8, t11)), 6, 6)
    want = jax.jit(lambda p, *a: _jax_neck(p, jcfg, *a, 6, 6))(
        arrays, s1.transpose(0, 2, 3, 1), s2.transpose(0, 2, 3, 1), t8, t11)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), _nchw(w), err_msg=f"fusion {i}",
                                   **STAGE)


def _jax_head(p, fused):
    """The head of J.dpt_forward, composed from its own helpers."""
    h = J._conv(fused, p["head.head.0.weight"], 1, ((1, 1), (1, 1)))
    h = J._upsample2_align_corners(h + p["head.head.0.bias"])
    h = J._conv(h, p["head.head.2.weight"], 1, ((1, 1), (1, 1)))
    h = jax.nn.relu(h + p["head.head.2.bias"])
    h = J._conv(h, p["head.head.4.weight"], 1, ((0, 0), (0, 0)))
    return jax.nn.relu(h + p["head.head.4.bias"])


def test_head_matches_jax(net):
    model, arrays, _ = net
    fused = np.random.default_rng(5).normal(size=(1, 12, 48, 48)).astype(
        np.float32)
    with torch.inference_mode():
        got = model.head_forward(torch.as_tensor(fused)).numpy()
    want = _nchw(jax.jit(_jax_head)(arrays, fused.transpose(0, 2, 3, 1)))
    assert np.abs(want).max() > 0.1
    _close(got, want, **STAGE)


@pytest.mark.parametrize("hw", [(96, 96), (128, 128)],
                         ids=["trained-grid", "resized-positions"])
def test_dpt_forward_matches_jax(net, hw):
    model, arrays, jcfg = net
    img = _img(3, *hw)
    with torch.inference_mode():
        got = T.dpt_forward(model, torch.as_tensor(img)).numpy()
    want = _nchw(jax.jit(lambda p, x: J.dpt_forward(p, jcfg, x))(
        arrays, img.transpose(0, 2, 3, 1)))
    assert got.shape == (1, jcfg.out_channels) + hw
    assert np.abs(want).max() > 0.1  # not a ReLU'd-away map
    _close(got, want, **END)


def test_pos_embed_resize_matches_jax():
    pos = np.random.default_rng(4).normal(size=(1, 37, 16)).astype(
        np.float32)
    for gh, gw in ((8, 8), (4, 5), (6, 6)):
        got = T._resize_pos_embed(torch.as_tensor(pos), gh, gw).numpy()
        want = np.asarray(J._resize_pos_embed(pos, gh, gw))
        _close(got, want, **STAGE)


def test_run_normals_matches_jax():
    cfg = dataclasses.replace(T.SMALL_CONFIG, out_channels=3)
    model = T.DPTHybrid(cfg).eval()
    arrays = C.random_arrays(model, 9)
    C.params_from_numpy(model, arrays)
    rgb = np.random.default_rng(5).uniform(size=(64, 96, 3)).astype(
        np.float32)
    got = T.run_normals(model, rgb)
    want = np.asarray(jax.jit(lambda p, x: J.run_normals(p, x, _jax_cfg(
        cfg)))(arrays, rgb))
    assert got.shape == (64, 96, 3) and 0.0 <= got.min() <= got.max() <= 1.0
    _close(got, want, **END)
