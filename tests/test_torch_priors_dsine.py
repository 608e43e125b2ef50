"""dnsplatter_torch's EfficientNet-B5 encoder and DSINE against the JAX
package's functions, on the CPU, with the same random weights: numpy
arrays drawn for every key of the port module's `state_dict()`
(`common.random_arrays`), loaded strictly into the module and passed as the
JAX parameter dict. B5 at its published widths, DSINE's decoder narrowed
(bottleneck 64), images 64x96.

Tolerances: each stage (the B5 taps, the decoder's three outputs, the NRN
iteration's hidden state, the layers) rtol 1e-4 / atol 1e-5; DSINE's normal
maps (unit vectors: the NRN iteration's two, every stage of the forward,
`predict_normals`) within 1e-4 absolute. The JAX graphs run under jax.jit (the same XLA ops the eager
package runs, compiled once).
"""

import jax
import numpy as np
import pytest
import torch

from dnsplatter_torch.priors import common as C
from dnsplatter_torch.priors import dsine as TD
from dnsplatter_torch.priors import efficientnet as TE
from dnsplatter_tpu.priors import dsine as JD
from dnsplatter_tpu.priors import efficientnet as JE

torch.set_num_threads(1)
H, W = 64, 96
WIDTHS = dict(nf=64, feature_dim=16, hidden_dim=16, head_hidden=32,
              nrn_hidden=16)
STAGE = dict(rtol=1e-4, atol=1e-5)
K = np.array([[[80.0, 0, 47.5], [0, 80.0, 31.5], [0, 0, 1]]], np.float32)


@pytest.fixture(scope="module")
def net():
    """(port DSINE with loaded weights, the same weights as arrays)."""
    model = TD.DSINE(**WIDTHS).eval()
    arrays = C.random_arrays(model, 5)
    C.params_from_numpy(model, arrays)
    return model, arrays


@pytest.fixture(scope="module")
def jax_forward():
    return jax.jit(JD.dsine_forward, static_argnames="num_iter")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def test_b5_state_dict_is_the_param_shapes():
    got = {"encoder.original_model." + k: tuple(v.shape)
           for k, v in TE.EfficientNetB5().state_dict().items()}
    assert got == JE.b5_param_shapes()
    assert TE.b5_param_shapes() == JE.b5_param_shapes()
    full = {k: tuple(v.shape) for k, v in TD.DSINE().state_dict().items()
            if k.startswith("encoder.")}
    assert full == JE.b5_param_shapes()


@pytest.mark.parametrize("k,stride,size", [(3, 2, (11, 13)), (5, 2, (12, 9)),
                                           (3, 1, (7, 8)), (5, 1, (6, 6))])
def test_tf_same_conv_matches_jax(k, stride, size):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.normal(size=(1, 5) + size).astype(np.float32)
    w = rng.normal(size=(7, 5, k, k)).astype(np.float32)
    conv = TE.Conv2dSame(5, 7, k, stride, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.as_tensor(w))
        got = conv(torch.as_tensor(x)).numpy()
    want = JE._conv(x.transpose(0, 2, 3, 1), w, stride)
    np.testing.assert_allclose(got, _np(want).transpose(0, 3, 1, 2), **STAGE)


def test_b5_taps_match_jax(net):
    model, arrays = net
    img = np.random.default_rng(0).normal(size=(1, 3, H, W)).astype(
        np.float32)
    with torch.inference_mode():
        got = TE.encoder_features(model, torch.as_tensor(img))
    want = jax.jit(JE.encoder_features)(arrays, img)
    assert [tuple(g.shape) for g in got] == [
        (1, 24, 32, 48), (1, 40, 16, 24), (1, 64, 8, 12), (1, 176, 4, 6),
        (1, 2048, 2, 3)]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), _np(w), err_msg=f"tap {i}",
                                   **STAGE)


def _layer_cases():
    """(name, port callable, JAX callable) on the same random inputs."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 5, 7)).astype(np.float32)
    skip = rng.normal(size=(2, 6, 10, 14)).astype(np.float32)
    up = TD.UpSampleGN(22, 16).eval()
    up_a = C.random_arrays(up, 2)
    C.params_from_numpy(up, up_a)
    h = rng.normal(size=(2, 8, 9, 11)).astype(np.float32)
    xi = rng.normal(size=(2, 6, 9, 11)).astype(np.float32)
    gru = TD.ConvGRU(8, 6).eval()
    gru_a = C.random_arrays(gru, 3)
    C.params_from_numpy(gru, gru_a)
    head = TD.prediction_head(10, 16, 7).eval()
    head_a = C.random_arrays(head, 4)
    C.params_from_numpy(head, head_a)
    xh = rng.normal(size=(2, 10, 6, 9)).astype(np.float32)
    n = rng.normal(size=(2, 3, 6, 8)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    ray = rng.normal(size=(2, 3, 6, 8)).astype(np.float32)
    ray /= np.linalg.norm(ray, axis=1, keepdims=True)
    xs = rng.normal(size=(2, 3, 6, 7)).astype(np.float32)
    mask = rng.normal(size=(2, 9 * 64, 6, 7)).astype(np.float32)
    aa = (rng.normal(size=(50, 3)) * 2.0).astype(np.float32)
    aa[:5] *= 1e-8  # the small-angle branch
    t = torch.as_tensor
    return [
        ("upsample_gn", lambda: up(t(x), t(skip)),
         lambda: JD._upsample_gn({"u." + k: v for k, v in up_a.items()},
                                 "u", x, skip)),
        ("conv_gru", lambda: gru(t(h), t(xi)),
         lambda: JD._conv_gru({"gru." + k: v for k, v in gru_a.items()},
                              h, xi)),
        ("prediction_head", lambda: head(t(xh)),
         lambda: JD._prediction_head({"h." + k: v
                                      for k, v in head_a.items()},
                                     "h", xh)),
        ("ray_relu", lambda: TD._ray_relu(t(n), t(ray)),
         lambda: JD._ray_relu(n, ray)),
        ("unfold", lambda: TD._unfold_replicate(t(xs), 5),
         lambda: JD._unfold_replicate(xs, 5)),
        ("convex_upsample", lambda: TD._convex_upsample(t(xs), t(mask), 8),
         lambda: JD._convex_upsample(xs, mask, 8)),
        ("axis_angle", lambda: TD._axis_angle_to_matrix(t(aa)),
         lambda: JD._axis_angle_to_matrix(aa)),
        ("get_ray", lambda: TD._get_ray(t(K), 8, 12, H, W),
         lambda: JD._get_ray(K, 8, 12, H, W)),
    ]


@pytest.mark.parametrize("case", range(8))
def test_dsine_layers_match_jax(case):
    name, port, ref = _layer_cases()[case]
    with torch.inference_mode():
        got = port().numpy()
    np.testing.assert_allclose(got, _np(ref()), err_msg=name, **STAGE)


def _fake_taps(b=1):
    rng = np.random.default_rng(2)
    return [rng.normal(size=(b, c, H // d, W // d)).astype(np.float32)
            for c, d in zip(TD.B5_TAPS, (2, 4, 8, 16, 32))]


def test_decoder_matches_jax(net):
    model, arrays = net
    taps = _fake_taps(2)
    intr = np.repeat(K, 2, axis=0)
    uvs = [JD._get_ray(intr, H // d, W // d, H, W, True) for d in (32, 16, 8)]
    with torch.inference_mode():
        got = model.decoder([torch.as_tensor(f) for f in taps],
                            [torch.as_tensor(np.array(u)) for u in uvs])
    want = jax.jit(JD._decoder)(arrays, taps, uvs)
    for name, g, w in zip(("normal", "feature", "hidden"), got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), err_msg=name, **STAGE)


def test_refine_iteration_matches_jax(net):
    model, arrays = net
    rng = np.random.default_rng(3)
    hh, ww = H // 8, W // 8
    h = rng.normal(size=(1, 16, hh, ww)).astype(np.float32)
    feat = rng.normal(size=(1, 18, hh, ww)).astype(np.float32)
    pred = rng.normal(size=(1, 3, hh, ww)).astype(np.float32)
    pred /= np.linalg.norm(pred, axis=1, keepdims=True)
    intr = K.copy()
    intr[:, :2, 2] += 0.5
    uv_8 = np.array(JD._get_ray(intr, hh, ww, H, W, True))
    ray_8 = np.array(JD._get_ray(intr, hh, ww, H, W))
    with torch.inference_mode():
        got = model.refine(*(torch.as_tensor(a) for a in (h, feat, pred,
                                                          intr)), H, W,
                           torch.as_tensor(uv_8), torch.as_tensor(ray_8))
    want = jax.jit(JD._refine, static_argnums=(5, 6))(
        arrays, h, feat, pred, intr, H, W, uv_8, ray_8)
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]),
                               err_msg="hidden", **STAGE)
    # the two normal maps: unit vectors, within 1e-4
    for name, g, w in zip(("coarse", "upsampled"), got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=0, atol=1e-4,
                                   err_msg=name)


def test_dsine_forward_matches_jax(net, jax_forward):
    model, arrays = net
    img = np.random.default_rng(4).normal(size=(1, 3, H, W)).astype(
        np.float32)
    with torch.inference_mode():
        got = TD.dsine_forward(model, torch.as_tensor(img),
                               torch.as_tensor(K))
    want = jax_forward(arrays, img, K, num_iter=TD.NUM_ITER)
    assert len(got) == len(want) == TD.NUM_ITER + 1
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=0, atol=1e-4,
                                   err_msg=f"stage {i}")
        np.testing.assert_allclose(np.linalg.norm(g.numpy(), axis=1), 1.0,
                                   atol=1e-5)


@pytest.mark.parametrize("with_k", [False, True])
def test_predict_normals_matches_jax(net, jax_forward, monkeypatch, with_k):
    model, arrays = net
    rng = np.random.default_rng(6)
    rgb = rng.integers(0, 256, (50, 70, 3)).astype(np.uint8)
    k = np.array([[60.0, 0, 33.0], [0, 61.0, 24.5], [0, 0, 1]], np.float32)
    monkeypatch.setattr(JD, "dsine_forward", lambda p, i, k: jax_forward(
        p, i, k, num_iter=TD.NUM_ITER))
    got = TD.predict_normals(model, rgb, K=k if with_k else None)
    want = JD.predict_normals(arrays, rgb, K=k if with_k else None)
    assert got.shape == (50, 70, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("hw", [(50, 70), (64, 96), (33, 1), (480, 640)])
def test_pad_input_and_fov_intrinsics_match_jax(hw):
    assert TD.pad_input(*hw) == JD.pad_input(*hw)
    np.testing.assert_array_equal(TD.intrins_from_fov(60.0, *hw),
                                  JD.intrins_from_fov(60.0, *hw))


def test_normals_from_pretrain_dsine_matches_jax(net, jax_forward, tmp_path,
                                                 monkeypatch):
    """`normals_from_pretrain --model-type dsine` over a folder, the
    weights an npz written here (the narrow widths read from it), against
    the JAX package's `run_dsine_normals`: PNGs within 1/255 (8-bit
    rounding of normals that agree to 1e-4)."""
    from dnsplatter_torch.data import io as tio
    from dnsplatter_torch.scripts import normals_from_pretrain as TNP
    from dnsplatter_tpu.scripts import normals_from_pretrain as JNP

    model, arrays = net
    (tmp_path / "images").mkdir()
    rng = np.random.default_rng(7)
    tio.write_image(tmp_path / "images" / "frame_0.png",
                    rng.uniform(size=(50, 70, 3)))
    np.savez(tmp_path / "dsine.npz", **arrays)
    monkeypatch.setattr(JD, "dsine_forward", lambda p, i, k: jax_forward(
        p, i, k, num_iter=TD.NUM_ITER))
    assert TNP.main(["--data", str(tmp_path), "--ckpt",
                     str(tmp_path / "dsine.npz"), "--device", "cpu",
                     "--model-type", "dsine"]) == 1
    JNP.run_dsine_normals(tmp_path / "images", tmp_path / "j",
                          tmp_path / "dsine.npz")
    got = tio.read_image(tmp_path / "normals_from_pretrain" / "frame_0.png")
    want = tio.read_image(tmp_path / "j" / "frame_0.png")
    assert got.shape == (50, 70, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1 / 255 + 1e-6)
    vec = got * 2 - 1
    assert np.abs(np.linalg.norm(vec, axis=-1) - 1).max() < 0.02
