"""dnsplatter_torch's live viewer and the Trainer's hooks into it, against
the JAX package's: the server contract (tests/test_observability.py's),
the orbit render of the same Gaussians in both trainers (rgb, depth and
normal within 1e-4 of each image's largest value: the two rasterizers
order a pixel's sums differently), a render function that raises its own
TypeError (answered 503 once, not called again without its scale), and
orbit renders fetched while steps run."""

import json
import struct
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dnsplatter_torch.data.synthetic import make_synthetic_scene
from dnsplatter_torch.models import dn_model as tdn
from dnsplatter_torch.models import gaussians as tg
from dnsplatter_torch.train import trainer as ttr
from dnsplatter_torch.utils.viewer import Viewer
from dnsplatter_tpu.models import dn_model as jdn
from dnsplatter_tpu.ops.camera import Camera as JCamera
from dnsplatter_tpu.train import trainer as jtr

torch.set_num_threads(1)
PNG = b"\x89PNG\r\n\x1a\n"
MODEL_KW = dict(sh_degree=1, warmup_length=1000, use_normal_loss=False,
                predict_normals=False)
TRAIN_KW = dict(pair_capacity=1 << 12, chunk=32, tile_block=4,
                steps_per_eval_image=0)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read()


def _png_size(b):
    assert b[:8] == PNG
    return struct.unpack(">II", b[16:24])  # (width, height)


@pytest.fixture(scope="module")
def scene():
    ts = make_synthetic_scene(seed=0, n_gaussians=200, n_cameras=2, width=48,
                              height=48, pair_capacity=1 << 12, device="cpu")
    pts, cols = ts.seed_points(np.random.default_rng(1), noise=0.03)
    return ts, pts, cols


class _JaxScene:
    """The port's scene for the JAX Trainer: its cameras as JAX Cameras,
    the same numpy batches."""

    def __init__(self, ts):
        self.cameras = [JCamera.create(float(c.fx), float(c.fy), float(c.cx),
                                       float(c.cy), c.c2w.numpy(), c.width,
                                       c.height) for c in ts.cameras]
        self.batches = ts.batches

    def __len__(self):
        return len(self.cameras)

    def get(self, i):
        return self.cameras[i], self.batches[i]


def _port_trainer(scene, **train_kw):
    ts, pts, cols = scene
    return ttr.Trainer(ts, (pts, cols),
                       model_cfg=tdn.ModelConfig(**MODEL_KW),
                       train_cfg=ttr.TrainConfig(**{**TRAIN_KW, **train_kw}),
                       device="cpu")


def test_viewer_serves_renders_and_stats():
    v = Viewer(port=0)  # ephemeral port
    try:
        rng = np.random.default_rng(0)
        v.update(stats={"loss": 0.5, "step": np.int64(7)},
                 images={"rgb": rng.uniform(size=(8, 6, 3)),
                         "depth": rng.uniform(size=(8, 6, 1))})
        base = f"http://127.0.0.1:{v.port}"
        status, page = _get(f"{base}/")
        assert status == 200 and b"viewer" in page
        stats = json.loads(_get(f"{base}/stats.json")[1])
        assert stats == {"loss": 0.5, "step": 7.0}
        assert _png_size(_get(f"{base}/rgb.png")[1]) == (6, 8)
        assert _png_size(_get(f"{base}/depth.png")[1]) == (6, 8)
        for missing in ("/normal.png", "/nothing"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(base + missing)
            assert e.value.code == 404
        # no render function registered yet: 503
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{base}/render.png?az=0")
        assert e.value.code == 503
    finally:
        v.close()


@pytest.mark.parametrize("shape", [(7, 5, 3), (7, 5, 1), (7, 5)])
def test_png_pixels_match_jax(shape):
    """The port writes its PNGs with zlib, the JAX viewer with PIL: the
    same pixels (depth maps normalized to their range)."""
    import io

    from PIL import Image

    from dnsplatter_torch.utils.viewer import _encode_png as t_encode
    from dnsplatter_tpu.utils.viewer import _encode_png as j_encode

    a = np.random.default_rng(2).uniform(-0.2, 1.2, shape)
    a.flat[3] = np.nan
    got, want = (np.asarray(Image.open(io.BytesIO(enc(a))).convert("RGB"))
                 for enc in (t_encode, j_encode))
    np.testing.assert_array_equal(got, want)


def test_render_pose_caches_and_quantizes_the_scale():
    v = Viewer(port=0)
    calls = []

    def render(az, el, r, scale):
        calls.append((az, el, r, scale))
        n = int(8 * scale)
        return {"rgb": np.full((n, n, 3), 0.5), "depth": np.ones((n, n, 1))}

    try:
        v.set_render_fn(render)
        base = f"http://127.0.0.1:{v.port}"
        assert _png_size(_get(f"{base}/render.png?az=10&scale=0.6")[1]) \
            == (4, 4)
        _get(f"{base}/render.png?az=10&scale=0.4&ch=depth")  # cached pose
        assert _png_size(_get(f"{base}/render.png?az=10&scale=1.4")[1]) \
            == (12, 12)
        assert calls == [(10.0, 20.0, 3.0, 0.5), (10.0, 20.0, 3.0, 1.5)]
    finally:
        v.close()


def test_a_typeerror_inside_the_render_is_not_retried(capfd):
    """The JAX viewer called render_fn again without `scale` on any
    TypeError, so a TypeError raised inside the render was hidden behind a
    second render. The port calls it once, answers 503 and reports it."""
    v = Viewer(port=0)
    calls = []

    def render(az, el, r, scale=1.0):
        calls.append(scale)
        raise TypeError("a fault inside the render")

    try:
        v.set_render_fn(render)
        with pytest.raises(TypeError, match="inside the render"):
            v.state.render_pose(0.0, 20.0, 3.0, "rgb", scale=1.0)
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"http://127.0.0.1:{v.port}/render.png?az=5")
        assert e.value.code == 503
        assert calls == [1.0, 1.0]
        assert "a fault inside the render" in capfd.readouterr().err
        # a render function without the scale is a fault, not a fallback
        v.set_render_fn(lambda az, el, r: {"rgb": np.zeros((4, 4, 3))})
        with pytest.raises(TypeError):
            v.state.render_pose(1.0, 20.0, 3.0, "rgb")
    finally:
        v.close()


def test_orbit_render_matches_jax(scene):
    """Under the exact `packed` keys ("auto" here): the JAX depthq sort is
    not stable and the port's is, so depthq renders of tied quantized
    depths may composite in another order."""
    ts, pts, cols = scene
    # TRAIN_KW's pair capacity holds both orbit frames (1,120 and 584
    # pairs): no audit of the training frames first
    jt = jtr.Trainer(_JaxScene(ts), (pts, cols),
                     model_cfg=jdn.ModelConfig(**MODEL_KW),
                     train_cfg=jtr.TrainConfig(**TRAIN_KW,
                                               sort_scheme="auto",
                                               auto_pair_capacity=False))
    tt = _port_trainer(scene, sort_scheme="auto", auto_pair_capacity=False)
    tt.params = tg.params_from_numpy(
        {f: np.asarray(getattr(jt.params, f)) for f in tg.FIELDS},
        device="cpu")
    tt.alive = torch.as_tensor(np.asarray(jt.alive), dtype=torch.float32)
    # one scale for both poses: the JAX render compiles once a frame size
    for az, el, r, scale in ((30.0, 20.0, 3.0, 0.75),
                             (-120.0, -15.0, 2.5, 0.75)):
        want = jt._orbit_render(az, el, r, scale=scale)
        got = tt._orbit_render(az, el, r, scale=scale)
        for k in ("rgb", "depth", "normal"):
            w = np.asarray(want[k])
            assert got[k].shape == w.shape, k
            scale_k = max(float(np.abs(w).max()), 1e-6)
            np.testing.assert_allclose(got[k], w, rtol=0,
                                       atol=1e-4 * scale_k, err_msg=k)
        assert got["rgb"].max() > 0.05  # the scene is in view


def test_orbit_renders_while_steps_run(scene, tmp_path):
    tr = ttr.Trainer(scene[0], (scene[1], scene[2]),
                     model_cfg=tdn.ModelConfig(**MODEL_KW),
                     train_cfg=ttr.TrainConfig(**{
                         **TRAIN_KW, "steps_per_eval_image": 2,
                         "viewer": True, "viewer_port": 0,
                         "tensorboard": True}),
                     out_dir=tmp_path, device="cpu")
    base = f"http://127.0.0.1:{tr.viewer.port}"
    poses = [(az, el, 3.0, s) for az, el in ((0, 20), (90, 10), (200, -10))
             for s in (0.5, 1.0, 1.5)]
    got, errors = {}, []
    started = threading.Event()

    def client():
        try:
            for az, el, r, s in poses:
                started.set()
                got[(az, el, s)] = _get(f"{base}/render.png?az={az}&el={el}"
                                        f"&r={r}&scale={s}&ch=rgb")
        except Exception as e:  # reported by the assertion below
            errors.append(e)
        finally:
            started.set()

    th = threading.Thread(target=client)
    th.start()
    started.wait(timeout=60)
    try:
        tr.train(num_steps=4, log_every=2)
        th.join(timeout=120)
        assert not th.is_alive() and not errors, errors
        for (az, el, s), (status, body) in got.items():
            assert status == 200
            assert _png_size(body) == (int(round(48 * s)) if s < 1 else 48,
                                       int(round(48 * s)) if s < 1 else 48)
        assert len({b for _, b in got.values()}) > 3  # distinct renders
        stats = json.loads(_get(f"{base}/stats.json")[1])
        assert stats["step"] == 4.0 and np.isfinite(stats["loss"])
        for ch in ("rgb", "depth"):
            assert _png_size(_get(f"{base}/{ch}.png")[1]) == (48, 48)
        assert (tmp_path / "metrics.jsonl").exists()
        assert list((tmp_path / "tb").glob("events.out.tfevents.*"))
    finally:
        tr.viewer.close()
