"""dnsplatter_torch's scene dataset against the JAX package's on the same
files: every channel of every frame, through resizing, undistortion, the
euclidean-depth conversion and the normal conventions."""

import numpy as np
import pytest
import torch

from dnsplatter_torch.data import dataset as tds
from dnsplatter_torch.data import distortion as tdist
from dnsplatter_torch.data import io as tio
from dnsplatter_torch.ops.camera import euclidean_to_z_depth
from dnsplatter_tpu.data import dataset as jds
from dnsplatter_tpu.data import distortion as jdist
from dnsplatter_tpu.data import io as jio

torch.set_num_threads(1)
W, H = 40, 30


def _write_frames(tmp_path, n=3):
    """Frames on disk in the reference's formats, written by the JAX
    package's writers: rgb png, 16-bit depth png (one at another size, one
    as npy), normal png and npy, confidence, mask."""
    rng = np.random.default_rng(0)
    kw = []
    for i in range(n):
        size = (H * 2, W * 2) if i == 1 else (H, W)
        rgb = rng.uniform(size=size + (3,)).astype(np.float32)
        jio.write_image(tmp_path / f"rgb_{i}.png", rgb)
        depth = rng.uniform(0.5, 4.0, size).astype(np.float32)
        if i == 2:
            np.save(tmp_path / f"depth_{i}.npy", depth)
        else:
            jio.write_depth_png(tmp_path / f"depth_{i}.png", depth)
        np.save(tmp_path / f"mono_{i}.npy", depth * 1.1)
        normal = rng.uniform(size=size + (3,)).astype(np.float32)
        if i == 0:
            np.save(tmp_path / f"normal_{i}.npy",
                    np.transpose(normal, (2, 0, 1)))
        else:
            jio.write_image(tmp_path / f"normal_{i}.png", normal)
        np.save(tmp_path / f"conf_{i}.npy",
                rng.integers(0, 3, size).astype(np.float32))
        jio.write_image(tmp_path / f"mask_{i}.png",
                        np.repeat((rng.uniform(size=size + (1,)) > 0.3)
                                  .astype(np.float32), 3, axis=-1))
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        c2w[:3, 3] = rng.normal(size=3)
        kw.append(dict(
            image_path=tmp_path / f"rgb_{i}.png", c2w=c2w, fx=35.0 + i,
            fy=36.0, cx=W / 2 + 0.5, cy=H / 2 - 0.5, width=W, height=H,
            sensor_depth_path=tmp_path / (f"depth_{i}.npy" if i == 2
                                          else f"depth_{i}.png"),
            mono_depth_path=tmp_path / f"mono_{i}.npy",
            normal_path=tmp_path / (f"normal_{i}.npy" if i == 0
                                    else f"normal_{i}.png"),
            confidence_path=tmp_path / f"conf_{i}.npy",
            mask_path=tmp_path / f"mask_{i}.png",
            distortion=(np.array([0.1, -0.02, 0.0, 0.0, 1e-3, -2e-3])
                        if i != 1 else None),
            camera_type="fisheye" if i == 2 else "perspective"))
    return kw


@pytest.mark.parametrize("ds_kw", [
    {},
    dict(euclidean_depth=True, normal_frame="world", dataparser_scale=0.5,
         normal_format="dsine"),
])
def test_scene_dataset_matches_jax(tmp_path, ds_kw):
    kw = _write_frames(tmp_path)
    seeds = np.random.default_rng(1).normal(size=(10, 3)).astype(np.float32)
    jd = jds.SceneDataset([jds.FrameSpec(**k) for k in kw],
                          seed_points=seeds, **ds_kw)
    td = tds.SceneDataset([tds.FrameSpec(**k) for k in kw],
                          seed_points=seeds, device="cpu", **ds_kw)
    assert len(td) == len(jd) == 3
    for i in range(3):
        jcam, jb = jd.get(i)
        tcam, tb = td.get(i)
        assert sorted(tb) == sorted(jb) == [
            "confidence", "image", "mask", "mono_depth", "normal",
            "sensor_depth"]
        for k in jb:
            assert tb[k].shape == jb[k].shape, k
            assert tb[k].dtype == jb[k].dtype, k
            # the same numpy arithmetic; the euclidean conversion goes
            # through another rsqrt
            tol = 1e-6 if (k == "sensor_depth" and ds_kw) else 0.0
            np.testing.assert_allclose(tb[k], jb[k], rtol=tol, atol=tol,
                                       err_msg=f"frame {i} {k}")
        assert tb["image"].shape == (H, W, 3)
        assert tb["sensor_depth"].shape == (H, W, 1)
        np.testing.assert_array_equal(tcam.c2w.numpy(), np.asarray(jcam.c2w))
        assert (tcam.width, tcam.height) == (W, H)
        assert float(tcam.fx) == float(jcam.fx)
        assert td.get(i)[1] is tb  # cached
    for a, b in zip(td.seed(), jd.seed()):
        np.testing.assert_array_equal(a, b)
    assert tds.SceneDataset([]).seed() is None


def test_io_readers_and_distortion_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    depth = rng.uniform(0.0, 80.0, (H, W)).astype(np.float32)  # clips at 65.5
    tio.write_depth_png(tmp_path / "t.png", depth)
    jio.write_depth_png(tmp_path / "j.png", depth)
    np.testing.assert_array_equal(tio.read_depth(tmp_path / "t.png", 1e-3),
                                  jio.read_depth(tmp_path / "j.png", 1e-3))
    img = rng.uniform(size=(H, W, 3)).astype(np.float32)
    params = np.array([0.2, -0.05, 0.01, 0.0, 2e-3, -1e-3])
    for cam_type in ("perspective", "fisheye"):
        for nearest in (False, True):
            np.testing.assert_array_equal(
                tdist.undistort_image(img, 30.0, 31.0, 20.0, 15.0, params,
                                      cam_type, nearest=nearest),
                jdist.undistort_image(img, 30.0, 31.0, 20.0, 15.0, params,
                                      cam_type, nearest=nearest))
    ray = torch.as_tensor(depth[..., None])
    z = euclidean_to_z_depth(ray, 30.0, 31.0, 20.0, 15.0)
    assert z.shape == (H, W, 1) and (z <= ray + 1e-6).all()
    # the pixel nearest the principal point keeps its depth within 0.1%
    np.testing.assert_allclose(float(z[15, 20, 0]), depth[15, 20], rtol=1e-3)
