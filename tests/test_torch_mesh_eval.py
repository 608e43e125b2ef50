"""dnsplatter_torch's mesh evaluation against the JAX package's, on the CPU:
the z-buffer depth and attribute renderers, subdivision, visibility
culling, surface sampling, the mesh metrics, the visibility-culled and the
MuSHRoom protocols, and the TSDF-fused seed cloud (`tsdf_fused_cloud`,
the MuSHRoom and ScanNet++ parsers with `seed_cloud_tsdf=True`).

Tolerances: renders equal in depth (rel 1e-5) where both hit, with hit masks
that differ in at most 0.1% of the pixels (a pixel centre on a shared edge
or a near-tie of two surfaces can go either way in float32); attributes the
same where both hit and the depth agrees; subdivision, culling and sampling
equal (the same numpy code, renders that agree); metrics and protocols rel
1e-5; the fused seed clouds of equal size with points rel 1e-5 (colours
through the parser's PLY within one 8-bit step).
"""

import shutil
import sys

import numpy as np
import pytest
import torch

from dnsplatter_torch.data import pointcloud_utils as tpu
from dnsplatter_torch.data.parsers import get_parser as t_get_parser
from dnsplatter_torch.eval import mesh_metrics as tMM
from dnsplatter_torch.eval import mesh_mushroom as tMush
from dnsplatter_torch.eval import mesh_render as tR
from dnsplatter_torch.mesh.marching import marching_tetrahedra
from dnsplatter_torch.ops.camera import Camera as TCamera
from dnsplatter_tpu.data import pointcloud_utils as jpu
from dnsplatter_tpu.data.parsers import get_parser as j_get_parser
from dnsplatter_tpu.eval import mesh_metrics as jMM
from dnsplatter_tpu.eval import mesh_mushroom as jMush
from dnsplatter_tpu.eval import mesh_render as jR
from dnsplatter_tpu.ops.camera import Camera as JCamera
from dnsplatter_tpu.ops.camera import look_at

from test_torch_parsers import register_builtin_parsers  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _builtin_parsers():
    """The built-in parsers registered whatever earlier tests in the
    process left (test_torch_parsers.register_builtin_parsers)."""
    with pytest.MonkeyPatch.context() as mp:
        register_builtin_parsers(mp)
        yield
RTOL = 1e-5
MASK_FLIP_FRAC = 1e-3
W, H = 64, 48


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _metrics_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-12,
                                   err_msg=k)


def _sphere_mesh(r=0.5, n=30, center=(0.0, 0.0, 0.0)):
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float64)
    c = (n - 1) / 2
    scale = 2.0 * r / (n / 2)
    field = np.sqrt(((g - c) ** 2).sum(0)) - (r / scale)
    v, f = marching_tetrahedra(field, 0.0, backend="numpy")
    return ((v - c) * scale + np.asarray(center)).astype(np.float32), f


def _cams(n=4, radius=2.0, width=W, height=H, focal=50.0):
    """The same ring cameras for both packages."""
    jc, tc = [], []
    for i in range(n):
        ang = 2 * np.pi * i / n
        eye = (radius * np.cos(ang), 0.4, radius * np.sin(ang))
        c2w = np.asarray(look_at(eye, (0.0, 0.0, 0.0)), np.float32)
        args = (focal, focal, width / 2, height / 2, c2w, width, height)
        jc.append(JCamera.create(*args))
        tc.append(TCamera.create(*args, device="cpu"))
    return jc, tc


def _scenes():
    """(vertices, faces, JAX camera, port camera) cases: a sphere, two
    overlapping spheres, a close wall of two large faces (the JAX package's
    no-holes case) and a tilted plane."""
    jc, tc = _cams()
    sphere = _sphere_mesh()
    a, fa = _sphere_mesh(0.4, 24, (0.2, 0.0, 0.0))
    b, fb = _sphere_mesh(0.35, 20, (-0.25, 0.1, 0.1))
    pair = (np.concatenate([a, b]), np.concatenate([fa, fb + len(a)]))
    wall = (np.array([[-2, -2, -2], [2, -2, -2], [2, 2, -2], [-2, 2, -2]],
                     np.float64), np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    tilt = (np.array([[-2, -2, -3.0], [2, -2, -3.0], [2, 2, -1.0],
                      [-2, 2, -1.0]], np.float64),
            np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    eye = (80.0, 80.0, 32.0, 32.0, np.eye(4, dtype=np.float32), 64, 64)
    out = [(*sphere, jc[i], tc[i]) for i in range(2)]
    out += [(*pair, jc[2], tc[2])]
    out += [(*m, JCamera.create(*eye), TCamera.create(*eye, device="cpu"))
            for m in (wall, tilt)]
    return out


def _hits_agree(zt, zj):
    ht, hj = np.isfinite(zt), np.isfinite(zj)
    assert (ht != hj).mean() <= MASK_FLIP_FRAC, (ht != hj).sum()
    both = ht & hj
    _close(zt[both], zj[both])
    return both


def test_render_mesh_depth_matches_jax():
    for v, f, jcam, tcam in _scenes():
        zj = jR.render_mesh_depth(v, f, jcam)
        zt = tR.render_mesh_depth(v, f, tcam, device="cpu")
        assert np.isfinite(zj).mean() > 0.05
        _hits_agree(zt, zj)
    # the wall fills its whole projection: no holes
    v, f, _, tcam = _scenes()[3]
    zt = tR.render_mesh_depth(v, f, tcam, device="cpu")
    assert np.isfinite(zt).all()
    np.testing.assert_allclose(zt, 2.0, atol=1e-3)


def test_render_mesh_attributes_matches_jax():
    for v, f, jcam, tcam in _scenes():
        vn = jR.vertex_normals(v, f)
        np.testing.assert_array_equal(tR.vertex_normals(v, f), vn)
        attrs = np.concatenate([vn, v.astype(np.float32)], 1)
        zj, aj = jR.render_mesh_attributes(v, f, attrs, jcam)
        zt, at = tR.render_mesh_attributes(v, f, attrs, tcam, device="cpu")
        both = _hits_agree(zt, zj)
        diff = np.abs(at - aj)[both].max(-1)
        scale = np.abs(aj).max()
        # a pixel that two faces of near-equal depth both pass keeps the
        # last write; everywhere else the interpolated attributes agree
        assert (diff > RTOL * scale).mean() <= MASK_FLIP_FRAC


def test_subdivide_cull_and_sample_equal():
    v, f = _sphere_mesh(0.5, 16)
    jc, tc = _cams(3)
    got = tMM.subdivide_to_edge_length(v, f, 0.05)
    want = jMM.subdivide_to_edge_length(v, f, 0.05)
    assert len(want[1]) > 4 * len(f)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    sv, sf = want
    for a, b in zip(tMM.cull_mesh(sv, sf, tc, device="cpu"),
                    jMM.cull_mesh(sv, sf, jc)):
        np.testing.assert_array_equal(a, b)
    bounds = (np.array([-1.0, -0.2, -1.0]), np.array([1.0, 1.0, 1.0]))
    for a, b in zip(tMM.cull_mesh(sv, sf, tc, bounds=bounds, device="cpu"),
                    jMM.cull_mesh(sv, sf, jc, bounds=bounds)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tMM.sample_surface(sv, sf, 500, seed=3),
                    jMM.sample_surface(sv, sf, 500, seed=3)):
        np.testing.assert_array_equal(a, b)
    keep = np.arange(len(sf)) % 3 > 0
    for a, b in zip(tMM.compact_mesh(sv, sf, keep),
                    jMM.compact_mesh(sv, sf, keep)):
        np.testing.assert_array_equal(a, b)


def test_mesh_metrics_and_protocols_match_jax(tmp_path):
    pred = _sphere_mesh(0.5, 22)
    gt = _sphere_mesh(0.52, 26, (0.02, 0.0, -0.01))
    jc, tc = _cams(4)
    _metrics_close(tMM.compute_metrics(*pred, *gt, num_samples=3000),
                   jMM.compute_metrics(*pred, *gt, num_samples=3000))
    kw = dict(max_edge=0.04, num_samples=3000)
    _metrics_close(tMM.evaluate_mesh(*pred, *gt, tc, device="cpu", **kw),
                   jMM.evaluate_mesh(*pred, *gt, jc, **kw))
    # MuSHRoom: footprint cut, go-surf culling with sensor depths (some
    # missing), the registration given, from a json, and by ICP
    depths = [np.array(jR.render_mesh_depth(*gt, c)) for c in jc]
    for d in depths:
        d[np.isinf(d)] = 0.0
        d[::4, ::5] = 0.0
    kw = dict(gt_depths=depths, max_edge=0.04, num_samples=3000,
              obs_threshold=1)
    shift = np.eye(4)
    shift[:3, 3] = (0.01, -0.02, 0.0)
    from dnsplatter_torch.eval.icp import save_icp_json

    save_icp_json(tmp_path / "icp_iphone.json", shift)
    for extra in (dict(icp_transform=shift),
                  dict(icp_json=tmp_path / "icp_iphone.json"), {}):
        _metrics_close(
            tMush.evaluate_mesh_mushroom(*pred, *gt, tc, device="cpu",
                                         **kw, **extra),
            jMush.evaluate_mesh_mushroom(*pred, *gt, jc, **kw, **extra))
    for a, b in zip(tMush.cut_mesh(gt[0], *pred, kernel_size=5),
                    jMush.cut_mesh(gt[0], *pred, kernel_size=5)):
        np.testing.assert_array_equal(a, b)


# -- the TSDF-fused seed cloud -------------------------------------------------


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    from test_torch_mushroom_slice import write_capture

    tmp = tmp_path_factory.mktemp("mushroom_tsdf")
    write_capture(tmp / "src")
    for pkg in ("jax", "torch"):
        shutil.copytree(tmp / "src", tmp / pkg)
    return tmp


def test_tsdf_fused_cloud_matches_jax(capture):
    cap = capture / "src" / "iphone" / "long_capture"
    kw = dict(num_points=3000, resolution_cap=64)
    got = tpu.tsdf_fused_cloud(cap, device="cpu", **kw)
    want = jpu.tsdf_fused_cloud(cap, **kw)
    assert got[0].shape == want[0].shape == (3000, 3)
    for a, b in zip(got, want):
        _close(a, b)
    with pytest.raises(FileNotFoundError):
        tpu.tsdf_fused_cloud(capture, device="cpu", **kw)


@pytest.mark.parametrize("name", ["mushroom", "scannetpp"])
def test_parser_tsdf_seed_cloud_matches_jax(capture, tmp_path, name):
    if name == "mushroom":
        jroot, troot = capture / "jax", capture / "torch"
        kw = dict(num_init_points=2000, seed_cloud_tsdf=True)
    else:
        from test_torch_parsers import write_scannetpp

        write_scannetpp(tmp_path / "src")
        jroot, troot = tmp_path / "jax", tmp_path / "torch"
        for root in (jroot, troot):
            shutil.copytree(tmp_path / "src", root)
        kw = dict(sequence="scene0", num_init_points=2000,
                  skip_every_for_val_split=3, seed_cloud_tsdf=True)
    cfg_name = ("MushroomParserConfig" if name == "mushroom"
                else "ScannetppParserConfig")
    jparse, tparse = j_get_parser(name), t_get_parser(name)
    jtrain = jparse(getattr(sys.modules[jparse.__module__], cfg_name)(
        data=jroot, **kw), "train")
    ttrain = tparse(getattr(sys.modules[tparse.__module__], cfg_name)(
        data=troot, **kw), "train", device="cpu")
    assert ttrain.seed_points.shape == jtrain.seed_points.shape == (2000, 3)
    _close(ttrain.seed_points, jtrain.seed_points)
    # the cloud goes through a PLY with 8-bit colours: a colour within
    # rounding of a step's midpoint may land one step apart
    np.testing.assert_allclose(ttrain.seed_colors, jtrain.seed_colors,
                               rtol=0, atol=1 / 255 + 1e-6)


def test_render_mesh_depth_face_near_the_camera():
    """A face a few millimetres in front of the camera, far wider than the
    image: the JAX package splits it whole (up to 4^12 pieces, most off the
    image); the port keeps only the pieces that reach the image, and the
    depth is the same."""
    eye = (60.0, 60.0, 32.0, 24.0, np.eye(4, dtype=np.float32), 64, 48)
    jcam, tcam = JCamera.create(*eye), TCamera.create(*eye, device="cpu")
    # OpenGL camera looks down -z: a slanted sliver from z = -0.004 to -2
    v = np.array([[-0.3, -0.2, -0.004], [0.5, -0.1, -2.0],
                  [-0.2, 0.6, -1.5], [-2, -2, -2.5], [2, -2, -2.5],
                  [0, 2, -2.5]], np.float64)
    f = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    zj = jR.render_mesh_depth(v, f, jcam)
    zt = tR.render_mesh_depth(v, f, tcam, device="cpu")
    _hits_agree(zt, zj)
    assert np.isfinite(zt).mean() > 0.5
    tri = tR._camera_space(v, tcam)[f]
    kept, _, _ = tR._split_large(tri, tcam)
    whole = jR._screen_extent(tri, *tR._intrinsics(tcam))
    assert whole.max() > 2000  # the JAX package splits this face 5+ times
    assert len(kept) < 400
