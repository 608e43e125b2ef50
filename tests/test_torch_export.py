"""dnsplatter_torch's mesh exporters against the JAX package's, on the CPU:
one checkpoint in the JAX package's npz layout, read by both packages'
`load_checkpoint_arrays`; a shell of Gaussians seen by four 48x48 cameras;
the same pair capacity on both sides.

Tolerances: point clouds of equal size with points, colours and normals rel
1e-4 (the two packages' renders differ at float32 rounding; colours go
through 8 bits in the PLY, one step apart at most); meshes with vertex counts
within 1% and a symmetric Chamfer distance of at most half a voxel (or grid
step) of the export; `find_depth_edges` equal. The dense route of
`isofusion` allows 2% in the counts: a voxel that one frame sees head-on
gets a weight of ~1.0 there, the extraction's `min_weight`, so rounding at
1e-7 decides whether it counts as observed (measured: vertex counts 1.6%
apart on this scene, 947 against 962, faces 0.2%; 1-1.6% even when both
packages fuse the JAX package's own renders).

The JAX exporters render at a fixed pair capacity of 2^21; the port's take
`pair_capacity` (default 2^21). `test_export_pair_capacity` shows why: a
frame of a dense scene at 1024x576 lists more pairs than 2^21, so at the
default the render drops whole Gaussians, and the capacity audited from the
scene holds them. Here the port renders at 2^15, which holds every pair of
these frames (asserted), as 2^21 does for the JAX package: where nothing
overflows, the capacity does not change a render.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from dnsplatter_torch.data import io as tio
from dnsplatter_torch.mesh import exporters as tE
from dnsplatter_torch.models.dn_model import ModelConfig as TModelConfig
from dnsplatter_torch.ops.camera import Camera as TCamera
from dnsplatter_torch.train.trainer import load_checkpoint_arrays as t_load
from dnsplatter_tpu.data import io as jio
from dnsplatter_tpu.mesh import exporters as jE
from dnsplatter_tpu.models.dn_model import ModelConfig as JModelConfig
from dnsplatter_tpu.ops.camera import Camera as JCamera
from dnsplatter_tpu.ops.camera import look_at
from dnsplatter_tpu.train.trainer import load_checkpoint_arrays as j_load

torch.set_num_threads(1)
W = H = 48
FOCAL = 50.0
N = 1500
CAPACITY = 1 << 21  # the JAX exporters' fixed capacity
PORT_CAPACITY = 1 << 15
PCD_RTOL = 1e-4
MODEL_KW = dict(sh_degree=0)


class _Frames:
    def __init__(self, cams):
        self.cams = cams

    def __len__(self):
        return len(self.cams)

    def get(self, i):
        return self.cams[i], {}


def _shell(n=N, seed=0):
    """Gaussians on the unit sphere, flattened along the outward normal."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # the quaternion taking +z to d: its smallest scale lies along d
    z = np.array([0.0, 0.0, 1.0])
    axis = np.cross(z, d)
    s = np.linalg.norm(axis, axis=1, keepdims=True)
    ang = np.arctan2(s[:, 0], d @ z)
    axis = axis / np.maximum(s, 1e-12)
    quats = np.concatenate([np.cos(ang / 2)[:, None],
                            axis * np.sin(ang / 2)[:, None]], 1)
    scales = np.log(np.stack([np.full(n, 0.09), np.full(n, 0.09),
                              np.full(n, 0.01)], 1))
    arrays = dict(means=d, scales=scales, quats=quats,
                  features_dc=rng.normal(size=(n, 3)) * 0.6,
                  features_rest=np.zeros((n, 0, 3)),
                  opacities=np.full(n, 4.0), normals=d)
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def _pair_total(params, alive, cam, capacity):
    """The (Gaussian, tile) pairs the port's binning lists for a frame."""
    from dnsplatter_torch.eval.evaluator import eval_raster_config
    from dnsplatter_torch.ops.projection import project_gaussians
    from dnsplatter_torch.ops.rasterize import bin_gaussians

    opac = torch.sigmoid(params.opacities)
    proj = project_gaussians(params.means, params.quats,
                             torch.exp(params.scales), cam.viewmat(), cam.fx,
                             cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                             opacities=opac)
    cfg = eval_raster_config(cam.width, cam.height, capacity)
    valid = (proj.valid & (alive > 0.5)).float()
    return int(bin_gaussians(cfg, proj.means2d, proj.depths, proj.radii_xy,
                             valid, conics=proj.conics,
                             opacities=opac).total_pairs)


def build_scene(tmp):
    """The checkpoint in `tmp`, both packages' parameters and cameras, and
    the JAX package's renders of the four frames."""
    arrays = _shell()
    alive = np.ones(N, np.float32)
    alive[-30:] = 0.0
    ckpt = tmp / "ckpt_000010.npz"
    np.savez(ckpt, alive=alive, step=np.asarray(10),
             **{f"params.{k}": v for k, v in arrays.items()})
    jc, tc = [], []
    for i in range(4):
        ang = 2 * np.pi * i / 4 + 0.3
        eye = (3.0 * np.cos(ang), 0.8 * (i % 2), 3.0 * np.sin(ang))
        c2w = np.asarray(look_at(eye, (0.0, 0.0, 0.0)), np.float32)
        args = (FOCAL, FOCAL, W / 2, H / 2, c2w, W, H)
        jc.append(JCamera.create(*args))
        tc.append(TCamera.create(*args, device="cpu"))
    jp, ja, step = j_load(ckpt)
    tp, ta, tstep = t_load(ckpt, device="cpu")
    assert step == tstep == 10
    for f in arrays:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)))
    for cam in tc:
        assert _pair_total(tp, ta, cam, PORT_CAPACITY) <= PORT_CAPACITY
    jd = _Frames(jc)
    renders = {id(cam): out for cam, out in jE._render_frames(
        jp, ja, jd, JModelConfig(**MODEL_KW), None)}
    return dict(tmp=tmp, jp=jp, ja=ja, tp=tp, ta=ta, jd=jd, td=_Frames(tc),
                jrenders=renders)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return build_scene(tmp_path_factory.mktemp("export"))


@pytest.fixture(autouse=True)
def jax_renders(request, monkeypatch):
    """The JAX exporters get the JAX package's own renders of the scene,
    made once: each call of its `_render_frames` compiles a new render
    function, which would take most of this file's time."""
    if "scene" not in request.fixturenames:
        return
    renders = request.getfixturevalue("scene")["jrenders"]

    def cached(params, alive, data, model_cfg, sh_degree,
               pair_capacity=PORT_CAPACITY):
        for i in range(len(data)):
            cam, _ = data.get(i)
            yield cam, renders[id(cam)]

    monkeypatch.setattr(jE, "_render_frames", cached)


def _read(path):
    return tio.read_ply(path), jio.read_ply(path)


def _close(got, want, rtol=PCD_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _same_cloud(tpath, jpath):
    got, want = tio.read_ply(tpath), jio.read_ply(jpath)
    assert sorted(got) == sorted(want)
    assert len(want["points"]) > 100
    for k in want:
        if k == "colors":  # 8-bit in the file: one step apart at most
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1 / 255 + 1e-6)
        else:
            _close(got[k], want[k])


def _same_mesh(tpath, jpath, step, count_rtol=0.01):
    got, want = tio.read_ply(tpath), jio.read_ply(jpath)
    vt, vj = got["points"], want["points"]
    assert len(want["faces"]) > 100
    assert abs(len(vt) - len(vj)) <= count_rtol * len(vj), (len(vt), len(vj))
    assert abs(len(got["faces"]) - len(want["faces"])) <= count_rtol * len(
        want["faces"])
    chamfer = 0.5 * (cKDTree(vj).query(vt)[0].mean()
                     + cKDTree(vt).query(vj)[0].mean())
    assert chamfer <= 0.5 * step, (chamfer, step)


def _dirs(scene, name):
    return scene["tmp"] / f"t_{name}", scene["tmp"] / f"j_{name}"


def _both(scene):
    return ((scene["tp"], scene["ta"], scene["td"]),
            (scene["jp"], scene["ja"], scene["jd"]))


@pytest.mark.parametrize("sparse", [False, True])
def test_export_tsdf_matches_jax(scene, sparse):
    (tp, ta, td), (jp, ja, jd) = _both(scene)
    td_, jd_ = _dirs(scene, f"tsdf_{sparse}")
    voxel = 0.05
    bounds = (np.array([-1.4] * 3), np.array([1.4] * 3))
    kw = dict(voxel_size=voxel, sdf_trunc=3 * voxel, min_weight=1.0,
              sparse=sparse, cleanup_clusters=True)
    tE.export_tsdf(tp, ta, td, td_, TModelConfig(**MODEL_KW),
                   tE.TSDFExportConfig(**kw), bounds=bounds,
                   pair_capacity=PORT_CAPACITY)
    jE.export_tsdf(jp, ja, jd, jd_, JModelConfig(**MODEL_KW),
                   jE.TSDFExportConfig(**kw), bounds=bounds)
    _same_mesh(td_ / "TSDFfusion_mesh.ply", jd_ / "TSDFfusion_mesh.ply",
               voxel)


def test_export_dn_and_gaussians_match_jax(scene):
    (tp, ta, td), (jp, ja, jd) = _both(scene)
    td_, jd_ = _dirs(scene, "dn")
    tE.export_dn(tp, ta, td, td_, TModelConfig(**MODEL_KW),
                 total_points=4000, also_tsdf=False, poisson_resolution=32,
                 pair_capacity=PORT_CAPACITY)
    jE.export_dn(jp, ja, jd, jd_, JModelConfig(**MODEL_KW),
                 total_points=4000, also_tsdf=False, poisson_resolution=32)
    _same_cloud(td_ / "DepthAndNormals_pcd.ply", jd_ / "DepthAndNormals_pcd.ply")
    pts = tio.read_ply(jd_ / "DepthAndNormals_pcd.ply")["points"]
    step = float(np.ptp(pts, 0).max()) * 1.2 / 31
    _same_mesh(td_ / "DepthAndNormals_poisson_mesh.ply",
               jd_ / "DepthAndNormals_poisson_mesh.ply", step)

    td_, jd_ = _dirs(scene, "gaussians")
    tE.export_gaussians(tp, ta, td, td_, poisson_resolution=32)
    jE.export_gaussians(jp, ja, jd, jd_, poisson_resolution=32)
    _same_cloud(td_ / "Gaussians_pcd.ply", jd_ / "Gaussians_pcd.ply")
    _same_mesh(td_ / "Gaussians_poisson_mesh.ply",
               jd_ / "Gaussians_poisson_mesh.ply", 2.4 / 31)
    # densified: the port's own draws, each sample inside a live Gaussian
    out = tE.export_gaussians(tp, ta, td, td_ / "dense", poisson_resolution=32,
                              densify_gaussians=500)
    assert len(tio.read_ply(out)["points"]) == int(
        ((ta > 0.5) & (torch.sigmoid(tp.opacities) > 0.1)).sum()) + 500


def test_export_sugar_coarse_matches_jax(scene):
    (tp, ta, td), (jp, ja, jd) = _both(scene)
    td_, jd_ = _dirs(scene, "sugar")
    kw = dict(surface_levels=(0.3,), frame_stride=1, subsample=1)
    tE.export_sugar_coarse(tp, ta, td, td_, TModelConfig(**MODEL_KW),
                           pair_capacity=PORT_CAPACITY, **kw)
    jE.export_sugar_coarse(jp, ja, jd, jd_, JModelConfig(**MODEL_KW), **kw)
    _same_cloud(td_ / "sugar_level_0.3_pcd.ply", jd_ / "sugar_level_0.3_pcd.ply")
    pts = tio.read_ply(jd_ / "sugar_level_0.3_pcd.ply")["points"]
    step = float(np.ptp(pts, 0).max()) * 1.2 / 127
    for name in ("poisson", "smoothed_1", "smoothed_2"):
        _same_mesh(td_ / f"sugar_level_0.3_{name}_mesh.ply",
                   jd_ / f"sugar_level_0.3_{name}_mesh.ply", step)


@pytest.mark.parametrize("adaptive", [True, False])
def test_export_isofusion_matches_jax(scene, adaptive):
    (tp, ta, td), (jp, ja, jd) = _both(scene)
    td_, jd_ = _dirs(scene, f"iso_{adaptive}")
    kw = dict(adaptive=adaptive, voxel_size=0.2, depth_max=4.0,
              coarse_res=24, octree_levels=2)
    tE.export_isofusion(tp, ta, td, td_, TModelConfig(**MODEL_KW),
                        pair_capacity=PORT_CAPACITY, **kw)
    jE.export_isofusion(jp, ja, jd, jd_, JModelConfig(**MODEL_KW), **kw)
    span = 2 * 4.5 + 6.0  # camera ring +- (depth_max + margin)
    step = span / (24 * 4) if adaptive else 0.2
    _same_mesh(td_ / "IsoFusion_mesh.ply", jd_ / "IsoFusion_mesh.ply", step,
               count_rtol=0.01 if adaptive else 0.02)


def test_export_marching_matches_jax(scene):
    (tp, ta, td), (jp, ja, jd) = _both(scene)
    td_, jd_ = _dirs(scene, "marching")
    tE.export_marching(tp, ta, td, td_, resolution=40)
    jE.export_marching(jp, ja, jd, jd_, resolution=40)
    _same_mesh(td_ / "MarchingCubes_mesh.ply", jd_ / "MarchingCubes_mesh.ply",
               2.2 / 39)
    got, want = _read(td_ / "MarchingCubes_mesh.ply")[0], jio.read_ply(
        jd_ / "MarchingCubes_mesh.ply")
    assert "colors" in got and "colors" in want


def test_find_depth_edges_equal():
    rng = np.random.default_rng(0)
    depth = rng.uniform(1.0, 1.02, (40, 50, 1)).astype(np.float32)
    depth[10:30, 20:35] = 2.0
    for thr, dil in ((0.01, 2), (0.05, 0), (0.5, 1)):
        np.testing.assert_array_equal(tE.find_depth_edges(depth, thr, dil),
                                      jE.find_depth_edges(depth, thr, dil))


def test_export_pair_capacity(scene):
    """At 1024x576 a frame of 4,000 large Gaussians lists more (Gaussian,
    tile) pairs than the default 2^21, so a render there drops Gaussians;
    the capacity audited from the frame holds them all. On the small scene
    the exporters' renders honour `pair_capacity`: below the frame's pairs
    the depth changes, at the default it is the JAX package's."""
    from dnsplatter_torch.models.gaussians import params_from_numpy

    assert tE.DEFAULT_PAIR_CAPACITY == CAPACITY
    rng = np.random.default_rng(1)
    n = 4000
    big = params_from_numpy(dict(
        means=rng.uniform(-1, 1, (n, 3)), scales=np.full((n, 3), -1.05),
        quats=np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)),
        features_dc=np.zeros((n, 3)), features_rest=np.zeros((n, 0, 3)),
        opacities=np.full(n, 2.2), normals=np.zeros((n, 3))), device="cpu")
    cam = TCamera.create(700.0, 700.0, 512.0, 288.0,
                         look_at((0.0, 0.0, 3.2), (0.0, 0.0, 0.0)), 1024,
                         576, device="cpu")
    alive = torch.ones(n)
    pairs = _pair_total(big, alive, cam, CAPACITY)
    assert pairs > CAPACITY
    audited = -(-pairs // 128) * 128
    assert _pair_total(big, alive, cam, audited) == pairs <= audited

    (tp, ta, td), (jp, ja, jd) = _both(scene)
    model = TModelConfig(**MODEL_KW)
    small = [out["depth"] for _, out in tE._render_frames(
        tp, ta, td, model, None, pair_capacity=1024)]
    full = [out["depth"] for _, out in tE._render_frames(
        tp, ta, td, model, None, pair_capacity=PORT_CAPACITY)]
    want = [np.asarray(scene["jrenders"][id(cam)]["depth"])
            for cam in jd.cams]
    assert any(not torch.equal(a, b) for a, b in zip(small, full))
    for got, w in zip(full, want):
        _close(got.numpy(), w)
