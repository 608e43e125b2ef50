"""dnsplatter_torch's meshing against the JAX package's, on the CPU: marching
tetrahedra (numpy and the native library), the observed-cube filter, the
post-processing, dense and sparse TSDF fusion, Poisson (FFT and CG), the
adaptive octree, the normal-weighted fusion and the SuGaR density fields.

Tolerances:
  * marching, the filter and post-processing (the same numpy code on both
    sides, each package's own build of the same C++ source): equal;
  * dense TSDF: tsdf, weights and colours rel 1e-5, faces equal;
  * sparse TSDF: bit-equal to the dense port at a matched voxel; against the
    JAX package's sparse volume the same bricks, and weights within 1e-5 on
    all but 0.01% of the observed voxels, tsdf on all but 0.05% (measured
    on these inputs: 2 and 16 of 43,848 voxels, 0.005% and 0.036%). That
    volume's jitted update rounds some voxel centres through a fused
    multiply-add (XLA contracts two of the three coordinates), so a voxel
    a hair from a pixel boundary
    can sample the neighbouring pixel's depth, and one a hair from the
    truncation band's edge can fall on its other side; the tsdf of those
    voxels stays within one pixel's depth step over the truncation (0.25);
  * Poisson: the indicator rel 1e-4 of its largest magnitude (FFT and CG),
    meshes by vertex count within 1% and symmetric Chamfer <= 0.5 voxel;
  * the octree with one isofunc given to both: equal;
  * the normal-weighted fusion and its isofunc, the densities, SDFs, level
    surfaces and in-Gaussian samples: rel 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from dnsplatter_torch import native as tnative
from dnsplatter_torch.mesh import isofusion as tiso
from dnsplatter_torch.mesh import marching as tmarch
from dnsplatter_torch.mesh import octree as toct
from dnsplatter_torch.mesh import poisson as tpois
from dnsplatter_torch.mesh import postprocess as tpost
from dnsplatter_torch.mesh import tsdf as ttsdf
from dnsplatter_torch.mesh import tsdf_sparse as tsparse_mod
from dnsplatter_torch.mesh.tsdf_sparse import SparseTSDF as TSparse
from dnsplatter_torch.mesh.tsdf_sparse import SparseTSDFConfig as TSparseCfg
from dnsplatter_torch.models import gaussians as tg
from dnsplatter_torch.models import sugar as tsugar
from dnsplatter_torch.ops.camera import Camera as TCamera
from dnsplatter_tpu import native as jnative
from dnsplatter_tpu.mesh import isofusion as jiso
from dnsplatter_tpu.mesh import marching as jmarch
from dnsplatter_tpu.mesh import octree as joct
from dnsplatter_tpu.mesh import poisson as jpois
from dnsplatter_tpu.mesh import postprocess as jpost
from dnsplatter_tpu.mesh import tsdf as jtsdf
from dnsplatter_tpu.mesh.tsdf_sparse import SparseTSDF as JSparse
from dnsplatter_tpu.mesh.tsdf_sparse import SparseTSDFConfig as JSparseCfg
from dnsplatter_tpu.models import gaussians as jg
from dnsplatter_tpu.models import sugar as jsugar
from dnsplatter_tpu.ops.camera import Camera as JCamera
from dnsplatter_tpu.ops.camera import look_at

torch.set_num_threads(1)
RTOL = 1e-5
POISSON_RTOL = 1e-4
H = W = 64
FX = FY = 58.0
CX, CY = W / 2, H / 2
R_SPHERE = 2.0
GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0])


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _sphere_field(n=24, r=0.7):
    g = np.linspace(-1, 1, n)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sqrt(x ** 2 + y ** 2 + z ** 2) - r).astype(np.float32)


def _sphere_depth(c2w_cv):
    """z-depth of the inside of a sphere of radius R_SPHERE at the origin."""
    vv, uu = np.mgrid[0:H, 0:W]
    dirs = np.stack([(uu + 0.5 - CX) / FX, (vv + 0.5 - CY) / FY,
                     np.ones_like(uu, np.float64)], -1)
    dw = dirs @ c2w_cv[:3, :3].T
    o = c2w_cv[:3, 3]
    a = (dw * dw).sum(-1)
    b = 2 * (o * dw).sum(-1)
    c = (o * o).sum() - R_SPHERE ** 2
    t = (-b + np.sqrt(np.maximum(b * b - 4 * a * c, 0))) / (2 * a)
    return t[..., None].astype(np.float32)


def _ring(n=6):
    """(OpenGL c2w (4, 4) float32, z-depth (H, W, 1), rgb) per view."""
    out = []
    rng = np.random.default_rng(3)
    for i in range(n):
        ang = 2 * np.pi * i / n
        eye = (0.3 * np.cos(ang), 0.1, 0.3 * np.sin(ang))
        tgt = (2.5 * np.cos(ang), 0.0, 2.5 * np.sin(ang))
        c2w = np.asarray(look_at(eye, tgt), np.float32)
        depth = _sphere_depth(c2w.astype(np.float64) @ GL_TO_CV)
        out.append((c2w, depth, rng.random((H, W, 3)).astype(np.float32)))
    return out


def _chamfer(va, vb):
    return 0.5 * (cKDTree(vb).query(va)[0].mean()
                  + cKDTree(va).query(vb)[0].mean())


# -- marching and post-processing --------------------------------------------


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_marching_tetrahedra_bit_equal(backend):
    field = _sphere_field()
    if backend == "native":
        assert tnative.available(), tnative.build_error()
        assert jnative.available()
        got = tmarch.marching_tetrahedra(field, 0.0, backend="native")
        want = jmarch.marching_tetrahedra(field, 0.0, backend="native")
        assert tnative.library_path().parent.name == "_build"
    else:
        got = tmarch.marching_tetrahedra(field, 0.0, backend="numpy")
        want = jmarch.marching_tetrahedra(field, 0.0, backend="numpy")
    assert len(want[1]) > 1000
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_filter_and_postprocess_equal():
    field = _sphere_field()
    v, f = tmarch.marching_tetrahedra(field, 0.0, backend="numpy")
    observed = np.ones(field.shape, bool)
    observed[:, :, :12] = False
    for a, b in zip(tmarch.filter_faces_to_observed(v, f, observed),
                    jmarch.filter_faces_to_observed(v, f, observed)):
        np.testing.assert_array_equal(a, b)
    # two components: the sphere and a small shifted copy
    v2, f2 = tmarch.marching_tetrahedra(_sphere_field(10, 0.5), 0.0,
                                        backend="numpy")
    verts = np.concatenate([v, v2 + 40.0])
    faces = np.concatenate([f, f2 + len(v)])
    cols = np.random.default_rng(0).random((len(verts), 3)).astype(np.float32)
    for a, b in zip(tpost.cluster_connected_triangles(faces, verts),
                    jpost.cluster_connected_triangles(faces, verts)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tpost.remove_small_clusters(verts, faces, cols,
                                                keep_top=1),
                    jpost.remove_small_clusters(verts, faces, cols,
                                                keep_top=1)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tpost.filter_smooth_laplacian(verts, faces, 2),
        jpost.filter_smooth_laplacian(verts, faces, 2))
    np.testing.assert_array_equal(tpost.remove_degenerate_triangles(faces),
                                  jpost.remove_degenerate_triangles(faces))
    small_v, small_f = tmarch.marching_tetrahedra(_sphere_field(12, 0.6),
                                                  0.0, backend="numpy")
    for a, b in zip(tpost.simplify_quadric_decimation(small_v, small_f, 300),
                    jpost.simplify_quadric_decimation(small_v, small_f, 300)):
        np.testing.assert_array_equal(a, b)


# -- TSDF ---------------------------------------------------------------------


def test_dense_tsdf_matches_jax():
    cfg = dict(voxel_size=0.1, sdf_trunc=0.3)
    jv = jtsdf.create_volume([-2.5] * 3, [2.5] * 3, jtsdf.TSDFConfig(**cfg))
    tv = ttsdf.create_volume([-2.5] * 3, [2.5] * 3, ttsdf.TSDFConfig(**cfg),
                             device="cpu")
    for c2w, depth, rgb in _ring():
        jv = jtsdf.integrate(jv, depth, rgb, c2w, FX, FY, CX, CY)
        tv = ttsdf.integrate(tv, depth, rgb, c2w, FX, FY, CX, CY)
    _close(tv.tsdf, jv.tsdf)
    _close(tv.weight, jv.weight)
    _close(tv.color, jv.color)
    jm, tm = jtsdf.extract_mesh(jv), ttsdf.extract_mesh(tv)
    assert len(jm[1]) > 1000
    np.testing.assert_array_equal(tm[1], jm[1])
    _close(tm[0], jm[0])
    _close(tm[2], jm[2])
    cams = [TCamera.create(FX, FY, CX, CY, c2w, W, H, device="cpu")
            for c2w, _, _ in _ring(3)]
    jcams = [JCamera.create(FX, FY, CX, CY, c2w, W, H) for c2w, _, _ in
             _ring(3)]
    for a, b in zip(ttsdf.scene_bounds_from_cameras(cams, 4.0),
                    jtsdf.scene_bounds_from_cameras(jcams, 4.0)):
        np.testing.assert_array_equal(a, b)


def test_sparse_tsdf_matches_jax_and_dense(monkeypatch):
    # several chunks of the device update a frame
    monkeypatch.setattr(tsparse_mod, "UPDATE_BRICKS", 16)
    voxel = 0.05
    cfg = dict(voxel_size=voxel, sdf_trunc=3 * voxel)
    origin = np.array([-2.4] * 3, np.float32)
    js = JSparse(origin, JSparseCfg(**cfg))
    ts = TSparse(origin, TSparseCfg(**cfg), device="cpu")
    tv = ttsdf.create_volume(origin, origin + 4.8, ttsdf.TSDFConfig(**cfg),
                             device="cpu")
    for c2w, depth, rgb in _ring():
        js.integrate(depth, rgb, c2w, FX, FY, CX, CY)
        ts.integrate(depth, rgb, c2w, FX, FY, CX, CY)
        ttsdf.integrate(tv, depth, rgb, c2w, FX, FY, CX, CY)
    n = ts.n_slots
    assert n == js.n_slots and n > 50
    np.testing.assert_array_equal(ts.keys_np[:n], js.keys_np[:n])
    seen = (ts.weight[:n].numpy() > 0) | (np.asarray(js.weight)[:n] > 0)
    wdiff = np.abs(ts.weight[:n].numpy() - np.asarray(js.weight)[:n])[seen]
    assert (wdiff > RTOL).mean() <= 1e-4, (wdiff > RTOL).sum()
    diff = np.abs(ts.tsdf[:n].numpy() - np.asarray(js.tsdf)[:n])[seen]
    assert (diff > RTOL).mean() <= 5e-4, (diff > RTOL).sum()
    assert diff[wdiff == 0].max() <= 0.25

    # the dense port at the matched voxel: every brick voxel bit-equal
    b = ts.cfg.brick
    nx, ny, nz = tv.dims
    dense = {k: getattr(tv, k).reshape(nx, ny, nz, -1).numpy()
             for k in ("tsdf", "weight", "color")}
    for s in range(n):
        lo = ts.keys_np[s] * b
        assert (lo >= 0).all()
        hi = np.minimum(lo + b, [nx, ny, nz])
        ext = tuple(slice(0, h - l) for l, h in zip(lo, hi))
        box = tuple(slice(l, h) for l, h in zip(lo, hi))
        for k in ("tsdf", "weight", "color"):
            brick = getattr(ts, k)[s].reshape(b, b, b, -1).numpy()[ext]
            np.testing.assert_array_equal(brick, dense[k][box])
    vj, fj, _ = js.extract_mesh()
    vt, ft, _ = ts.extract_mesh()
    assert abs(len(vt) - len(vj)) <= 0.01 * len(vj)
    assert _chamfer(vt, vj) <= 0.5 * voxel


# -- Poisson -------------------------------------------------------------------


def _oriented_sphere(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = d * 0.8 + 0.01 * rng.normal(size=(n, 3))
    return pts.astype(np.float32), d.astype(np.float32)


def _jax_field(pts, nrm, res, solver):
    """The JAX package's vfield and chi, as poisson_reconstruct forms them."""
    lo, hi = pts.min(0), pts.max(0)
    ext = np.maximum(hi - lo, 1e-6)
    lo_p, hi_p = lo - 0.1 * ext, hi + 0.1 * ext
    span = hi_p - lo_p
    p01 = (pts - lo_p) / span
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-8)
    v = jpois._splat_field(jnp.asarray(p01), jnp.asarray(nrm), res)
    v = v * jnp.asarray(res / span, jnp.float32)[None, None, None, :]
    if solver == "cg":
        return v, jpois._solve_poisson_cg(v, 1.5, 0.0, 1e-5, 3 * res)
    return v, jpois._solve_poisson(v, 1.5, 0.0)


@pytest.mark.parametrize("solver,res", [("fft", 32), ("cg", 40)])
def test_poisson_matches_jax(solver, res):
    pts, nrm = _oriented_sphere()
    jv, jchi = _jax_field(pts, nrm, res, solver)
    cfg = dict(resolution=res, solver=solver)
    chi, lo_p, span, _ = tpois.poisson_field(pts, nrm,
                                             tpois.PoissonConfig(**cfg),
                                             device="cpu")
    _close(chi, jchi, POISSON_RTOL)
    if solver == "cg":
        res_t = tpois.cg_residual(torch.tensor(np.asarray(jv)), chi, 1.5,
                                  0.0)
        res_j = float(jpois.cg_residual(jv, jchi, 1.5, 0.0))
        assert res_t <= 1e-4 and res_j <= 1e-4
    vt, ft = tpois.poisson_reconstruct(pts, nrm, tpois.PoissonConfig(**cfg),
                                       device="cpu")
    vj, fj = jpois.poisson_reconstruct(pts, nrm, jpois.PoissonConfig(**cfg))
    assert abs(len(vt) - len(vj)) <= 0.01 * len(vj) and len(vj) > 1000
    voxel = float(span.max()) / (res - 1)
    assert _chamfer(vt, vj) <= 0.5 * voxel
    # the trims on the same mesh: the same numpy, the same neighbours
    for a, b in zip(tpois.trim_mesh_to_points(vj, fj, pts, 0.05),
                    jpois.trim_mesh_to_points(vj, fj, pts, 0.05)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tpois.density_quantile_cull(vj, fj, pts, 0.1),
                    jpois.density_quantile_cull(vj, fj, pts, 0.1)):
        np.testing.assert_array_equal(a, b)


# -- the octree and the normal-weighted fusion --------------------------------


def _iso_frames(n=4):
    frames = []
    for c2w, depth, _ in _ring(n):
        c2w_cv = c2w.astype(np.float64) @ GL_TO_CV
        pts = _sphere_points(depth, c2w_cv)
        # inward sphere normals, seen by a camera inside it
        nrm = -pts / np.linalg.norm(pts, axis=-1, keepdims=True)
        frames.append(dict(depth=depth, normal_w=nrm.astype(np.float32),
                           c2w_gl=c2w, fx=FX, fy=FY, cx=CX, cy=CY))
    return frames


def _sphere_points(depth, c2w_cv):
    vv, uu = np.mgrid[0:H, 0:W]
    z = depth[..., 0]
    pc = np.stack([(uu + 0.5 - CX) * z / FX, (vv + 0.5 - CY) * z / FY, z],
                  -1)
    return pc @ c2w_cv[:3, :3].T + c2w_cv[:3, 3]


def test_adaptive_isosurface_equal_for_one_isofunc():
    def sdf(p):
        return np.linalg.norm(p - 0.1, axis=-1) - 0.6

    kw = dict(coarse_res=12, levels=2)
    got = toct.adaptive_isosurface(sdf, [-1] * 3, [1] * 3, **kw)
    want = joct.adaptive_isosurface(sdf, [-1] * 3, [1] * 3, **kw)
    assert len(want[1]) > 1000
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_normal_weighted_fusion_matches_jax():
    frames = _iso_frames()
    cfg = dict(voxel_size=0.15)
    bounds = (np.array([-2.4] * 3), np.array([2.4] * 3))
    jv = jiso.fuse_normal_weighted(frames, bounds,
                                   jiso.IsoFusionConfig(**cfg))
    tv = tiso.fuse_normal_weighted(frames, bounds,
                                   tiso.IsoFusionConfig(**cfg), device="cpu")
    assert float(np.asarray(jv.weight).max()) > 1.0
    _close(tv.weight, jv.weight)
    _close(tv.tsdf, jv.tsdf)
    jm, tm = jiso.extract(jv), tiso.extract(tv)
    assert abs(len(tm[0]) - len(jm[0])) <= 0.01 * len(jm[0])
    np.testing.assert_array_equal(
        tiso.depth_validity_mask(frames[0]["depth"]),
        jiso.depth_validity_mask(frames[0]["depth"]))

    pts = np.random.default_rng(1).uniform(-2.2, 2.2, (4000, 3))
    pts[:2000] *= R_SPHERE / np.linalg.norm(pts[:2000], axis=1,
                                            keepdims=True)
    icfg = dict(voxel_size=0.05)
    got = tiso.make_isofunc(frames, tiso.IsoFusionConfig(**icfg),
                            device="cpu")(pts)
    want = jiso.make_isofunc(frames, jiso.IsoFusionConfig(**icfg))(pts)
    assert (want < 1.0).sum() > 200  # observed points
    _close(got, want)


# -- SuGaR density fields ------------------------------------------------------


def _gaussians(n=300, seed=0):
    rng = np.random.default_rng(seed)
    arrays = dict(
        means=rng.uniform(-1, 1, (n, 3)),
        scales=rng.uniform(-3.0, -1.8, (n, 3)),
        quats=rng.normal(size=(n, 4)),
        features_dc=rng.normal(size=(n, 3)) * 0.5,
        features_rest=np.zeros((n, 3, 3)),
        opacities=rng.uniform(0.0, 3.0, n),
        normals=rng.normal(size=(n, 3)),
    )
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    alive = np.ones(n, np.float32)
    alive[::7] = 0.0
    jp = jg.GaussianParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tp = tg.params_from_numpy(arrays, device="cpu")
    return jp, jnp.asarray(alive), tp, torch.as_tensor(alive), arrays


def test_sugar_density_sdf_and_samples_match_jax():
    jp, ja, tp, ta, arrays = _gaussians()
    q = np.random.default_rng(2).uniform(-1, 1, (2000, 3)).astype(np.float32)
    closest = jsugar.get_closest_gaussians(q, jp, ja)
    np.testing.assert_array_equal(tsugar.get_closest_gaussians(q, tp, ta),
                                  closest)
    for clamp in (True, False):
        _close(tsugar.get_density(q, tp, ta, closest, chunk=512,
                                  clamp=clamp),
               jsugar.get_density(jnp.asarray(q), jp, ja, closest,
                                  clamp=clamp))
    want = np.asarray(jsugar.get_sdf(jnp.asarray(q), jp, ja, closest))
    _close(tsugar.get_sdf(q, tp, ta, closest), want)
    _close(tsugar.inv_sqrt_cov3d(tp.scales, tp.quats),
           jsugar.inv_sqrt_cov3d(jp.scales, jp.quats))

    # in-Gaussian samples from shared draws: the JAX package's own
    key = jax.random.PRNGKey(4)
    jpts, jidx = jsugar.sample_points_in_gaussians(key, jp, ja, 500)
    jidx = np.asarray(jidx)
    kidx, knoise = jax.random.split(key)
    noise = np.asarray(jax.random.normal(knoise, (500, 3)))
    tpts, tidx = tsugar.sample_points_in_gaussians(None, tp, ta, 500,
                                                   draws=(jidx, noise))
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    _close(tpts, jpts)
    # the port's own draws: from live Gaussians only
    gen = torch.Generator().manual_seed(0)
    _, idx = tsugar.sample_points_in_gaussians(gen, tp, ta, 500)
    assert bool((ta[idx] > 0.5).all())


@pytest.mark.parametrize("normal", ["closest_gaussian", "analytical"])
def test_level_surface_points_match_jax(normal):
    jp, ja, tp, ta, _ = _gaussians(400, seed=5)
    c2w = np.asarray(look_at((0.3, 0.4, 3.0), (0.0, 0.0, 0.0)), np.float32)
    jcam = JCamera.create(40.0, 40.0, 24.0, 18.0, c2w, 48, 36)
    tcam = TCamera.create(40.0, 40.0, 24.0, 18.0, c2w, 48, 36, device="cpu")
    rng = np.random.default_rng(6)
    depth = rng.uniform(2.3, 3.6, (36, 48, 1)).astype(np.float32)
    depth[::5, ::3] = 0.0
    rgb = rng.random((36, 48, 3)).astype(np.float32)
    kw = dict(surface_levels=(0.1, 0.3), return_normal=normal, subsample=2)
    want = jsugar.compute_level_surface_points(jp, ja, jcam, depth, rgb, **kw)
    got = tsugar.compute_level_surface_points(tp, ta, tcam, depth, rgb, **kw)
    assert sum(len(d["points"]) for d in want.values()) > 50
    for lv in want:
        for k in ("points", "colors", "normals"):
            _close(got[lv][k], want[lv][k])
    samples = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    rendered = rng.uniform(1.0, 4.0, (36, 48, 1)).astype(np.float32)
    _close(tsugar.get_ideal_sdf(torch.as_tensor(samples),
                                torch.as_tensor(rendered), tcam),
           jsugar.get_ideal_sdf(jnp.asarray(samples), jnp.asarray(rendered),
                                jcam))
