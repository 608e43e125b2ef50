"""dnsplatter_torch's prior tools that run no network, against the JAX
package's, on tiny folders written here: the HD normal merge
(`normals_hd`), depth alignment to sensor depth and to COLMAP points
(`align_depth.main`), `compare_normals`, `vis_errors` and the depth
colormap (the port's own viridis / inferno tables against matplotlib's),
and the mesh renders along a capture's cameras (`render_gt_normals`,
`render_faro_depth`; both packages' scripts drive the port's z-buffer, the
renderers themselves being held against each other in
tests/test_torch_mesh_eval.py).

Tolerances: the host numpy tools (normals_hd, align_depth,
compare_normals) exactly; colormaps within 1/255 of matplotlib (8-bit
tables), the written PNGs within 2/255 of the JAX package's (table plus the
PNG's own rounding); the mesh renders (cameras parsed by each package, in
float32): hit masks equal but for 1% of the pixels (silhouette edges),
depths within 1 mm on pixels both hit, normal PNGs within 2/255 there.
"""

import functools
import json
import shutil
from pathlib import Path

import matplotlib
import numpy as np
import pytest
import torch

from dnsplatter_torch.data import colmap_utils as tcu
from dnsplatter_torch.data import io as tio
from dnsplatter_torch.scripts import align_depth as TA
from dnsplatter_torch.scripts import compare_normals as TCN
from dnsplatter_torch.scripts import normals_hd as THD
from dnsplatter_torch.scripts import render_faro_depth as TRF
from dnsplatter_torch.scripts import render_gt_normals as TRG
from dnsplatter_torch.scripts import render_model as TRM
from dnsplatter_torch.scripts import vis_errors as TV
from dnsplatter_torch.utils.colormaps import apply_colormap
from dnsplatter_tpu.scripts import align_depth as JA
from dnsplatter_tpu.scripts import compare_normals as JCN
from dnsplatter_tpu.scripts import normals_hd as JHD
from dnsplatter_tpu.scripts import render_faro_depth as JRF
from dnsplatter_tpu.scripts import render_gt_normals as JRG
from dnsplatter_tpu.scripts import render_model as JRM
from dnsplatter_tpu.scripts import vis_errors as JV

torch.set_num_threads(1)
W, H = 40, 32
FX = FY = 36.0


def _look_at(eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """OpenGL c2w looking from `eye` at `target`."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    fwd = (target - eye) / np.linalg.norm(target - eye)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    m = np.eye(4)
    m[:3, :3] = np.stack([right, np.cross(right, fwd), -fwd], axis=-1)
    m[:3, 3] = eye
    return m


def _poses(n=4):
    return [_look_at((0.5 * np.cos(a), 0.3, 2.0 + 0.2 * np.sin(a)))
            for a in np.linspace(0, 2 * np.pi, n, endpoint=False)]


def _normal_map(rng, h, w):
    n = rng.normal(size=(h, w, 3)) + np.array([0.0, 0.0, 2.5])
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def test_normals_hd_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(300, 3))
    b = a @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T
    np.testing.assert_array_equal(THD.best_fit_rotation(a, b),
                                  JHD.best_fit_rotation(a, b))
    assert THD.patch_grid(300, 420, 128, 85) == JHD.patch_grid(300, 420, 128,
                                                               85)
    gt = _normal_map(rng, 200, 260)

    def predictor(rgb):  # normals encoded in the rgb, perturbed per patch
        n = rgb * 2.0 - 1.0
        return n + 0.05 * np.sin(rgb.sum())

    rgb = (gt + 1.0) * 0.5
    np.testing.assert_array_equal(
        THD.predict_normals_hd(rgb, predictor, patch=96),
        JHD.predict_normals_hd(rgb, predictor, patch=96))
    for pkg, run in (("t", THD.run_folder), ("j", JHD.run_folder)):
        (tmp_path / pkg / "images").mkdir(parents=True)
        tio.write_image(tmp_path / pkg / "images" / "f0.png", rgb)
        run(tmp_path / pkg / "images", tmp_path / pkg / "out", predictor,
            patch=96)
    np.testing.assert_array_equal(np.load(tmp_path / "t/out/f0.npy"),
                                  np.load(tmp_path / "j/out/f0.npy"))
    np.testing.assert_array_equal(tio.read_image(tmp_path / "t/out/f0.png"),
                                  tio.read_image(tmp_path / "j/out/f0.png"))


def _colmap_txt(sparse: Path, c2ws, names, points):
    sparse.mkdir(parents=True)
    (sparse / "cameras.txt").write_text(
        f"1 PINHOLE {W} {H} {FX} {FY} {W / 2} {H / 2}\n")
    lines = []
    for i, (c2w, name) in enumerate(zip(c2ws, names)):
        cv = c2w.copy()
        cv[:3, 1:3] *= -1
        rot = cv[:3, :3].T
        q, t = tcu.rotmat_to_qvec(rot), -rot @ cv[:3, 3]
        lines += [f"{i + 1} " + " ".join(f"{v:.12f}" for v in (*q, *t))
                  + f" 1 {name}", ""]
    (sparse / "images.txt").write_text("\n".join(lines) + "\n")
    (sparse / "points3D.txt").write_text("\n".join(
        f"{i} {x:.8f} {y:.8f} {z:.8f} 128 128 128 0.5" for i, (x, y, z)
        in enumerate(points)) + "\n")


@pytest.mark.parametrize("branch", ["sensor", "sfm"])
def test_align_depth_matches_jax(tmp_path, branch):
    rng = np.random.default_rng(1)
    root = tmp_path / "capture"
    (root / "mono_depth").mkdir(parents=True)
    (root / "depth").mkdir()
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    names = [f"frame_{i}" for i in range(3)]
    for i, name in enumerate(names):
        metric = 1.5 + 0.3 * np.sin(x / 7 + i) + 0.01 * y
        np.save(root / "mono_depth" / f"{name}.npy",
                (0.4 * metric + 0.2 + rng.normal(0, 0.01, metric.shape))
                .astype(np.float32))
        tio.write_depth_png(root / "depth" / f"{name}.png", metric)
    args = ["--data"]
    if branch == "sfm":
        # the points seen by the frames, at the depths of a plane
        pts = np.stack([rng.uniform(-0.6, 0.6, 200),
                        rng.uniform(-0.4, 0.6, 200),
                        rng.uniform(-0.2, 0.2, 200)], -1)
        _colmap_txt(root / "sparse", _poses(3)[:2],
                    [f"images/{n}.png" for n in names[:2]], pts)
        args_tail = ["--colmap-path", "sparse"]
    else:
        args_tail = []
    jroot = tmp_path / "jcapture"
    shutil.copytree(root, jroot)
    TA.main(args + [str(root)] + args_tail)
    JA.main(args + [str(jroot)] + args_tail)
    made = sorted(p.name for p in (root / "mono_depth").glob("*_aligned.npy"))
    assert made == sorted(p.name for p in
                          (jroot / "mono_depth").glob("*_aligned.npy"))
    assert len(made) == (2 if branch == "sfm" else 3)
    for name in made:
        got = np.load(root / "mono_depth" / name)
        np.testing.assert_array_equal(got, np.load(jroot / "mono_depth"
                                                   / name))
        assert not np.array_equal(got, np.load(
            root / "mono_depth" / name.replace("_aligned", "")))


def test_compare_normals_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(2)
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
    for i in range(3):
        tio.write_image(tmp_path / "a" / f"{i}.png",
                        (_normal_map(rng, H, W) + 1) * 0.5)
        tio.write_image(tmp_path / "b" / f"{i}.png",
                        (_normal_map(rng, 2 * H, 2 * W) + 1) * 0.5)
    argv = ["--dir-a", str(tmp_path / "a"), "--dir-b", str(tmp_path / "b")]
    got = TCN.main(argv)
    JCN.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and f"{got:.3f}" in out[1]
    a = rng.uniform(size=(H, W, 3))
    b = rng.uniform(size=(H, W, 3))
    assert TCN.mean_angular_error_deg(a, b) == \
        JCN.mean_angular_error_deg(a, b)
    (tmp_path / "c").mkdir()
    with pytest.raises(SystemExit, match="no matching"):
        TCN.main(["--dir-a", str(tmp_path / "a"), "--dir-b",
                  str(tmp_path / "c")])


@pytest.mark.parametrize("name", ["viridis", "inferno"])
def test_colormap_tables_match_matplotlib(name):
    x = np.concatenate([np.linspace(0, 1, 4097),
                        np.random.default_rng(3).uniform(-0.2, 1.2, 5000)])
    want = matplotlib.colormaps[name](np.clip(x, 0, 1))[..., :3]
    np.testing.assert_allclose(apply_colormap(x, name), want, rtol=0,
                               atol=1 / 255)


def test_colormap_depth_and_heatmap_match_jax():
    rng = np.random.default_rng(4)
    d = rng.uniform(0.5, 4.0, (H, W, 1)).astype(np.float32)
    d[:3] = 0.0
    for kw in ({}, {"near": 1.0, "far": 2.0}):
        np.testing.assert_allclose(TRM.colormap_depth(d, **kw),
                                   JRM.colormap_depth(d, **kw), rtol=0,
                                   atol=1 / 255)
    a, b = rng.uniform(size=(2, H, W, 3))
    np.testing.assert_allclose(TV.error_heatmap(a, b), JV.error_heatmap(a, b),
                               rtol=0, atol=1 / 255)


def test_vis_errors_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    tree = tmp_path / "renders"
    for side in ("pred", "gt"):
        for kind in ("rgb", "normal", "depth"):
            (tree / side / kind).mkdir(parents=True)
        for i in range(2):
            stem = f"{i:05d}"
            tio.write_image(tree / side / "rgb" / f"{stem}.png",
                            rng.uniform(size=(H, W, 3)))
            tio.write_image(tree / side / "normal" / f"{stem}.png",
                            rng.uniform(size=(H, W, 3)))
            np.save(tree / side / "depth" / f"{stem}.npy",
                    rng.uniform(1, 3, (H, W, 1)).astype(np.float32))
    assert TV.main(["--renders", str(tree), "--output-dir",
                    str(tmp_path / "t")]) == 6
    JV.main(["--renders", str(tree), "--output-dir", str(tmp_path / "j")])
    names = sorted(p.name for p in (tmp_path / "t").glob("*.png"))
    assert names == sorted(p.name for p in (tmp_path / "j").glob("*.png"))
    for n in names:
        np.testing.assert_allclose(tio.read_image(tmp_path / "t" / n),
                                   tio.read_image(tmp_path / "j" / n),
                                   rtol=0, atol=2 / 255 + 1e-6)


@pytest.fixture
def mesh_capture(tmp_path):
    return write_mesh_capture(tmp_path / "capture")


def write_mesh_capture(root: Path) -> Path:
    """A normal-nerfstudio capture of four views and a wavy sheet mesh in
    front of them."""
    (root / "images").mkdir(parents=True)
    rng = np.random.default_rng(6)
    frames = []
    for i, c2w in enumerate(_poses(4)):
        tio.write_image(root / "images" / f"frame_{i}.png",
                        rng.uniform(size=(H, W, 3)))
        frames.append({"file_path": f"images/frame_{i}.png",
                       "transform_matrix": c2w.tolist()})
    (root / "transforms.json").write_text(json.dumps(
        {"fl_x": FX, "fl_y": FY, "cx": W / 2, "cy": H / 2, "w": W, "h": H,
         "frames": frames}))
    n = 24
    u, v = np.meshgrid(np.linspace(-1.5, 1.5, n), np.linspace(-1.2, 1.2, n))
    verts = np.stack([u, v, 0.15 * np.sin(2 * u) * np.cos(2 * v)], -1)
    idx = np.arange(n * n).reshape(n, n)
    quads = np.stack([idx[:-1, :-1], idx[:-1, 1:], idx[1:, 1:],
                      idx[1:, :-1]], -1).reshape(-1, 4)
    faces = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
    tio.write_ply(root / "mesh.ply", verts.reshape(-1, 3).astype(np.float32),
                  faces=faces.astype(np.int32))
    return root


@pytest.fixture(scope="module", autouse=True)
def _builtin_parsers():
    """The built-in parsers registered whatever earlier tests in the
    process left (test_torch_parsers.register_builtin_parsers)."""
    from test_torch_parsers import register_builtin_parsers

    with pytest.MonkeyPatch.context() as mp:
        register_builtin_parsers(mp)
        yield


def _mesh_args(root, out, port):
    args = ["--mesh", str(root / "mesh.ply"), "--data", str(root),
            "--dataparser", "normal-nerfstudio", "--output-dir", str(out)]
    return args + ["--device", "cpu"] if port else args


@pytest.fixture
def port_zbuffer(monkeypatch):
    """The JAX scripts with the port's z-buffer renderer in place of the
    JAX package's (the two renderers are held against each other in
    tests/test_torch_mesh_eval.py; the JAX one is slow on the CPU), so
    that the scripts' own work (mesh transform, camera frame, encoding,
    names) is compared."""
    from dnsplatter_torch.eval import mesh_render as tR
    from dnsplatter_tpu.eval import mesh_render as jR

    monkeypatch.setattr(jR, "render_mesh_depth", functools.partial(
        tR.render_mesh_depth, device="cpu"))
    monkeypatch.setattr(jR, "render_mesh_attributes", functools.partial(
        tR.render_mesh_attributes, device="cpu"))


def test_render_faro_depth_matches_jax(mesh_capture, tmp_path,
                                       port_zbuffer):
    assert TRF.main(_mesh_args(mesh_capture, tmp_path / "t", True)) == 4
    JRF.main(_mesh_args(mesh_capture, tmp_path / "j", False))
    names = sorted(p.name for p in (tmp_path / "t").glob("*.png"))
    assert names == sorted(p.name for p in (tmp_path / "j").glob("*.png"))
    assert len(names) == 4
    for n in names:
        got = tio.read_depth(tmp_path / "t" / n)[..., 0]
        want = tio.read_depth(tmp_path / "j" / n)[..., 0]
        both = (got > 0) & (want > 0)
        assert both.mean() > 0.3
        assert ((got > 0) != (want > 0)).mean() <= 0.01
        assert np.abs(got - want)[both].max() <= 1.0


def test_render_gt_normals_matches_jax(mesh_capture, tmp_path,
                                       port_zbuffer):
    assert TRG.main(_mesh_args(mesh_capture, tmp_path / "t", True)) == 4
    JRG.main(_mesh_args(mesh_capture, tmp_path / "j", False))
    names = sorted(p.name for p in (tmp_path / "t").glob("*.png"))
    assert names == sorted(p.name for p in (tmp_path / "j").glob("*.png"))
    assert names == [f"frame_{i}.png" for i in range(4)]
    for n in names:
        got, want = (tio.read_image(tmp_path / d / n) for d in ("t", "j"))
        hit_t, hit_j = got.sum(-1) > 0, want.sum(-1) > 0
        assert (hit_t != hit_j).mean() <= 0.01 and hit_t.mean() > 0.3
        both = hit_t & hit_j
        np.testing.assert_allclose(got[both], want[both], rtol=0,
                                   atol=2 / 255 + 1e-6)
        # unit vectors facing the camera (+z away in OpenCV)
        vec = got[both] * 2 - 1
        assert np.abs(np.linalg.norm(vec, axis=-1) - 1).max() < 0.02
        assert (vec[:, 2] <= 1 / 255).all()
