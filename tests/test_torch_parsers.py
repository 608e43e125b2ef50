"""dnsplatter_torch's data stack against the JAX package's on files the
tests write: PLY in both directions, the COLMAP readers, point
undistortion, pose normalization, each of the seven dataparsers, the
MuSHRoom autogeneration (normals, confidence masks, seed cloud), the
seed-cloud builders and the SDFStudio converter.

Every parser runs on its own copy of a fixture: the MuSHRoom and ScanNet++
parsers write into the capture, and a second parser on the same directory
would read what the first one made.

Tolerances: paths, splits, protocols, PLY contents and the order of every
sampled seed cloud exactly (the sampling is the same numpy code); poses,
intrinsics and scales within 1e-6; points backprojected on torch against
JAX within 1e-5 (float32 rounding of the same products); normals from
depth-gradient cross products within 1e-4 (differences of nearby float32
points); autogenerated normal maps within one 8-bit level (1/255) after
decoding, where the two packages' float32 values round to either side;
consistency masks in at most 0.1% of pixels, where an angle lies at the
20-degree threshold to float32 rounding.
"""

import json
import shutil
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from dnsplatter_torch.data import colmap_utils as tcu
from dnsplatter_torch.data import converters as tconv
from dnsplatter_torch.data import distortion as tdist
from dnsplatter_torch.data import io as tio
from dnsplatter_torch.data import pointcloud_utils as tpu
from dnsplatter_torch.data import poses as tposes
from dnsplatter_torch.data.parsers import get_parser as t_get_parser
from dnsplatter_torch.data.parsers.gsdf import GSDFParserConfig
from dnsplatter_torch.scripts import depth_normal_consistency as tdnc
from dnsplatter_torch.scripts import normals_from_depth as tnfd
from dnsplatter_tpu.data import colmap_utils as jcu
from dnsplatter_tpu.data import converters as jconv
from dnsplatter_tpu.data import distortion as jdist
from dnsplatter_tpu.data import io as jio
from dnsplatter_tpu.data import pointcloud_utils as jpu
from dnsplatter_tpu.data import poses as jposes
from dnsplatter_tpu.data.parsers import get_parser as j_get_parser
from dnsplatter_tpu.scripts import depth_normal_consistency as jdnc
from dnsplatter_tpu.scripts import normals_from_depth as jnfd

torch.set_num_threads(1)
W, H = 64, 48
FX, FY, CX, CY = 50.0, 52.0, W / 2 + 0.3, H / 2 - 0.2
POINT_TOL = 1e-5
BUILTIN_PARSERS = {"normal-nerfstudio": "normal_nerfstudio",
                   "mushroom": "mushroom", "scannetpp": "scannetpp",
                   "replica": "replica", "nrgbd": "nrgbd",
                   "coolermap": "coolermap", "gsdf": "gsdf"}


def register_builtin_parsers(mp: pytest.MonkeyPatch) -> None:
    """Both packages' seven built-in parsers under their names, until `mp`
    is undone, whatever earlier tests in the process left in the
    registries: tests/test_plugins.py restores a snapshot of the JAX
    registry, and a parser module imported during its test does not
    register again afterwards."""
    import importlib

    for pkg in ("dnsplatter_tpu", "dnsplatter_torch"):
        registry = importlib.import_module(f"{pkg}.data.parsers").PARSERS
        for name, module in BUILTIN_PARSERS.items():
            mp.setitem(registry, name, importlib.import_module(
                f"{pkg}.data.parsers.{module}").parse)


@pytest.fixture(scope="module", autouse=True)
def _builtin_parsers():
    with pytest.MonkeyPatch.context() as mp:
        register_builtin_parsers(mp)
        yield
NORMAL_TOL = 1e-4
MASK_FLIP_FRAC = 1e-3


# -- fixture writers ---------------------------------------------------------


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


def _ring(n, radius=2.0, phase=0.0):
    return [_look_at((radius * np.cos(phase + 2 * np.pi * i / n), 0.4,
                      radius * np.sin(phase + 2 * np.pi * i / n)))
            for i in range(n)]


def _depth(i, h=H, w=W):
    """A smooth metric depth map (a wavy wall)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    return (1.6 + 0.25 * np.sin(x / 9.0 + i) * np.cos(y / 11.0)
            + 0.004 * x).astype(np.float32)


def _rgb(rng, h=H, w=W):
    return rng.uniform(size=(h, w, 3)).astype(np.float32)


def _normal01(rng, h=H, w=W):
    n = rng.normal(size=(h, w, 3)) + np.array([0.0, 0.0, 3.0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return ((n + 1.0) * 0.5).astype(np.float32)


def _ply(path, rng, n=300, normals=True):
    jio.write_ply(path, rng.normal(size=(n, 3)).astype(np.float32),
                  colors=rng.uniform(size=(n, 3)).astype(np.float32),
                  normals=(rng.normal(size=(n, 3)).astype(np.float32)
                           if normals else None))


def write_nerfstudio(root: Path):
    rng = np.random.default_rng(0)
    for sub in ("images", "depth", "mono_depth", "normals_from_pretrain"):
        (root / sub).mkdir(parents=True)
    frames = []
    # names without zero padding: natural order puts frame_10 after frame_9
    for i, c2w in enumerate(_ring(12)):
        name = f"frame_{i}"
        jio.write_image(root / "images" / f"{name}.png", _rgb(rng))
        jio.write_depth_png(root / "depth" / f"{name}.png", _depth(i))
        np.save(root / "mono_depth" / f"{name}_aligned.npy", _depth(i) * 1.1)
        if i != 4:  # one prior missing
            jio.write_image(root / "normals_from_pretrain" / f"{name}.png",
                            _normal01(rng))
        fr = {"file_path": f"images/{name}.png",
              "depth_file_path": f"depth/{name}.png",
              "transform_matrix": c2w.tolist()}
        if i == 3:
            fr["fl_x"] = FX * 1.05  # a per-frame intrinsic
        frames.append(fr)
    meta = {"fl_x": FX, "fl_y": FY, "cx": CX, "cy": CY, "w": W, "h": H,
            "k1": 0.02, "p2": -1e-3, "camera_model": "OPENCV",
            "frames": frames, "ply_file_path": "sparse_pc.ply"}
    (root / "transforms.json").write_text(json.dumps(meta))
    _ply(root / "sparse_pc.ply", rng)


def write_replica(root: Path):
    rng = np.random.default_rng(1)
    res = root / "office0" / "results"
    res.mkdir(parents=True)
    (root / "office0" / "normals_from_pretrain").mkdir()
    lines = []
    for i, c2w in enumerate(_ring(7)):
        c2w_cv = c2w.copy()
        c2w_cv[:3, 1:3] *= -1  # the file holds OpenCV poses
        lines.append(" ".join(f"{v:.10f}" for v in c2w_cv.reshape(-1)))
        Image.fromarray((_rgb(rng) * 255).astype(np.uint8)).save(
            res / f"frame{i:06d}.jpg")
        jio.write_depth_png(res / f"depth{i:06d}.png", _depth(i),
                            unit=1.0 / 6553.5)
        if i % 2 == 0:
            jio.write_image(root / "office0" / "normals_from_pretrain"
                            / f"frame{i:06d}.png", _normal01(rng))
    (root / "office0" / "traj.txt").write_text("\n".join(lines) + "\n")
    (root / "cam_params.json").write_text(json.dumps({"camera": {
        "w": W, "h": H, "fx": FX, "fy": FY, "cx": CX, "cy": CY}}))


def write_nrgbd(root: Path):
    rng = np.random.default_rng(2)
    seq = root / "whiteroom"
    (seq / "images").mkdir(parents=True)
    (seq / "depth").mkdir()
    blocks, gt_blocks = [], []
    for i, c2w in enumerate(_ring(8)):
        jio.write_image(seq / "images" / f"img{i}.png", _rgb(rng))
        jio.write_depth_png(seq / "depth" / f"depth{i}.png", _depth(i))
        rows = [" ".join(f"{v:.10f}" for v in r) for r in c2w]
        blocks.append(["nan nan nan nan"] * 4 if i == 5 else rows)
        shifted = c2w.copy()
        shifted[:3, 3] += (0.1, -0.05, 0.2)
        gt_blocks.append([" ".join(f"{v:.10f}" for v in r) for r in shifted])
    for name, bl in (("trainval_poses.txt", blocks),
                     ("gt_poses.txt", gt_blocks)):
        (seq / name).write_text("\n".join(sum(bl, [])) + "\n")


def write_gsdf(root: Path):
    rng = np.random.default_rng(3)
    root.mkdir(parents=True)
    frames = []
    for i, c2w in enumerate(_ring(7)):
        m = c2w.copy()
        m[:3, 1:3] *= -1  # SDFStudio stores OpenCV
        k = np.eye(4)
        k[0, 0], k[1, 1], k[0, 2], k[1, 2] = FX, FY, CX, CY
        jio.write_image(root / f"{i:06d}_rgb.png", _rgb(rng))
        np.save(root / f"{i:06d}_depth.npy", _depth(i))
        np.save(root / f"{i:06d}_normal.npy",
                np.transpose(_normal01(rng), (2, 0, 1)))
        jio.write_image(root / f"{i:06d}_mask.png",
                        np.ones((H, W, 3), np.float32))
        frames.append({"rgb_path": f"{i:06d}_rgb.png",
                       "camtoworld": m.tolist(), "intrinsics": k.tolist(),
                       "sensor_depth_path": f"{i:06d}_depth.npy",
                       "mono_normal_path": f"{i:06d}_normal.npy",
                       "foreground_mask": f"{i:06d}_mask.png"})
    (root / "meta_data.json").write_text(json.dumps(
        {"height": H, "width": W, "frames": frames}))


def _colmap_items(c2ws, names):
    """(qvec, tvec) of COLMAP's world-to-camera for OpenGL c2ws."""
    out = []
    for c2w, name in zip(c2ws, names):
        cv = c2w.copy()
        cv[:3, 1:3] *= -1
        rot = cv[:3, :3].T
        out.append((jcu.rotmat_to_qvec(rot), -rot @ cv[:3, 3], name))
    return out


def write_colmap_bin(sparse: Path, c2ws, names, rng, model=(4, "OPENCV")):
    sparse.mkdir(parents=True)
    params = {"OPENCV": [FX, FY, CX, CY, 0.03, -0.01, 1e-3, -2e-3],
              "PINHOLE": [FX, FY, CX, CY]}[model[1]]
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, model[0], W, H))
        f.write(struct.pack(f"<{len(params)}d", *params))
    with open(sparse / "images.bin", "wb") as f:
        items = _colmap_items(c2ws, names)
        f.write(struct.pack("<Q", len(items)))
        for i, (q, t, name) in enumerate(items):
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<4d", *q))
            f.write(struct.pack("<3d", *t))
            f.write(struct.pack("<i", 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 2))  # two keypoints
            f.write(struct.pack("<ddq", 3.5, 4.5, i))
            f.write(struct.pack("<ddq", 10.0, 20.0, -1))
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", 40))
        for i in range(40):
            x, y, z = rng.normal(size=3)
            r, g, b = rng.integers(0, 256, 3)
            f.write(struct.pack("<Q3d3Bd", i, x, y, z, r, g, b, 0.5))
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<ii", 1, 0) + struct.pack("<ii", 2, 1))


def write_colmap_txt(sparse: Path, c2ws, names, rng):
    sparse.mkdir(parents=True)
    (sparse / "cameras.txt").write_text(
        f"# camera list\n1 PINHOLE {W} {H} {FX} {FY} {CX} {CY}\n")
    lines = ["# image list"]
    for i, (q, t, name) in enumerate(_colmap_items(c2ws, names)):
        lines.append(f"{i + 1} " + " ".join(f"{v:.12f}" for v in q) + " "
                     + " ".join(f"{v:.12f}" for v in t) + f" 1 {name}")
        lines.append("" if i % 2 else "3.5 4.5 1 10.0 20.0 -1")
    (sparse / "images.txt").write_text("\n".join(lines) + "\n")
    pts = ["# points"]
    for i in range(30):
        x, y, z = rng.normal(size=3)
        r, g, b = rng.integers(0, 256, 3)
        pts.append(f"{i} {x:.8f} {y:.8f} {z:.8f} {r} {g} {b} 0.5 1 0")
    (sparse / "points3D.txt").write_text("\n".join(pts) + "\n")


def write_coolermap(root: Path):
    rng = np.random.default_rng(4)
    (root / "images").mkdir(parents=True)
    (root / "mono_depth").mkdir()
    (root / "normals_from_pretrain").mkdir()
    names = [f"img_{i:03d}.png" for i in range(9)]
    for i, name in enumerate(names):
        jio.write_image(root / "images" / name, _rgb(rng))
        np.save(root / "mono_depth" / f"img_{i:03d}_aligned.npy", _depth(i))
        jio.write_image(root / "normals_from_pretrain" / name, _normal01(rng))
    write_colmap_bin(root / "colmap" / "sparse" / "0", _ring(9), names, rng)


def write_scannetpp(root: Path, mode: str = "iphone"):
    rng = np.random.default_rng(5)
    cap = root / "scene0" / mode
    images = cap / ("rgb" if mode == "iphone" else "undistorted_images")
    images.mkdir(parents=True)
    (cap / "depth").mkdir()
    names = [f"frame_{i:06d}.png" for i in range(8)]
    for i, name in enumerate(names):
        jio.write_image(images / name, _rgb(rng))
        jio.write_depth_png(cap / "depth" / name, _depth(i))
    if mode == "iphone":
        write_colmap_txt(cap / "colmap", _ring(8), names, rng)
    else:
        write_colmap_bin(cap / "colmap", _ring(8), names, rng,
                         model=(1, "PINHOLE"))
        (cap / "train_test_lists.json").write_text(json.dumps(
            {"train": names[:6], "test": names[6:]}))


def write_mushroom(root: Path, n_long=6):
    """An iphone capture with images, 16-bit depth and a test.txt only:
    the parser must make normals, masks and the seed cloud itself."""
    rng = np.random.default_rng(6)
    for capture, c2ws in (("long_capture", _ring(n_long)),
                          ("short_capture", _ring(2, phase=0.3))):
        cdir = root / "iphone" / capture
        (cdir / "images").mkdir(parents=True)
        (cdir / "depth").mkdir()
        frames = []
        for i, c2w in enumerate(c2ws):
            jio.write_image(cdir / "images" / f"{i:04d}.png", _rgb(rng))
            jio.write_depth_png(cdir / "depth" / f"{i:04d}.png",
                                _depth(i + (capture == "short_capture")))
            frames.append({"file_path": f"images/{i:04d}.png",
                           "depth_file_path": f"depth/{i:04d}.png",
                           "transform_matrix": c2w.tolist()})
        (cdir / "transformations.json").write_text(json.dumps(
            {"fl_x": FX, "fl_y": FY, "cx": CX, "cy": CY, "w": W, "h": H,
             "frames": frames}))
    (root / "iphone" / "long_capture" / "test.txt").write_text("0001\n0004\n")


# name -> (registry name, config class, writer, config keywords)
PARSER_CASES = {
    "normal-nerfstudio": ("normal-nerfstudio", "NerfstudioParserConfig",
                          write_nerfstudio, dict(train_split_fraction=0.75)),
    "replica": ("replica", "ReplicaParserConfig", write_replica,
                dict(load_every=1, skip_every_for_val_split=3,
                     num_seed_points=600)),
    "nrgbd": ("nrgbd", "NRGBDParserConfig", write_nrgbd,
              dict(load_every=1, skip_every_for_val_split=3,
                   num_seed_points=600)),
    "gsdf": ("gsdf", "GSDFParserConfig", write_gsdf,
             dict(skip_every_for_val_split=3, auto_scale_poses=True,
                  auto_orient=True)),
    "coolermap": ("coolermap", "CoolerMapParserConfig", write_coolermap,
                  dict(eval_interval=3)),
    "scannetpp-iphone": ("scannetpp", "ScannetppParserConfig",
                         write_scannetpp,
                         dict(sequence="scene0", num_init_points=1500,
                              skip_every_for_val_split=3)),
    "scannetpp-dslr": ("scannetpp", "ScannetppParserConfig",
                       lambda root: write_scannetpp(root, "dslr"),
                       dict(sequence="scene0", mode="dslr")),
    "mushroom": ("mushroom", "MushroomParserConfig", write_mushroom,
                 dict(eval_mode="all", num_init_points=1500,
                      load_depth_confidence_masks=True)),
}


def _copies(tmp_path, writer):
    """The fixture written once, then one copy for each package."""
    writer(tmp_path / "src")
    shutil.copytree(tmp_path / "src", tmp_path / "jax")
    shutil.copytree(tmp_path / "src", tmp_path / "torch")
    return tmp_path / "jax", tmp_path / "torch"


def _parse_both(name, jroot, troot, splits=("train", "test")):
    reg, cfg_name, _, kw = PARSER_CASES[name]
    jparse, tparse = j_get_parser(reg), t_get_parser(reg)
    jcfg = getattr(sys.modules[jparse.__module__], cfg_name)(data=jroot, **kw)
    tcfg = getattr(sys.modules[tparse.__module__], cfg_name)(data=troot, **kw)
    return {s: (jparse(jcfg, s), tparse(tcfg, s, device="cpu"))
            for s in splits}


FRAME_PATHS = ("image_path", "sensor_depth_path", "mono_depth_path",
               "normal_path", "confidence_path", "mask_path")


def _rel(p, root):
    return None if p is None else Path(p).relative_to(root)


def assert_same_dataset(jds, tds, jroot, troot, seed_points_exact=True):
    assert len(tds) == len(jds)
    assert tds.device == "cpu"
    for i, (jf, tf) in enumerate(zip(jds.frames, tds.frames)):
        for k in FRAME_PATHS:
            assert _rel(getattr(tf, k), troot) == _rel(getattr(jf, k),
                                                       jroot), (i, k)
        np.testing.assert_allclose(tf.c2w, jf.c2w, atol=1e-6)
        for k in ("fx", "fy", "cx", "cy"):
            np.testing.assert_allclose(getattr(tf, k), getattr(jf, k),
                                       rtol=1e-6, err_msg=k)
        assert (tf.width, tf.height, tf.camera_type) == (
            jf.width, jf.height, jf.camera_type)
        assert (tf.distortion is None) == (jf.distortion is None)
        if jf.distortion is not None:
            np.testing.assert_allclose(tf.distortion, jf.distortion,
                                       atol=1e-12)
    for k in ("depth_unit_scale_factor", "normal_format", "normal_frame",
              "euclidean_depth", "protocols"):
        assert getattr(tds, k) == getattr(jds, k), k
    np.testing.assert_allclose(tds.dataparser_scale, jds.dataparser_scale,
                               rtol=1e-6)
    for k, exact, tol in (("seed_points", seed_points_exact, POINT_TOL),
                          ("seed_colors", True, 0.0),
                          ("seed_normals", False, NORMAL_TOL)):
        a, b = getattr(tds, k), getattr(jds, k)
        assert (a is None) == (b is None), k
        if b is None:
            continue
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("name", sorted(PARSER_CASES))
def test_parser_matches_jax(tmp_path, name):
    jroot, troot = _copies(tmp_path, PARSER_CASES[name][2])
    parsed = _parse_both(name, jroot, troot)
    for split, (jds, tds) in parsed.items():
        # replica and nrgbd backproject their seeds through each package's
        # camera op; every other seed cloud is the same numpy sampling
        assert_same_dataset(jds, tds, jroot, troot,
                            seed_points_exact=name not in ("replica",
                                                           "nrgbd"))
        assert len(tds) > 0, split
    jtrain, ttrain = parsed["train"]
    assert len(ttrain) + len(parsed["test"][1]) >= 5
    tcam, tb = ttrain.get(0)
    jcam, jb = jtrain.get(0)
    assert tcam.c2w.device.type == "cpu" and (tcam.width, tcam.height) == (
        jcam.width, jcam.height)
    assert sorted(tb) == sorted(jb)
    np.testing.assert_array_equal(tb["image"], jb["image"])
    if name in ("scannetpp-iphone", "mushroom", "replica", "nrgbd"):
        assert ttrain.seed_points is not None


def test_mushroom_autogeneration_matches_jax(tmp_path):
    """Normals, consistency masks and the seed cloud, each made by its own
    package in its own copy of a capture that has none of them."""
    jroot, troot = _copies(tmp_path, write_mushroom)
    parsed = _parse_both("mushroom", jroot, troot)
    jtest, ttest = parsed["test"]
    assert ttest.protocols == ["within", "within", "with", "with"]
    for capture, n in (("long_capture", 6), ("short_capture", 2)):
        for sub in ("normals_from_depth", "depth_normals_mask"):
            tfiles = sorted((troot / "iphone" / capture / sub).glob("*.png"))
            jfiles = sorted((jroot / "iphone" / capture / sub).glob("*.png"))
            assert [f.name for f in tfiles] == [f.name for f in jfiles]
            assert len(tfiles) == n
            for tf, jf in zip(tfiles, jfiles):
                a = np.asarray(Image.open(tf)).astype(np.int16)
                b = np.asarray(Image.open(jf)).astype(np.int16)
                assert a.shape == b.shape, tf
                if sub == "normals_from_depth":
                    assert np.abs(a - b).max() <= 1, tf
                else:
                    assert set(np.unique(a)) <= {0, 255}
                    assert (a != b).mean() <= MASK_FLIP_FRAC, tf
    # the regenerated cloud: the same points in the same order, colours
    # exactly, normals from the port's depth normals
    jc = jio.read_ply(jroot / "iphone_pointcloud.ply")
    tc = tio.read_ply(troot / "iphone_pointcloud.ply")
    assert len(tc["points"]) == 1500
    np.testing.assert_array_equal(tc["points"], jc["points"])
    np.testing.assert_array_equal(tc["colors"], jc["colors"])
    np.testing.assert_allclose(tc["normals"], jc["normals"], atol=NORMAL_TOL)
    assert (np.linalg.norm(tc["normals"], axis=-1) > 0.5).mean() > 0.9
    jtrain, ttrain = parsed["train"]
    for i in range(len(ttrain)):
        _, tb = ttrain.get(i)
        _, jb = jtrain.get(i)
        assert sorted(tb) == sorted(jb) == ["confidence", "image", "normal",
                                            "sensor_depth"]
        np.testing.assert_allclose(tb["normal"], jb["normal"],
                                   atol=1.0 / 255 + 1e-6)
        assert (tb["confidence"] != jb["confidence"]).mean() <= MASK_FLIP_FRAC
        np.testing.assert_array_equal(tb["sensor_depth"], jb["sensor_depth"])
    # a second parse finds what the first one wrote and changes nothing
    again = _parse_both("mushroom", jroot, troot, splits=("train",))
    np.testing.assert_array_equal(again["train"][1].seed_points,
                                  ttrain.seed_points)


def test_unknown_parser_names_the_roadmap_item():
    # utils/plugins.py (ROADMAP.md queue A item 8) has landed: a name
    # outside the seven is looked up in the entry-point group first, and
    # only then refused with the known names
    with pytest.raises(KeyError, match="unknown dataparser 'no-such-parser'"
                       ".*mushroom"):
        t_get_parser("no-such-parser")


# -- PLY, COLMAP, distortion, poses ------------------------------------------


def _cloud(rng, n=120):
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.uniform(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


@pytest.mark.parametrize("writer_pkg", ["jax", "torch"])
def test_ply_roundtrip_across_packages(tmp_path, writer_pkg):
    rng = np.random.default_rng(7)
    pts, cols, nrm = _cloud(rng)
    faces = rng.integers(0, len(pts), (30, 3)).astype(np.int32)
    write = jio.write_ply if writer_pkg == "jax" else tio.write_ply
    write(tmp_path / "cloud.ply", pts, colors=cols, normals=nrm)
    write(tmp_path / "bare.ply", pts)
    write(tmp_path / "mesh.ply", pts, faces=faces)
    jbytes = tmp_path / "j.ply"
    jio.write_ply(jbytes, pts, colors=cols, normals=nrm)
    tio.write_ply(tmp_path / "t.ply", pts, colors=cols, normals=nrm)
    assert (tmp_path / "t.ply").read_bytes() == jbytes.read_bytes()
    for f in ("cloud.ply", "bare.ply", "mesh.ply"):
        a, b = tio.read_ply(tmp_path / f), jio.read_ply(tmp_path / f)
        assert sorted(a) == sorted(b), f
        for k in b:
            assert a[k].dtype == b[k].dtype, (f, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f} {k}")
    out = tio.read_ply(tmp_path / "cloud.ply")
    np.testing.assert_array_equal(out["points"], pts)
    np.testing.assert_array_equal(out["normals"], nrm)
    assert np.abs(out["colors"] - cols).max() <= 1.0 / 255.0
    np.testing.assert_array_equal(tio.read_ply(tmp_path / "mesh.ply")["faces"],
                                  faces)


def test_ascii_ply_and_bad_files(tmp_path):
    lines = ["ply", "format ascii 1.0", "element vertex 3",
             "property float x", "property float y", "property float z",
             "property uchar red", "property uchar green",
             "property uchar blue", "element face 1",
             "property list uchar int vertex_indices", "end_header",
             "0 0 0 255 0 0", "1 0 0 0 255 0", "0 1.5 0 0 0 255", "3 0 1 2"]
    (tmp_path / "a.ply").write_text("\n".join(lines) + "\n")
    a, b = tio.read_ply(tmp_path / "a.ply"), jio.read_ply(tmp_path / "a.ply")
    assert sorted(a) == sorted(b) == ["colors", "faces", "points"]
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(a["faces"], [[0, 1, 2]])
    (tmp_path / "b.ply").write_text("not a ply\n")
    with pytest.raises(ValueError, match="not a PLY"):
        tio.read_ply(tmp_path / "b.ply")


def _same_model(a, b):
    tcams, timgs, txyz, trgb = a
    jcams, jimgs, jxyz, jrgb = b
    assert sorted(tcams) == sorted(jcams)
    for k in jcams:
        assert tcams[k][:3] == jcams[k][:3]
        np.testing.assert_array_equal(tcams[k].params, jcams[k].params)
        assert tcu.camera_intrinsics(tcams[k]) == jcu.camera_intrinsics(
            jcams[k])
        td, tt = tcu.camera_distortion(tcams[k])
        jd, jt = jcu.camera_distortion(jcams[k])
        assert tt == jt and (td is None) == (jd is None)
        if jd is not None:
            np.testing.assert_array_equal(td, jd)
    assert sorted(timgs) == sorted(jimgs)
    for k in jimgs:
        ti, ji = timgs[k], jimgs[k]
        assert (ti.camera_id, ti.name) == (ji.camera_id, ji.name)
        for f in ("qvec", "tvec", "xys", "point3d_ids"):
            np.testing.assert_array_equal(getattr(ti, f), getattr(ji, f))
        np.testing.assert_array_equal(tcu.image_c2w_opengl(ti),
                                      jcu.image_c2w_opengl(ji))
    np.testing.assert_array_equal(txyz, jxyz)
    np.testing.assert_array_equal(trgb, jrgb)


def test_colmap_readers_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    c2ws = _ring(4)
    names = [f"im{i}.png" for i in range(4)]
    write_colmap_bin(tmp_path / "bin", c2ws, names, rng)
    write_colmap_txt(tmp_path / "txt", c2ws, names, rng)
    for sub in ("bin", "txt"):
        _same_model(tcu.read_model(tmp_path / sub),
                    jcu.read_model(tmp_path / sub))
    cams, imgs, xyz, _ = tcu.read_model(tmp_path / "bin")
    assert cams[1].model == "OPENCV" and xyz.shape == (40, 3)
    np.testing.assert_array_equal(imgs[1].point3d_ids, [0, -1])
    # the written poses come back, through the quaternion round trip
    for im, c2w in zip(sorted(imgs.values(), key=lambda m: m.name), c2ws):
        np.testing.assert_allclose(tcu.image_c2w_opengl(im), c2w, atol=1e-9)
    rng = np.random.default_rng(9)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        r = tcu.qvec_to_rotmat(q)
        np.testing.assert_array_equal(r, jcu.qvec_to_rotmat(q))
        np.testing.assert_array_equal(tcu.rotmat_to_qvec(r),
                                      jcu.rotmat_to_qvec(r))
        np.testing.assert_allclose(tcu.rotmat_to_qvec(r), q * np.sign(q[0]),
                                   atol=1e-9)


COLMAP_MODELS = {
    "SIMPLE_PINHOLE": [50.0, 32.0, 24.0],
    "PINHOLE": [50.0, 52.0, 32.0, 24.0],
    "SIMPLE_RADIAL": [50.0, 32.0, 24.0, 0.05],
    "RADIAL": [50.0, 32.0, 24.0, 0.05, -0.01],
    "OPENCV": [50.0, 52.0, 32.0, 24.0, 0.05, -0.01, 1e-3, -2e-3],
    "FULL_OPENCV": [50.0, 52.0, 32.0, 24.0, 0.05, -0.01, 1e-3, -2e-3, 0.002,
                    0.1, 0.2, 0.3],
    "OPENCV_FISHEYE": [50.0, 52.0, 32.0, 24.0, 0.05, -0.01, 0.002, 1e-4],
    "SIMPLE_RADIAL_FISHEYE": [50.0, 32.0, 24.0, 0.05],
    "RADIAL_FISHEYE": [50.0, 32.0, 24.0, 0.05, -0.01],
}


def test_colmap_distortion_and_undistort_points_match_jax():
    rng = np.random.default_rng(10)
    u = rng.uniform(0, W, 200)
    v = rng.uniform(0, H, 200)
    for model, params in COLMAP_MODELS.items():
        td, tt = tdist.colmap_distortion(model, params)
        jd, jt = jdist.colmap_distortion(model, params)
        assert tt == jt and (td is None) == (jd is None), model
        if jd is None:
            continue
        np.testing.assert_array_equal(td, jd, err_msg=model)
        tu, tv = tdist.undistort_points(u, v, 50.0, 52.0, 32.0, 24.0, td, tt)
        ju, jv = jdist.undistort_points(u, v, 50.0, 52.0, 32.0, 24.0, jd, jt)
        np.testing.assert_array_equal(tu, ju, err_msg=model)
        np.testing.assert_array_equal(tv, jv, err_msg=model)
        # the forward model takes the undistorted points back
        xd, yd = tdist.distort_normalized((tu - 32.0) / 50.0,
                                          (tv - 24.0) / 52.0, td, tt)
        np.testing.assert_allclose(xd * 50.0 + 32.0, u, atol=1e-6)
        np.testing.assert_allclose(yd * 52.0 + 24.0, v, atol=1e-6)
    for model in ("FOV", "THIN_PRISM_FISHEYE"):
        with pytest.raises(ValueError, match="unsupported"):
            tdist.colmap_distortion(model, [1.0] * 12)


def test_poses_match_jax():
    rng = np.random.default_rng(11)
    poses = np.stack(_ring(6, radius=3.0))
    poses[:, :3, 3] += rng.normal(size=(6, 3))
    for method in ("up", "none"):
        for center in ("poses", "focus", "none"):
            tp, tt = tposes.auto_orient_and_center_poses(poses, method,
                                                         center)
            jp, jt = jposes.auto_orient_and_center_poses(poses, method,
                                                         center)
            assert tp.dtype == tt.dtype == np.float32
            np.testing.assert_array_equal(tp, jp)
            np.testing.assert_array_equal(tt, jt)
    # 'up' leaves the mean up axis on +z
    tp, _ = tposes.auto_orient_and_center_poses(poses)
    up = tp[:, :3, 1].mean(0)
    np.testing.assert_allclose(up / np.linalg.norm(up), [0, 0, 1], atol=1e-6)
    for a, b in ((np.array([0.0, 0.0, 1.0]), np.array([0.0, 0.0, -1.0])),
                 (np.array([1.0, 0.0, 0.0]), np.array([-1.0, 0.0, 0.0])),
                 (rng.normal(size=3), rng.normal(size=3))):
        r = tposes.rotation_between(a, b)
        np.testing.assert_array_equal(r, jposes.rotation_between(a, b))
        np.testing.assert_allclose(r @ (a / np.linalg.norm(a)),
                                   b / np.linalg.norm(b), atol=1e-12)
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-12)
    for extra in (1.0, 0.5):
        ts, tsc = tposes.auto_scale(tp, extra)
        js, jsc = jposes.auto_scale(tp, extra)
        np.testing.assert_array_equal(ts, js)
        assert tsc == jsc
        np.testing.assert_allclose(np.abs(ts[:, :3, 3]).max(), extra,
                                   rtol=1e-6)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    _, tt = tposes.auto_orient_and_center_poses(poses)
    np.testing.assert_array_equal(
        tposes.apply_transform_to_points(pts, tt, 0.7),
        jposes.apply_transform_to_points(pts, tt, 0.7))
    with pytest.raises(ValueError):
        tposes.auto_orient_and_center_poses(poses, "pca")


# -- the parsers' helpers ------------------------------------------------------


def test_depth_normal_scripts_match_jax(tmp_path):
    depth = _depth(0)
    depth[:4, :6] = 0.0  # holes: no normal, never "bad"
    tn = tnfd.normal_image_from_depth(depth, FX, FY, CX, CY, device="cpu")
    jn = jnfd.normal_image_from_depth(depth, FX, FY, CX, CY)
    assert tn.shape == jn.shape == (H, W, 3)
    np.testing.assert_allclose(tn, jn, atol=NORMAL_TOL)
    # the same normals in the OpenCV-frame encoding the mask compares with
    mono = (tn * np.array([1.0, -1.0, -1.0])
            + np.array([0.0, 1.0, 1.0])).astype(np.float32)
    rng = np.random.default_rng(12)
    mono[20:30, 20:40] = _normal01(rng)[20:30, 20:40]  # disagreeing patch
    for thresh in (10.0, 20.0):
        tm = tdnc.consistency_mask(depth[..., None], mono, FX, FY, CX, CY,
                                   thresh, device="cpu")
        jm = jdnc.consistency_mask(depth[..., None], mono, FX, FY, CX, CY,
                                   thresh)
        assert tm.dtype == np.uint8 and tm.shape == (H, W)
        assert (tm != jm).mean() <= MASK_FLIP_FRAC
        assert (tm[20:30, 20:40] == 255).mean() > 0.5
        assert (tm[:4, :6] == 0).all()
    # the command-line tools write what the functions return
    (tmp_path / "depth").mkdir()
    jio.write_depth_png(tmp_path / "depth" / "0000.png", depth)
    args = ["--data", str(tmp_path), "--fx", str(FX), "--fy", str(FY),
            "--cx", str(CX), "--cy", str(CY), "--device", "cpu"]
    tnfd.main(args)
    tdnc.main(args)
    assert (tmp_path / "normals_from_pretrain" / "0000.png").exists()
    mask = np.asarray(Image.open(tmp_path / "depth_normals_mask"
                                 / "0000.png"))
    assert mask.shape == (H, W) and set(np.unique(mask)) <= {0, 255}


def test_seed_cloud_builders_match_jax(tmp_path):
    rng = np.random.default_rng(13)
    pts, cols, nrm = _cloud(rng, 500)
    for n in (200, 900):  # shrinking, growing
        got = tpu.resample_to_num_points(pts, cols, nrm, n, seed=3)
        want = jpu.resample_to_num_points(pts, cols, nrm, n, seed=3)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert tpu.resample_to_num_points(pts[:0], None, None, 5)[0].shape == (
        0, 3)

    write_mushroom(tmp_path / "m")
    cap = tmp_path / "m" / "iphone" / "long_capture"
    for kw in (dict(num_points=3000), dict(num_points=800, max_frames=2,
                                           voxel_dedup=0.0),
               dict(num_points=500, with_normals=False)):
        got = tpu.backproject_rgbd_cloud(cap, device="cpu", **kw)
        want = jpu.backproject_rgbd_cloud(cap, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert (got[2] is None) == (want[2] is None)
        if want[2] is not None:
            np.testing.assert_allclose(got[2], want[2], atol=NORMAL_TOL)
    # the TSDF route (mesh/tsdf.py, ROADMAP.md queue A item 9) has landed:
    # the same cloud as the JAX package's (colours through 8-bit PLY)
    tpu.generate_iphone_pointcloud(cap, tmp_path / "tt.ply", 100,
                                   use_tsdf=True, device="cpu")
    jpu.generate_iphone_pointcloud(cap, tmp_path / "jt.ply", 100,
                                   use_tsdf=True)
    a, b = tio.read_ply(tmp_path / "tt.ply"), jio.read_ply(tmp_path / "jt.ply")
    assert sorted(a) == sorted(b) and len(a["points"]) == 100
    np.testing.assert_allclose(a["points"], b["points"], rtol=0,
                               atol=1e-5 * np.abs(b["points"]).max())
    np.testing.assert_allclose(a["colors"], b["colors"], rtol=0,
                               atol=1 / 255 + 1e-6)
    with pytest.raises(FileNotFoundError):
        tpu.backproject_rgbd_cloud(tmp_path, device="cpu")

    # kinect: per-frame SpectacularAI clouds re-posed into the COLMAP frame
    (cap / "PointCloud").mkdir()
    (cap / "pose").mkdir()
    for i in range(6):
        _ply(cap / "PointCloud" / f"{i:04d}.ply", rng, n=80)
        pose = _look_at(rng.normal(size=3) * 2.0)
        np.savetxt(cap / "pose" / f"{i:04d}.txt", pose)
    tpu.generate_kinect_pointcloud(cap, tmp_path / "tk.ply", 400, seed=1)
    jpu.generate_kinect_pointcloud(cap, tmp_path / "jk.ply", 400, seed=1)
    a, b = tio.read_ply(tmp_path / "tk.ply"), jio.read_ply(tmp_path / "jk.ply")
    assert sorted(a) == sorted(b) and len(a["points"]) == 400
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_nerfstudio_to_sdfstudio_matches_jax(tmp_path):
    """The converter's meta_data.json and files, then the gsdf parser on
    its output (mirrors tests/test_offline_eval.py)."""
    write_nerfstudio(tmp_path / "src")
    outs = {}
    for pkg, conv in (("jax", jconv), ("torch", tconv)):
        out = conv.nerfstudio_to_sdfstudio(tmp_path / "src",
                                           tmp_path / pkg)
        outs[pkg] = json.loads(out.read_text())
    assert outs["torch"] == outs["jax"]
    assert len(outs["torch"]["frames"]) == 12
    m = np.array(outs["torch"]["frames"][0]["camtoworld"])
    np.testing.assert_allclose(m[:3, 1:3], -_ring(12)[0][:3, 1:3], atol=1e-9)
    for f in sorted((tmp_path / "jax").iterdir()):
        g = tmp_path / "torch" / f.name
        if f.suffix == ".npy":
            np.testing.assert_array_equal(np.load(g), np.load(f))
        elif f.suffix == ".png":
            np.testing.assert_array_equal(np.asarray(Image.open(g)),
                                          np.asarray(Image.open(f)))
    tds = t_get_parser("gsdf")(
        GSDFParserConfig(data=tmp_path / "torch", skip_every_for_val_split=3),
        "train", device="cpu")
    _, batch = tds.get(0)
    assert batch["image"].shape == (H, W, 3)
    assert batch["sensor_depth"].shape == (H, W, 1)

    write_mushroom(tmp_path / "room")
    out = tconv.mushroom_to_sdfstudio(tmp_path / "room", tmp_path / "msdf")
    assert len(json.loads(out.read_text())["frames"]) == 6
    assert not (tmp_path / "msdf" / "_tmp_transforms").exists()
    tconv.main(["nerfstudio", "--data", str(tmp_path / "src"),
                "--output-dir", str(tmp_path / "cli")])
    assert (tmp_path / "cli" / "meta_data.json").exists()
