"""Dataset format converters (counterpart of
dnsplatter_tpu/data/converters.py): a nerfstudio transforms.json capture or
a MuSHRoom long capture -> the SDFStudio meta_data.json layout the gsdf
dataparser reads, depth and normal priors carried along.

    python -m dnsplatter_torch.data.converters nerfstudio \
        --data CAPTURE --output-dir OUT
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import numpy as np

from dnsplatter_torch.data import io


def nerfstudio_to_sdfstudio(data_dir: Path, out_dir: Path,
                            scene_scale: float = 1.0) -> Path:
    """transforms.json -> meta_data.json (OpenGL c2w -> OpenCV
    camtoworld); returns the json's path."""
    data_dir, out_dir = Path(data_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    meta = json.loads((data_dir / "transforms.json").read_text())
    frames_out = []
    w, h = meta.get("w"), meta.get("h")
    for i, fr in enumerate(sorted(meta["frames"],
                                  key=lambda f: f["file_path"])):
        src = data_dir / fr["file_path"]
        if not src.exists():
            continue
        dst = out_dir / f"{i:06d}_rgb{src.suffix}"
        shutil.copy2(src, dst)
        m = np.array(fr["transform_matrix"], np.float64)
        if m.shape == (3, 4):
            m = np.concatenate([m, [[0, 0, 0, 1]]], 0)
        m[:3, 1:3] *= -1  # OpenGL -> OpenCV
        m[:3, 3] *= scene_scale
        get = lambda k: fr.get(k, meta.get(k))  # noqa: E731
        w, h = int(fr.get("w", w)), int(fr.get("h", h))
        k = np.eye(4)
        k[0, 0], k[1, 1], k[0, 2], k[1, 2] = (get("fl_x"), get("fl_y"),
                                              get("cx"), get("cy"))
        frame = {"rgb_path": dst.name, "camtoworld": m.tolist(),
                 "intrinsics": k.tolist()}
        if "depth_file_path" in fr:
            dsrc = data_dir / fr["depth_file_path"]
            if dsrc.exists():
                # SDFStudio depths are metre .npy: a copy of the 16-bit
                # millimetre png would read 1000x too deep at the gsdf
                # parser's unit scale of 1
                d = io.read_depth(dsrc, 1e-3 if dsrc.suffix != ".npy"
                                  else 1.0)[..., 0]
                ddst = out_dir / f"{i:06d}_sensor_depth.npy"
                np.save(ddst, d.astype(np.float32))
                frame["sensor_depth_path"] = ddst.name
        npath = data_dir / "normals_from_pretrain" / (src.stem + ".png")
        if npath.exists():
            # the gsdf parser decodes normals with no flip, so the omnidata
            # (1, -1, -1) conversion is baked in here
            ndst = out_dir / f"{i:06d}_normal.png"
            io.write_image(ndst, io.read_normal(npath, format="omnidata"))
            frame["mono_normal_path"] = ndst.name
        frames_out.append(frame)

    out_meta = {
        "camera_model": "OPENCV", "height": h, "width": w,
        "has_mono_prior": True, "worldtogt": np.eye(4).tolist(),
        "scene_box": {"aabb": [[-1, -1, -1], [1, 1, 1]], "near": 0.05,
                      "far": 2.5, "radius": 1.0, "collider_type": "box"},
        "frames": frames_out,
    }
    (out_dir / "meta_data.json").write_text(json.dumps(out_meta, indent=2))
    return out_dir / "meta_data.json"


def mushroom_to_sdfstudio(data_dir: Path, out_dir: Path,
                          mode: str = "iphone") -> Path:
    """A MuSHRoom long capture -> the SDFStudio layout, through a
    transforms.json-style directory of links."""
    capture = Path(data_dir) / mode / "long_capture"
    tmp = Path(out_dir) / "_tmp_transforms"
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "transforms.json").write_text(
        (capture / "transformations.json").read_text())
    for sub in ("images", "depth", "normals_from_pretrain"):
        src = capture / sub
        if src.exists() and not (tmp / sub).exists():
            (tmp / sub).symlink_to(src.resolve())
    out = nerfstudio_to_sdfstudio(tmp, Path(out_dir))
    shutil.rmtree(tmp)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("kind", choices=["nerfstudio", "mushroom"])
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--mode", default="iphone")
    args = p.parse_args(argv)
    if args.kind == "nerfstudio":
        out = nerfstudio_to_sdfstudio(args.data, args.output_dir)
    else:
        out = mushroom_to_sdfstudio(args.data, args.output_dir, args.mode)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
