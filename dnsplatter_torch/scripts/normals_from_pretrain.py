"""Monocular normal priors over a folder of images (counterpart of
dnsplatter_tpu/scripts/normals_from_pretrain.py): Omnidata's DPT-Hybrid at
384x384 (the default), its HD variant (overlapping 384 patches merged by
scripts/normals_hd.py), or DSINE, writing `normals_from_pretrain/*.png` in
the omnidata convention the dataparsers read. The networks run on `--device`
(default: the card).

    python -m dnsplatter_torch.scripts.normals_from_pretrain --data DIR \
        --ckpt omnidata.npz [--hd | --model-type dsine --ckpt dsine.npz]

`--ckpt` takes the npz of `python -m dnsplatter_torch.priors.convert` or the
published checkpoint itself (omnidata_dpt_normal_v2.ckpt, dsine.pt), which
is converted in-process; neither omnidata-tools nor torch.hub is needed.
Without the file the script exits and names the convert command.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from dnsplatter_torch.priors import dpt, dsine

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg")


def list_images(image_dir: Path):
    return sorted(p for p in Path(image_dir).glob("*")
                  if p.suffix.lower() in IMAGE_SUFFIXES)


def load_omnidata_predictor(ckpt_path: Path, device=None):
    """(R, R, 3) rgb in [0, 1] -> (R, R, 3) in [0, 1]: the clamped raw
    output of the omnidata DPT-Hybrid."""
    model = dpt.load_model(ckpt_path, device=device)

    def predict(rgb01: np.ndarray) -> np.ndarray:
        return dpt.run_normals(model, rgb01)

    return predict


def run_monocular_normals(image_dir: Path, out_dir: Path, ckpt_path: Path,
                          resolution: int = 384, device=None) -> int:
    from dnsplatter_torch.data import io

    predict = load_omnidata_predictor(ckpt_path, device)
    out_dir.mkdir(parents=True, exist_ok=True)
    images = list_images(image_dir)
    for img_path in images:
        img = io.read_image(img_path)
        h, w = img.shape[:2]
        normal = predict(io.resize_image(img, resolution, resolution))
        io.write_image(out_dir / f"{img_path.stem}.png",
                       np.clip(io.resize_image(normal, h, w), 0, 1))
    return len(images)


def run_monocular_normals_hd(image_dir: Path, out_dir: Path,
                             ckpt_path: Path, patch: int = 384,
                             device=None) -> int:
    """Overlapping-patch inference + Kabsch-aligned merge."""
    from dnsplatter_torch.data import io
    from dnsplatter_torch.scripts.normals_hd import predict_normals_hd

    predict = load_omnidata_predictor(ckpt_path, device)

    def predictor(rgb: np.ndarray) -> np.ndarray:
        return predict(rgb) * 2.0 - 1.0

    out_dir.mkdir(parents=True, exist_ok=True)
    images = list_images(image_dir)
    for img_path in images:
        n = predict_normals_hd(io.read_image(img_path), predictor,
                               patch=patch)
        io.write_image(out_dir / f"{img_path.stem}.png",
                       np.clip((n + 1.0) * 0.5, 0, 1))
    return len(images)


def run_dsine_normals(image_dir: Path, out_dir: Path, ckpt_path: Path,
                      intrinsics: np.ndarray | None = None,
                      device=None) -> int:
    """DSINE per image; the LUF -> RUF flip and the [0, 1] png encoding of
    the reference."""
    from dnsplatter_torch.data import io

    model = dsine.load_model(ckpt_path, device=device)
    out_dir.mkdir(parents=True, exist_ok=True)
    images = list_images(image_dir)
    for img_path in images:
        rgb_u8 = (np.clip(io.read_image(img_path), 0, 1) * 255).astype(
            np.uint8)
        n = dsine.predict_normals(model, rgb_u8, K=intrinsics)
        n = n * np.array([-1.0, 1.0, 1.0])  # LUF -> RUF
        io.write_image(out_dir / f"{img_path.stem}.png",
                       np.clip((n + 1.0) * 0.5, 0, 1))
    return len(images)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--image-dir", type=Path, default=None)
    p.add_argument("--output-dir", type=Path, default=None,
                   help="default: DATA/normals_from_pretrain")
    p.add_argument("--ckpt", type=Path,
                   default=Path("omnidata_dpt_normal_v2.ckpt"))
    p.add_argument("--model-type", choices=("omnidata", "dsine"),
                   default="omnidata")
    p.add_argument("--hd", action="store_true",
                   help="overlapping-patch HD inference + aligned merge")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    image_dir = args.image_dir or args.data / "images"
    out_dir = args.output_dir or args.data / "normals_from_pretrain"
    if args.model_type == "dsine":
        n = run_dsine_normals(image_dir, out_dir, args.ckpt,
                              device=args.device)
    elif args.hd:
        n = run_monocular_normals_hd(image_dir, out_dir, args.ckpt,
                                     device=args.device)
    else:
        n = run_monocular_normals(image_dir, out_dir, args.ckpt,
                                  device=args.device)
    print(f"wrote {n} normal maps")
    return n


if __name__ == "__main__":
    main()
