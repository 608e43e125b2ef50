"""Monocular depth priors over a folder of images (counterpart of
dnsplatter_tpu/scripts/depth_from_pretrain.py): ZoeDepth-NYU per frame on
`--device` (default: the card), writing `mono_depth/<stem>.npy`, and, where
the sorted sensor depth of the same index has the prediction's size, the
closed-form scale/shift alignment to it as `<stem>_aligned.npy`
(scripts/align_depth.py).

    python -m dnsplatter_torch.scripts.depth_from_pretrain --data DIR \
        --ckpt zoe.npz --sensor-dir DIR/depth

`--ckpt` takes the npz of `python -m dnsplatter_torch.priors.convert --zoe`
or ZoeD_M12_N.pt itself, converted in-process (no torch.hub). Without it
the script exits and names the convert command.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from dnsplatter_torch.priors import zoedepth
from dnsplatter_torch.scripts.align_depth import align_mono_to_sensor
from dnsplatter_torch.scripts.normals_from_pretrain import list_images


def load_zoedepth_predictor(ckpt_path: Path | None, device=None):
    """(H, W, 3) rgb in [0, 1] -> (H, W) metric depth."""
    if ckpt_path is None:
        raise SystemExit(
            "ZoeDepth needs --ckpt: convert the published checkpoint once "
            "with: python -m dnsplatter_torch.priors.convert --zoe "
            "ZoeD_M12_N.pt zoe.npz (or pass ZoeD_M12_N.pt itself)")
    model = zoedepth.load_model(ckpt_path, device=device)

    def predict(rgb01: np.ndarray) -> np.ndarray:
        return zoedepth.predict_depth(model, rgb01)

    return predict


def run_monocular_depth(image_dir: Path, out_dir: Path,
                        sensor_dir: Path | None = None,
                        depth_unit: float = 1e-3,
                        ckpt_path: Path | None = None, device=None) -> int:
    from dnsplatter_torch.data import io

    predict = load_zoedepth_predictor(ckpt_path, device)
    out_dir.mkdir(parents=True, exist_ok=True)
    images = list_images(image_dir)
    sensors = sorted(Path(sensor_dir).glob("*")) if sensor_dir else []
    for i, img_path in enumerate(images):
        pred = predict(io.read_image(img_path)).astype(np.float32)
        np.save(out_dir / f"{img_path.stem}.npy", pred)
        if i < len(sensors):
            sensor = io.read_depth(sensors[i], depth_unit)[..., 0]
            if sensor.shape == pred.shape:
                np.save(out_dir / f"{img_path.stem}_aligned.npy",
                        align_mono_to_sensor(pred, sensor))
    return len(images)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--image-dir", type=Path, default=None)
    p.add_argument("--sensor-dir", type=Path, default=None)
    p.add_argument("--ckpt", type=Path, default=None,
                   help="zoe.npz or ZoeD_M12_N.pt")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    image_dir = args.image_dir or args.data / "images"
    n = run_monocular_depth(image_dir, args.data / "mono_depth",
                            args.sensor_dir, ckpt_path=args.ckpt,
                            device=args.device)
    print(f"wrote {n} mono depths")
    return n


if __name__ == "__main__":
    main()
