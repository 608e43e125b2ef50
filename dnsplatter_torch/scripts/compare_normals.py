"""Angular comparison between two normal-map folders (counterpart of
dnsplatter_tpu/scripts/compare_normals.py).

Parity: dn_splatter/scripts/compare_normals.py — mean angular error
between corresponding normal images (e.g. mono priors vs renders).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def mean_angular_error_deg(a01: np.ndarray, b01: np.ndarray) -> float:
    a = 2.0 * a01 - 1.0
    b = 2.0 * b01 - 1.0
    a = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-8)
    b = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-8)
    dots = np.clip((a * b).sum(-1), -1.0, 1.0)
    return float(np.degrees(np.arccos(dots)).mean())


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dir-a", type=Path, required=True)
    p.add_argument("--dir-b", type=Path, required=True)
    args = p.parse_args(argv)

    from dnsplatter_torch.data import io

    errs = []
    for fa in sorted(args.dir_a.glob("*.png")):
        fb = args.dir_b / fa.name
        if not fb.exists():
            continue
        a = io.read_image(fa)
        b = io.read_image(fb)
        if a.shape != b.shape:
            b = io.resize_image(b, a.shape[0], a.shape[1])
        errs.append(mean_angular_error_deg(a, b))
    if not errs:
        raise SystemExit(
            "no matching frame pairs found (check filenames/extensions)"
        )
    mean = float(np.mean(errs))
    print(f"frames: {len(errs)}  mean angular error: {mean:.3f} deg")
    return mean


if __name__ == "__main__":
    main()
