"""High-resolution normal maps by overlapping-patch crop + merge (counterpart
of dnsplatter_tpu/scripts/normals_hd.py; host numpy in both packages).

Parity: dn_splatter/scripts/normals_from_pretrain.py:238-285 (HD variant)
and :521-700 (patch alignment/merge). Monocular normal networks run at a
fixed low resolution (384 for Omnidata); the reference crops overlapping
patches, predicts each, then rotation-aligns neighbouring patches with a
Kabsch best-fit on their overlap before stitching.

This implementation keeps the reference's alignment math (SVD best-fit
rotation over overlap normals) but stitches with an incremental mosaic:
patches merge in raster order, each aligned to the already-merged canvas
over its full overlap (the reference aligns along x strips then y strips
— the incremental form uses the identical per-pair math with strictly
more overlap context). Blending uses a separable feather window and the
result is renormalized per pixel.

The predictor is pluggable: any callable (H, W, 3) rgb -> (H, W, 3)
normals in [-1, 1] — the gated Omnidata/DSINE wrappers, or the
weight-free depth route.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np


def best_fit_rotation(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation R minimizing |R a - b| over unit-normal rows (Kabsch,
    no translation — normals live on the sphere).
    Parity: normals_from_pretrain.py:521-541 `best_fit_transform`."""
    h = a.T @ b
    u, _, vt = np.linalg.svd(h)
    r = vt.T @ u.T
    if np.linalg.det(r) < 0:
        vt = vt.copy()
        vt[-1, :] *= -1
        r = vt.T @ u.T
    return r


def patch_grid(h: int, w: int, patch: int, step: int) -> List[Tuple[int, int]]:
    """Top-left corners of overlapping patches covering the image."""
    ys = list(range(0, max(h - patch, 0) + 1, step))
    xs = list(range(0, max(w - patch, 0) + 1, step))
    if ys[-1] != h - patch:
        ys.append(h - patch)
    if xs[-1] != w - patch:
        xs.append(w - patch)
    return [(y, x) for y in ys for x in xs]


def _feather(patch: int) -> np.ndarray:
    ramp = np.minimum(np.arange(patch) + 1, np.arange(patch)[::-1] + 1)
    ramp = ramp / ramp.max()
    return np.outer(ramp, ramp)


def merge_patch_normals(
    patches: List[np.ndarray],  # (P, P, 3) in [-1, 1]
    corners: List[Tuple[int, int]],
    h: int,
    w: int,
    min_overlap: int = 64,
) -> np.ndarray:
    """Stitch per-patch normal predictions into one (h, w, 3) map."""
    patch = patches[0].shape[0]
    acc = np.zeros((h, w, 3), np.float64)
    wsum = np.zeros((h, w, 1), np.float64)
    feather = _feather(patch)[..., None]

    for (y, x), n in zip(corners, patches):
        n = np.asarray(n, np.float64)
        region_w = wsum[y:y + patch, x:x + patch]
        mask = region_w[..., 0] > 0
        if mask.sum() >= min_overlap:
            canvas = acc[y:y + patch, x:x + patch] / np.maximum(
                region_w, 1e-12
            )
            a = n[mask]
            b = canvas[mask]
            bn = np.linalg.norm(b, axis=-1, keepdims=True)
            good = bn[..., 0] > 1e-6
            if good.sum() >= min_overlap:
                r = best_fit_rotation(a[good], (b / np.maximum(bn, 1e-12))[good])
                n = n @ r.T
        acc[y:y + patch, x:x + patch] += n * feather
        wsum[y:y + patch, x:x + patch] += feather

    out = acc / np.maximum(wsum, 1e-12)
    out = out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-12)
    return out.astype(np.float32)


def predict_normals_hd(
    rgb: np.ndarray,
    predictor: Callable[[np.ndarray], np.ndarray],
    patch: int = 384,
    step: Optional[int] = None,
) -> np.ndarray:
    """(H, W, 3) rgb -> (H, W, 3) unit normals in [-1, 1] via overlapped
    patches + aligned merge. Falls back to a single full-image call when
    the image is not larger than the patch."""
    h, w = rgb.shape[:2]
    if h <= patch and w <= patch:
        n = np.asarray(predictor(rgb))
        return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                              1e-12)
    patch = min(patch, h, w)
    step = step or (2 * patch) // 3
    corners = patch_grid(h, w, patch, step)
    preds = [np.asarray(predictor(rgb[y:y + patch, x:x + patch]))
             for (y, x) in corners]
    return merge_patch_normals(preds, corners, h, w)


def run_folder(
    image_folder: Path,
    save_path: Path,
    predictor: Callable[[np.ndarray], np.ndarray],
    patch: int = 384,
) -> None:
    """HD-normal generation over a folder (png in omnidata convention),
    the run_monocular_normals_hd routine (normals_from_pretrain.py:238-285)."""
    from dnsplatter_torch.data import io

    save_path = Path(save_path)
    save_path.mkdir(parents=True, exist_ok=True)
    for p in sorted(Path(image_folder).glob("*")):
        if p.suffix.lower() not in (".png", ".jpg", ".jpeg"):
            continue
        rgb = io.read_image(p)
        n = predict_normals_hd(rgb, predictor, patch=patch)
        # omnidata png convention (OpenGL flip; loaders undo it)
        n_png = (n * np.array([1.0, -1.0, -1.0]) + 1.0) * 0.5
        io.write_image(save_path / f"{p.stem}.png", n_png)
        np.save(save_path / f"{p.stem}.npy", n)
