"""Full-dataset evaluation runner (counterpart of
dnsplatter_tpu/eval/evaluator.py): per-image rgb/depth/normal metrics with
rays/s and fps timing, mean/std aggregation (per MuSHRoom protocol where
the data labels its frames), optional render dumps, and point-cloud
accuracy / completeness of the rendered depths against a reference cloud
after ICP registration. On pair-capacity overflow whole Gaussians drop,
deepest first, exactly as the JAX package's binning does.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from dnsplatter_torch import resolve_device
from dnsplatter_torch.data import io
from dnsplatter_torch.eval import icp as I
from dnsplatter_torch.eval import metrics as M
from dnsplatter_torch.eval.offline import aggregate_protocols
from dnsplatter_torch.models.dn_model import ModelConfig, get_outputs
from dnsplatter_torch.models.gaussians import GaussianParams
from dnsplatter_torch.ops.camera import GL_TO_CV, backproject_depth
from dnsplatter_torch.ops.rasterize import RasterizeConfig

# Pairs composited per kernel window: the JAX evaluator's pallas setting.
EVAL_CHUNK = 128


def _mean_std(vals: List[float]):
    a = np.asarray(vals, np.float64)
    return float(a.mean()), float(a.std())


def eval_raster_config(width: int, height: int,
                       pair_capacity: int) -> RasterizeConfig:
    """The rasterizer configuration `evaluate` renders with."""
    return RasterizeConfig(width=width, height=height, tile_size=16,
                           chunk=EVAL_CHUNK, tile_block=32,
                           pair_capacity=pair_capacity, backend="pallas")


def evaluate(
    params: GaussianParams,
    alive: torch.Tensor,
    data,
    model_cfg: ModelConfig = ModelConfig(),
    sh_degree: Optional[int] = None,
    pair_capacity: int = 1 << 21,
    lpips_fn=None,
    output_dir: Optional[Path] = None,
    save_renders: bool = False,
    extract_pointcloud: bool = False,
    reference_points: Optional[np.ndarray] = None,
    icp_transform: Optional[np.ndarray] = None,
    icp_json: Optional[Path] = None,
    run_icp_if_missing: bool = True,
    pcd_stride: int = 7,
    pcd_train_data=None,
    device=None,
) -> Dict[str, float]:
    """Evaluate over every frame of `data` (`__len__` + `get(i)` ->
    (Camera, batch of numpy arrays)). Params, alive and cameras must lie on
    `device` (None: the card). Each frame is timed between device
    synchronizations, after one warm-up render per image size outside the
    timed window.

    With `extract_pointcloud` and `reference_points`, the rendered depths
    of `data` (and of `pcd_train_data`, when given) are backprojected into
    one cloud, registered to the reference by `icp_transform`, else the
    transform in `icp_json`, else (with `run_icp_if_missing`) a
    point-to-point ICP whose rmse is reported as `pd_icp_rmse`, and scored
    as `pd_accuracy` / `pd_completeness`.
    """
    dev = resolve_device(device)
    if params.means.device.type != dev.type:
        raise ValueError(f"params lie on {params.means.device}, evaluate "
                         f"was asked to run on {dev}")
    if sh_degree is None:
        sh_degree = params.sh_degree

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if output_dir:
        output_dir = Path(output_dir)
        for sub in ("pred/rgb", "pred/depth", "pred/normal", "gt/rgb",
                    "gt/depth", "gt/normal"):
            (output_dir / sub).mkdir(parents=True, exist_ok=True)

    configs: Dict[tuple, RasterizeConfig] = {}
    background = torch.zeros(3, device=dev)

    def config(cam) -> RasterizeConfig:
        """The image size's configuration; its first use renders once,
        outside the timing."""
        size = (cam.width, cam.height)
        if size not in configs:
            configs[size] = eval_raster_config(cam.width, cam.height,
                                               pair_capacity)
            render(cam, configs[size])
            sync()
        return configs[size]

    def render(cam, cfg):
        out, _ = get_outputs(params, alive, cam, model_cfg, cfg,
                             sh_degree=sh_degree, background=background)
        return out

    # the points only count against a reference cloud: no train renders
    # for nothing
    want_pcd = extract_pointcloud and reference_points is not None

    def _frame_points(cam, out) -> np.ndarray:
        """World points of the rendered depth where accumulation > 0.5,
        every `pcd_stride`-th in row-major order."""
        c2w_cv = cam.c2w @ torch.as_tensor(GL_TO_CV, device=cam.device)
        pts = backproject_depth(out["depth"][..., 0], cam.fx, cam.fy,
                                cam.cx, cam.cy, c2w_cv).reshape(-1, 3)
        keep = out["accumulation"].reshape(-1) > 0.5
        return pts[keep][::pcd_stride].cpu().numpy()

    per_image: List[Dict[str, float]] = []
    pcd_pts: List[np.ndarray] = []
    with torch.no_grad():
        for i in range(len(data)):
            cam, batch = data.get(i)
            cfg = config(cam)
            sync()
            t0 = time.perf_counter()
            out = render(cam, cfg)
            sync()
            dt = time.perf_counter() - t0

            row: Dict[str, float] = {}
            gt_img = torch.as_tensor(batch["image"], device=dev)
            row.update({f"rgb_{k}": v for k, v in
                        M.rgb_metrics(out["rgb"], gt_img, lpips_fn).items()})
            row["num_rays_per_sec"] = cam.width * cam.height / dt
            row["fps"] = 1.0 / dt
            if "sensor_depth" in batch:
                gt_d = torch.as_tensor(batch["sensor_depth"], device=dev)
                row.update({f"depth_{k}": v for k, v in
                            M.depth_metrics(out["depth"], gt_d).items()})
            if "normal" in batch:
                # metrics on the [0, 1]-encoded maps, as the reference
                gt_n = torch.as_tensor(batch["normal"], device=dev)
                row.update({f"normal_{k}": v for k, v in
                            M.normal_metrics(out["normal"], gt_n).items()})
            per_image.append(row)
            if want_pcd:
                pcd_pts.append(_frame_points(cam, out))

            if save_renders and output_dir:
                stem = f"{i:05d}"
                io.write_image(output_dir / "pred/rgb" / f"{stem}.png",
                               out["rgb"].cpu().numpy())
                np.save(output_dir / "pred/depth" / f"{stem}.npy",
                        out["depth"].cpu().numpy())
                io.write_image(output_dir / "pred/normal" / f"{stem}.png",
                               out["normal"].cpu().numpy())
                io.write_image(output_dir / "gt/rgb" / f"{stem}.png",
                               batch["image"])
                if "sensor_depth" in batch:
                    np.save(output_dir / "gt/depth" / f"{stem}.npy",
                            batch["sensor_depth"])
                if "normal" in batch:
                    io.write_image(output_dir / "gt/normal" / f"{stem}.png",
                                   batch["normal"])

        if want_pcd and pcd_train_data is not None:
            # the reference's cloud holds the train renders too
            for i in range(len(pcd_train_data)):
                cam, _ = pcd_train_data.get(i)
                pcd_pts.append(_frame_points(cam, render(cam, config(cam))))

    labels = getattr(data, "protocols", None)
    if labels and len(labels) == len(per_image):
        agg = aggregate_protocols(per_image, labels)
    else:
        agg = {}
        for k in sorted({k for row in per_image for k in row}):
            m, s = _mean_std([row[k] for row in per_image if k in row])
            agg[k] = m
            agg[f"{k}_std"] = s
        agg["num_images"] = len(per_image)
    if lpips_fn is None:
        agg["lpips_kind"] = M.default_lpips_kind()

    if want_pcd and pcd_pts:
        pred_cloud = np.concatenate(pcd_pts)
        transform = icp_transform
        if (transform is None and icp_json is not None
                and Path(icp_json).exists()):
            transform = I.load_icp_json(icp_json)
        if transform is None and run_icp_if_missing:
            transform, agg["pd_icp_rmse"] = I.icp(
                pred_cloud, np.asarray(reference_points),
                max_correspondence_distance=0.3)
        if transform is not None:
            pred_cloud = I.transform_points(pred_cloud, transform)
        agg.update({f"pd_{k}": v for k, v in
                    M.pd_metrics(pred_cloud, reference_points).items()})
    if output_dir:
        (output_dir / "metrics.json").write_text(json.dumps(agg, indent=2))
    return agg
