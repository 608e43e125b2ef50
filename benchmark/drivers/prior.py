"""The `prior` traffic's driver: monocular normal maps, one camera frame at
a time.

Closed loop, one client, batch 1: each frame is the program's served path,
`dsine.predict_normals(model, rgb_u8, K)`, looked up on the module at call
time, and is done when its float32 (H, W, 3) map is on the host. The
weights are `common.random_arrays` of the configuration's widths, drawn
from the seed, and the model is built from them as `dsine.load_model`
builds it once its file is read; the frames are uniform uint8 noise from
the seed, cycled. Once the program's state is freed, the configuration's
plain reference (`cells.reference`) recomputes the sampled frames on the
same device.
"""

from __future__ import annotations

import contextlib
import gc
import random
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from harness import cells
from harness import trace as T
from harness.driving import Outcome, judge, note, peak_bytes, sync

# (module, attribute, label) ranges of the profiled stretch. The labels
# must not equal a span name of the program's recorder.
SPANS = (
    ("dnsplatter_torch.priors.dsine", "predict_normals", "predict_normals"),
    ("dnsplatter_torch.priors.dsine", "dsine_forward", "dsine_forward"),
)
LABELS = tuple(label for _, _, label in SPANS)
# A pixel counts as far when its normal and the reference's are more than
# this many degrees apart: for unit vectors, when the chord between them
# is longer than 2 sin(FAR_DEG / 2), which counts a zeroed or shortened
# normal as far too.
FAR_DEG = 1.0


def prior_inputs(cfg: Dict, seed: int
                 ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
    """(the network's arrays, the (frames, H, W, 3) uint8 frames, the
    (3, 3) float32 pixel intrinsics, top-left (0, 0) convention), all
    from the seed."""
    from dnsplatter_torch.priors import common, dsine

    with torch.device("meta"):
        shapes = dsine.DSINE(**cfg["widths"])
    arrays = common.random_arrays(shapes, seed)
    h, w = int(cfg["height"]), int(cfg["width"])
    frames = np.random.default_rng([seed, 1]).integers(
        0, 256, (int(cfg["frames"]), h, w, 3), dtype=np.uint8)
    f = float(cfg["focal"])
    K = np.array([[f, 0, (w - 1) / 2.0], [0, f, (h - 1) / 2.0], [0, 0, 1]],
                 np.float32)
    return arrays, frames, K


def prior_sample(cfg: Dict, mix: Dict, seed: int) -> List[int]:
    """The frames the check compares, drawn from the seed."""
    return sorted(random.Random(seed).sample(range(int(cfg["frames"])),
                                             int(mix["sample_frames"])))


def prior_reference(R, arrays: Dict[str, np.ndarray], frames: np.ndarray,
                    sample: List[int], K: np.ndarray, device,
                    dtype: torch.dtype = torch.float32,
                    allow_tf32: bool = False) -> Dict[int, np.ndarray]:
    """The reference's map of each sampled frame, on `device`."""
    p = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
    return {i: R.predict(p, frames[i], K, dtype=dtype, allow_tf32=allow_tf32)
            for i in sample}


def prior_numbers(got: Dict[int, np.ndarray], want: Dict[int, np.ndarray]
                  ) -> Dict[str, float]:
    """Over the sampled frames, the worst frame's mean absolute gap of the
    map (`normal_mae`), its share of pixels whose normals are more than
    `FAR_DEG` apart (`far_px_share`), and its median pixel's chord between
    the two normals (`normal_median_gap`).

    The median is the number that tells a lower precision from float32
    rounding. With seeded weights the refinement is ill-conditioned at a
    few pixels: there a rounding-level difference upstream moves a normal
    by up to degrees, and such clusters set the mean and the far share of
    a sound program; a lower precision moves every pixel."""
    out = {"normal_mae": 0.0, "far_px_share": 0.0, "normal_median_gap": 0.0}
    for i, w in want.items():
        g = np.asarray(got[i], np.float64)
        w = np.asarray(w, np.float64)
        if g.shape != w.shape or not np.isfinite(g).all():
            return {k: float("inf") for k in out}
        out["normal_mae"] = max(out["normal_mae"],
                                float(np.abs(g - w).mean()))
        chord = np.linalg.norm(g - w, axis=-1)
        far = chord > 2 * np.sin(np.radians(FAR_DEG) / 2)
        out["far_px_share"] = max(out["far_px_share"], float(far.mean()))
        out["normal_median_gap"] = max(out["normal_median_gap"],
                                       float(np.median(chord)))
    return out


def _check_config(cfg: Dict) -> None:
    """The configuration states the refinement the program runs."""
    from dnsplatter_torch.priors import dsine

    have = {"num_iter": dsine.NUM_ITER, "patch": dsine.PS,
            "upsample": dsine.DOWN}
    for k, v in have.items():
        if int(cfg[k]) != v:
            raise ValueError(f"configuration {k} {cfg[k]}, the program "
                             f"runs {v}")


def run(cfg: Dict, mix: Dict, limits: Dict, seed: int, seconds: float,
        trace: bool, device, t_start: float,
        fault: Optional[Callable] = None) -> Outcome:
    from dnsplatter_torch.priors import dsine
    from dnsplatter_torch.priors.common import build

    R = cells.reference(cfg)
    _check_config(cfg)
    note(t_start, "program imported")
    arrays, frames, K = prior_inputs(cfg, seed)
    note(t_start, f"weights and {len(frames)} frames drawn")
    sample = set(prior_sample(cfg, mix, seed))
    n = len(frames)
    fault_ctx = fault() if fault else contextlib.nullcontext()
    with fault_ctx:
        model = build(dsine.DSINE(**dsine.widths_of(arrays)), device,
                      arrays=arrays)
        note(t_start, "model built")

        def frame(i):
            return dsine.predict_normals(model, frames[i % n], K)

        for i in range(int(mix["warmup_frames"])):
            frame(i)
        sync(device)
        setup_s = time.perf_counter() - t_start
        note(t_start, "set up")
        kept: Dict[int, np.ndarray] = {}
        lat: List[float] = []
        t0 = time.perf_counter()
        while True:
            i = len(lat) % n
            ta = time.perf_counter()
            out = frame(i)
            lat.append(time.perf_counter() - ta)
            if i in sample and i not in kept:
                kept[i] = out
            if ta + lat[-1] - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        note(t_start, f"window: {len(lat)} frames in {elapsed:.3f} s; ms a "
             f"frame: quartiles {np.percentile(lat, [25, 50, 75]) * 1e3}, "
             f"max {max(lat) * 1e3:.2f}")
        red = ctx = None
        if trace:
            pf = int(mix["profile_frames"])
            start = len(lat)
            with T.spans_installed(SPANS), T.profiled() as pr:
                for k in range(pf):
                    frame(start + k)
            red = T.reduce_trace(pr["prof"], pr["wall_s"], LABELS)
            note(t_start, f"spans (device s): {red['span_device_s']}")
            h, w = frames.shape[1:3]
            ctx = {"units": pf, "trace": red, "flops": R.flops(h, w),
                   "untraced_unit_s": elapsed / len(lat)}
        # a sampled frame the window did not reach is served now, late
        for i in sorted(sample - set(kept)):
            kept[i] = frame(i)
    peak = peak_bytes(device)
    del model
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    want = prior_reference(R, arrays, frames, sorted(sample), K, device)
    nums = prior_numbers(kept, want)
    return Outcome(end_to_end={
        "setup_s": setup_s, "render_fps": len(lat) / elapsed,
        "render_p95_ms": 1e3 * float(np.percentile(lat, 95))},
        attempted=len(lat), failed=0, checks=judge(nums, limits),
        memory_peak=peak, trace=red, layer_ctx=ctx)
