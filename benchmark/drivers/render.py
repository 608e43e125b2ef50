"""The `render` traffic's driver: served frames.

The served path's frames one at a time through
`get_outputs(training=False)` under `no_grad`, each copied to the host.
Once the program's state is freed, the configuration's plain reference
(`cells.reference`) renders the sampled frames again.
"""

from __future__ import annotations

import contextlib
import gc
import math
import random
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from harness import cells
from harness import scene as S
from harness import trace as T
from harness.driving import (PROGRAM_FIELDS, Outcome, checkpoint_buffer,
                             judge, note, peak_bytes, program_cameras,
                             ref_cam, sync)


def render_sample(cfg: Dict, mix: Dict, seed: int, heaviest: int
                  ) -> List[int]:
    """The frames the check compares: the one listing the most pairs and
    `sample_frames - 1` more drawn from the seed."""
    rng = random.Random(seed)
    rest = [i for i in range(int(cfg["frames"])) if i != heaviest]
    return [heaviest] + sorted(rng.sample(rest,
                                          int(mix["sample_frames"]) - 1))


def render_numbers(got: Dict[int, Dict[str, np.ndarray]],
                   want: Dict[int, Dict[str, torch.Tensor]]
                   ) -> Dict[str, float]:
    """The worst sampled frame's mean absolute gap of rgb and of the
    [0, 1] normal map, and of depth relative to the frame's mean depth."""
    out = {"rgb_mae": 0.0, "normal_mae": 0.0, "depth_rel_mae": 0.0}
    for i, w in want.items():
        g = {k: torch.as_tensor(v).to(w[k].device) for k, v in got[i].items()}
        if not all(bool(torch.isfinite(t).all()) for t in g.values()):
            return {k: float("inf") for k in out}
        out["rgb_mae"] = max(out["rgb_mae"],
                             float((g["rgb"] - w["rgb"]).abs().mean()))
        out["normal_mae"] = max(out["normal_mae"], float(
            (g["normal"] - w["normal"]).abs().mean()))
        out["depth_rel_mae"] = max(out["depth_rel_mae"], float(
            (g["depth"] - w["depth"]).abs().mean() / w["depth"].mean()))
    return out


def render_reference(cfg: Dict, scene: S.Scene, frames: List[int],
                     lowp: bool) -> Dict[int, Dict[str, torch.Tensor]]:
    R = cells.reference(cfg)
    p = {f: scene.state[f] for f in PROGRAM_FIELDS}
    bg = torch.zeros(3, device=scene.state["means"].device)
    out = {}
    for i in frames:
        o, _, _ = R.render(p, scene.state["alive"], ref_cam(R, scene, i), bg,
                           int(cfg["sh_degree"]), lowp=lowp)
        out[i] = o
    return out


def render_setup(cfg: Dict, mix: Dict, seed: int, device,
                 t_start: float = 0.0):
    """(params, alive, cameras, raster config, model config, scene,
    heaviest frame, the seconds the reference took to count the pairs,
    the program's peak before it did)."""
    from dnsplatter_torch.configs import model_config_for_method
    from dnsplatter_torch.eval.evaluator import eval_raster_config
    from dnsplatter_torch.train.trainer import load_checkpoint_arrays

    R = cells.reference(cfg)
    note(t_start, "program imported")
    scene = S.make_scene(cfg, seed, device, with_targets=False)
    sync(device)
    note(t_start, "scene and state made")
    buf = checkpoint_buffer(scene.state, int(mix["checkpoint_step"]),
                            with_adam=False)
    params, alive, _ = load_checkpoint_arrays(buf, device=device)
    del buf
    note(t_start, "checkpoint loaded")
    cams = program_cameras(scene, device)
    sync(device)
    # the reference's count is neither set-up nor part of the peak
    peak = peak_bytes(device)
    t_ref = time.perf_counter()
    pairs = R.pair_counts({f: scene.state[f] for f in PROGRAM_FIELDS},
                          scene.state["alive"],
                          [ref_cam(R, scene, i) for i in range(len(cams))])
    ref_s = time.perf_counter() - t_ref
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    note(t_start, f"pair capacity counted by the reference in {ref_s:.3f} s "
         "(not set-up)")
    heaviest = int(np.argmax(pairs))
    cap = int(math.ceil(float(mix["capacity_margin"]) * max(pairs)))
    cap = -(-cap // 128) * 128
    rcfg = eval_raster_config(scene.intr["width"], scene.intr["height"],
                              cap)
    model = model_config_for_method(cfg["method"], **cfg["flags"])
    return params, alive, cams, rcfg, model, scene, heaviest, ref_s, peak


@contextlib.contextmanager
def pairs_listed(sink: List[torch.Tensor]):
    """Each binning's raw total of listed pairs (the program's overflow
    diagnostic, a device scalar) appended to `sink`."""
    from dnsplatter_torch.ops import rasterize

    orig = rasterize.bin_gaussians

    def bin_gaussians(*a, **kw):
        binned = orig(*a, **kw)
        sink.append(binned.total_pairs)
        return binned

    rasterize.bin_gaussians = bin_gaussians
    try:
        yield
    finally:
        rasterize.bin_gaussians = orig


def run(cfg: Dict, mix: Dict, limits: Dict, seed: int, seconds: float,
        trace: bool, device, t_start: float,
        fault: Optional[Callable] = None) -> Outcome:
    from dnsplatter_torch.models import dn_model
    # Loaded before a planted fault is entered: these bind get_outputs by
    # name, and one first imported under a fault would keep its
    # replacement for the rest of the process.
    from dnsplatter_torch.eval import evaluator  # noqa: F401
    from dnsplatter_torch.train import trainer  # noqa: F401

    R = cells.reference(cfg)
    fault_ctx = fault() if fault else contextlib.nullcontext()
    keys = tuple(mix["readback"])
    with fault_ctx, torch.no_grad():
        (params, alive, cams, rcfg, model, scene, heaviest, ref_s,
         peak) = render_setup(cfg, mix, seed, device, t_start)
        bg = torch.zeros(3, device=device)
        sh = int(cfg["sh_degree"])
        sample = set(render_sample(cfg, mix, seed, heaviest))

        def frame(i):
            out, _ = dn_model.get_outputs(params, alive, cams[i], model,
                                          rcfg, sh_degree=sh,
                                          training=False, background=bg)
            return out

        for i in range(int(mix["warmup_frames"])):
            {k: v.cpu() for k, v in frame(i).items() if k in keys}
        sync(device)
        setup_s = time.perf_counter() - t_start - ref_s
        note(t_start, "set up")
        kept: Dict[int, Dict[str, np.ndarray]] = {}
        lat: List[float] = []
        listed: List[torch.Tensor] = []
        n = len(cams)
        with pairs_listed(listed):
            t0 = time.perf_counter()
            while True:
                i = len(lat) % n
                ta = time.perf_counter()
                out = frame(i)
                host = {k: out[k].cpu() for k in keys}
                lat.append(time.perf_counter() - ta)
                if i in sample and i not in kept:
                    kept[i] = {k: v.numpy() for k, v in host.items()}
                if ta + lat[-1] - t0 >= seconds:
                    break
            elapsed = time.perf_counter() - t0
        # a frame that listed more pairs than the capacity dropped some
        overflowed = int((torch.stack(listed) > rcfg.pair_capacity).sum())
        note(t_start, f"window: {len(lat)} frames in {elapsed:.3f} s; ms a "
             f"frame: quartiles {np.percentile(lat, [25, 50, 75]) * 1e3}, "
             f"max {max(lat) * 1e3:.2f}; {overflowed} overflowed "
             f"{rcfg.pair_capacity} pairs")
        red, ctx = None, None
        if trace:
            pf = int(mix["profile_frames"])
            start = len(lat)
            idx = [(start + k) % n for k in range(pf)]
            readback = 0.0
            with T.spans_installed(T.SPANS), T.profiled() as pr:
                for i in idx:
                    with T.record_function("get_outputs"):
                        out = frame(i)
                    sync(device)
                    tr = time.perf_counter()
                    {k: out[k].cpu() for k in keys}
                    readback += time.perf_counter() - tr
            red = T.reduce_trace(pr["prof"], pr["wall_s"], T.LABELS)
            note(t_start, f"spans (device s): {red['span_device_s']}")
        # a sampled frame the window did not reach is served now, late
        for i in sorted(sample - set(kept)):
            out = frame(i)
            kept[i] = {k: out[k].cpu().numpy() for k in keys}
    peak = max(peak, peak_bytes(device))
    del params, alive, out
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    if trace:
        # the reference's count of the profiled stretch's work
        pick = idx[::max(1, pf // int(mix["work_frames"]))]
        tot: Dict[str, float] = {}
        p = {f: scene.state[f] for f in PROGRAM_FIELDS}
        for i in pick:
            _, w, _ = R.render(p, scene.state["alive"], ref_cam(R, scene, i),
                               bg, sh, stats=True)
            for k, v in w.items():
                tot[k] = tot.get(k, 0) + v
        ctx = {"units": pf, "trace": red,
               "work": {k: v / len(pick) for k, v in tot.items()},
               "n_gauss": int(scene.state["alive"].sum()),
               "n_tiles": rcfg.n_tiles,
               "pixels": scene.intr["width"] * scene.intr["height"],
               "untraced_unit_s": elapsed / len(lat),
               "readback_s": readback}
    want = render_reference(cfg, scene, sorted(sample), lowp=False)
    nums = render_numbers(kept, want)
    return Outcome(end_to_end={
        "setup_s": setup_s, "render_fps": len(lat) / elapsed,
        "render_p95_ms": 1e3 * float(np.percentile(lat, 95))},
        attempted=len(lat), failed=overflowed, checks=judge(nums, limits),
        memory_peak=peak, trace=red, layer_ctx=ctx)
