"""The two traffic drivers: training steps and served frames.

Each driver sets a cell up from the seed, measures its window, optionally
profiles a steady stretch after it, and then decides `correct` against the
plain reference once the program's state is freed. The numbers it returns
are assembled into the result line by `run.py`.

`train`: the Trainer resumes from the benchmark's state through its own
checkpoint loader, and its first `checked_steps` steps go through the
window's own call (`Trainer.train`), one at a time, so the check can read
the loss of each, the first gradient from Adam's state, and the state
before and after the refinement that follows the last. The window then
drives `Trainer.train(chunk_steps)` until `--seconds` have passed.

`render`: the served path's frames one at a time through
`get_outputs(training=False)` under `no_grad`, each copied to the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import math
import random
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from harness import reference as R
from harness import scene as S
from harness import trace as T

PROGRAM_FIELDS = R.FIELDS


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device) -> int:
    return (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)


def note(t_start: float, what: str) -> None:
    """A set-up phase's end on stderr, in seconds since the process
    started."""
    print(f"[{time.perf_counter() - t_start:8.2f} s] {what}", file=sys.stderr,
          flush=True)


def quiet():
    """The program's stdout goes to stderr: the result line is stdout's."""
    return contextlib.redirect_stdout(sys.stderr)


def checkpoint_buffer(state: Dict[str, torch.Tensor], step: int,
                      with_adam: bool) -> io.BytesIO:
    """The state as the program's uncompressed npz checkpoint, in memory:
    params.<field>, alive, step and, for training, Adam's moments,
    accumulators and counts at zero."""
    flat = {f"params.{f}": state[f].cpu().numpy() for f in PROGRAM_FIELDS}
    flat["alive"] = state["alive"].cpu().numpy()
    flat["step"] = np.asarray(step)
    if with_adam:
        for f in PROGRAM_FIELDS:
            z = np.zeros(state[f].shape, np.float32)
            for kind in ("mu", "nu", "accum"):
                flat[f"adam.{kind}.{f}"] = z
            flat[f"adam.count.{f}"] = np.asarray(0, np.int32)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    buf.seek(0)
    return buf


def ref_cam(scene: S.Scene, i: int) -> R.Cam:
    it = scene.intr
    return R.Cam(c2w=scene.c2ws[i], fx=it["fx"], fy=it["fy"], cx=it["cx"],
                 cy=it["cy"], width=it["width"], height=it["height"])


def program_cameras(scene: S.Scene, device) -> List:
    from dnsplatter_torch.ops.camera import Camera

    it = scene.intr
    return [Camera.create(it["fx"], it["fy"], it["cx"], it["cy"], c2w,
                          it["width"], it["height"], device=device)
            for c2w in scene.c2ws]


class Frames:
    """The Trainer's scene source: frame i's camera and its targets as
    float32 device tensors."""

    def __init__(self, cams, targets):
        self.cams, self.targets = cams, targets

    def __len__(self) -> int:
        return len(self.cams)

    def get(self, i: int):
        return self.cams[i], self.targets[i]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> List[float]:
    """Each kept leaf's gap between two norms, against the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    med = float(np.median([ref[f] for f in keep]))
    return [abs(prog[f] - ref[f]) / max(ref[f], med, 1e-30) for f in keep]


@dataclasses.dataclass
class Outcome:
    """What a driver hands to run.py."""

    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Dict[str, float]]
    memory_peak: int
    trace: Optional[Dict] = None
    layer_ctx: Optional[Dict] = None


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """The numbers that the cell's limits name, each beside its limit."""
    return {k: {"value": float(numbers[k]), "limit": float(v)}
            for k, v in limits.items()}


# -- training --------------------------------------------------------------


def _program_configs(cfg: Dict):
    from dnsplatter_torch.configs import model_config_for_method
    from dnsplatter_torch.train.optim import OptimConfig
    from dnsplatter_torch.train.trainer import TrainConfig

    model = model_config_for_method(cfg["method"], **cfg["flags"])
    return model, OptimConfig(), TrainConfig()


def _grad_norms(trainer, b1: float) -> Dict[str, float]:
    """The first step's gradient as Adam received it, from its state after
    that step: the accumulator of a windowed group that has not applied
    yet, else the first moment over (1 - b1) (the moments start at 0)."""
    st = trainer.adam
    out = {}
    for f in PROGRAM_FIELDS:
        if st.count[f] == 0:
            g = getattr(st.accum, f)
        else:
            g = getattr(st.mu, f) / (1.0 - b1)
        out[f] = float(torch.linalg.norm(g.double()))
    return out


def _change_norms(now: Dict[str, torch.Tensor],
                  start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {f: float(torch.linalg.norm((now[f] - start[f]).double()))
            for f in PROGRAM_FIELDS}


def _row_sums(params) -> torch.Tensor:
    """(C,) float64: each row's fields under fixed weights, summed. A row
    the event left alone reads the same before and after it."""
    gen = torch.Generator().manual_seed(1)
    out = 0.0
    for f in PROGRAM_FIELDS:
        x = getattr(params, f)
        w = torch.rand(x.shape[1:], generator=gen, dtype=torch.float64)
        out = out + (x.double() * (0.5 + w.to(x.device))).reshape(
            x.shape[0], -1).sum(1)
    return out


def _event_tap(trainer, start: Dict[str, torch.Tensor], out: Dict):
    """A wrapper of the Trainer's refinement that reads, for the check,
    the change of the state before it (`change`) and what it did to the
    rows (`event`, as `reference.Event` has it)."""
    orig = trainer._refinement

    def refinement(camera):
        p = trainer.params
        out["change"] = _change_norms(
            {f: getattr(p, f) for f in PROGRAM_FIELDS}, start)
        sig0, live0 = _row_sums(p), trainer.alive > 0.5
        orig(camera)
        p = trainer.params
        sig1, live1 = _row_sums(p), trainer.alive > 0.5
        grown = sig1.shape[0] - sig0.shape[0]
        if grown:
            sig0 = torch.cat([sig0, sig0.new_full((grown,), torch.nan)])
            live0 = torch.cat([live0, live0.new_zeros(grown)])
        changed = sig0 != sig1
        added = live1 & (~live0 | changed)
        rows = torch.cat([p.means, torch.exp(p.scales)], -1).double()
        out["event"] = R.Event(
            removed=(live0 & (~live1 | changed))[:live0.shape[0] - grown],
            added=int(added.sum()), added_sum=rows[added].sum(0))

    return refinement


def train_setup(cfg: Dict, mix: Dict, seed: int, device,
                t_start: float = 0.0):
    """(trainer, scene, the program's readings of the checked steps)."""
    from dnsplatter_torch.train.trainer import Trainer

    note(t_start, "program imported")
    scene = S.make_scene(cfg, seed, device, with_targets=True)
    sync(device)
    note(t_start, "scene, targets and state made")
    cams = program_cameras(scene, device)
    model, optim, train = _program_configs(cfg)
    st = scene.state
    n = int(cfg["num_gaussians"])
    seeds = (st["means"][:n].cpu().numpy(), st["colors"].cpu().numpy())
    buf = checkpoint_buffer(st, int(mix["resume_step"]), with_adam=True)
    note(t_start, "checkpoint written to memory")
    with quiet():
        trainer = Trainer(Frames(cams, scene.targets), seeds,
                          model_cfg=model, optim_cfg=optim, train_cfg=train,
                          device=device)
        note(t_start, "Trainer made")
        trainer.load_checkpoint(buf)
    del buf
    note(t_start, "checkpoint loaded")
    losses, grads, last = [], None, {}
    checked = int(mix["checked_steps"])
    with quiet():
        for k in range(checked):
            if k == checked - 1:
                trainer._refinement = _event_tap(trainer, st, last)
            trainer.train(num_steps=1, log_every=1 << 30)
            ld = trainer.last_loss_dict
            losses.append(float(ld["main_loss"] + ld["scale_reg"]))
            if k == 0:
                grads = _grad_norms(trainer, optim.b1)
    del trainer._refinement
    note(t_start, f"checked steps taken; the refinement after them removed "
         f"{int(last['event'].removed.sum())} rows, added "
         f"{last['event'].added}")
    prog = {"losses": losses, "grads": grads, "change": last["change"],
            "event": last["event"]}
    return trainer, scene, prog


def train_reference(cfg: Dict, mix: Dict, scene: S.Scene, lowp: bool):
    """The reference's readings of the checked steps from the same state,
    frames and background draws."""
    k = int(mix["checked_steps"])
    s0 = int(mix["resume_step"])
    frames = int(cfg["frames"])
    idx = [(s0 + j) % frames for j in range(k)]
    gen = torch.Generator()
    gen.manual_seed(int(cfg["train"]["seed"]))
    # the Trainer draws one background a step, on the host, from its seed
    bgs = [torch.rand(3, generator=gen).to(scene.state["means"].device)
           for _ in range(k)]
    sh = min(s0 // int(cfg["model"]["sh_degree_interval"]),
             int(cfg["sh_degree"]))
    p0 = {f: scene.state[f] for f in PROGRAM_FIELDS}
    losses, first, p, event = R.train_steps(
        p0, scene.state["alive"], [ref_cam(scene, i) for i in idx],
        [scene.targets[i] for i in idx], bgs, s0, sh, cfg["model"],
        cfg["optim"], frames, lowp=lowp)
    grads = {f: float(torch.linalg.norm(first[f].double()))
             for f in PROGRAM_FIELDS}
    return {"losses": losses, "grads": grads,
            "change": _change_norms(p, p0), "event": event}


def event_numbers(prog: R.Event, ref: R.Event) -> Dict[str, float]:
    """refine_removed_gap: the rows that one side's refinement removed or
    rewrote and the other's did not, over the reference's count;
    refine_added_gap: the worst of the relative gaps of the number of rows
    added and of their summed means and scales."""
    a, b = prog.removed.to(ref.removed.device), ref.removed
    n_ref = int(b.sum())
    gaps = [abs(prog.added - ref.added) / max(ref.added, 1)]
    pa = prog.added_sum.to(ref.added_sum.device)
    gaps += ((pa - ref.added_sum).abs()
             / ref.added_sum.abs().clamp_min(1e-12)).tolist()
    return {"refine_removed_gap": int((a ^ b).sum()) / max(n_ref, 1),
            "refine_added_gap": max(gaps)}


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """loss_gap: the worst step's relative loss gap; change_gap: the worst
    leaf's gap of the norms of the change after the checked steps, before
    the refinement that follows them; grad_gap_median: the median leaf's
    gap of the first gradient's norms (the worst leaf's swings with the
    rounding of the program's packed per-pair gradients on its
    quaternions, see PERF.md); and the refinement's `event_numbers`. A
    leaf's gap is taken against the larger of its reference norm and the
    median leaf's. Leaves whose reference gradient is under a thousandth
    of the median leaf's (no gradient reaches them) are left out of
    both."""
    med = float(np.median(list(ref["grads"].values())))
    keep = [f for f in PROGRAM_FIELDS if ref["grads"][f] >= 1e-3 * med]
    return {
        **event_numbers(prog["event"], ref["event"]),
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap_median": float(np.median(
            leaf_gaps(prog["grads"], ref["grads"], keep))),
        "change_gap": max(leaf_gaps(prog["change"], ref["change"], keep)),
    }


def _refine_timers(trainer, refine_every: int, warmup: int,
                   sink: Dict[str, float]) -> Callable:
    """Wrap the Trainer's refinement and eval image in host-clock spans
    (bracketed by synchronisations where they do work); returns the
    function that removes the wrappers."""
    dev = trainer.device
    orig_ref, orig_eval = trainer._refinement, trainer.eval_image

    def refinement(camera):
        s = trainer.step
        if s <= warmup or s % refine_every:
            return orig_ref(camera)
        sync(dev)
        t = time.perf_counter()
        try:
            return orig_ref(camera)
        finally:
            sync(dev)
            sink["refine_s"] += time.perf_counter() - t

    def eval_image(*a, **kw):
        sync(dev)
        t = time.perf_counter()
        try:
            return orig_eval(*a, **kw)
        finally:
            sync(dev)
            sink["refine_s"] += time.perf_counter() - t

    trainer._refinement, trainer.eval_image = refinement, eval_image

    def remove():
        del trainer._refinement, trainer.eval_image

    return remove


def _train_work(trainer, scene, cfg, frames_idx, device) -> Dict:
    """The reference's per-step work, averaged over `frames_idx`, on the
    Trainer's state as it stands."""
    p = {f: getattr(trainer.params, f).detach().clone()
         for f in PROGRAM_FIELDS}
    alive = trainer.alive.clone()
    bg = torch.zeros(3, device=device)
    tot: Dict[str, float] = {}
    for i in frames_idx:
        _, w, _ = R.render(p, alive, ref_cam(scene, i), bg,
                           int(cfg["sh_degree"]), stats=True)
        for k, v in w.items():
            tot[k] = tot.get(k, 0) + v
    n_alive = int(alive.sum())
    del p, alive
    return {k: v / len(frames_idx) for k, v in tot.items()}, n_alive


def run_train(cfg: Dict, mix: Dict, limits: Dict, seed: int,
              seconds: float, trace: bool, device, t_start: float,
              fault: Optional[Callable] = None) -> Outcome:
    fault_ctx = fault() if fault else contextlib.nullcontext()
    with fault_ctx:
        trainer, scene, prog = train_setup(cfg, mix, seed, device, t_start)
        with quiet():
            for _ in range(int(mix["warmup_steps"])
                           - int(mix["checked_steps"])):
                trainer.train(num_steps=1, log_every=1 << 30)
            trainer.eval_image(0)
        sync(device)
        setup_s = time.perf_counter() - t_start
        note(t_start, "set up")
        model = cfg["model"]
        sink = {"refine_s": 0.0}
        remove = (_refine_timers(trainer, int(model["refine_every"]),
                                 int(model["warmup_length"]), sink)
                  if trace else None)
        chunk = int(mix["chunk_steps"])
        s0 = trainer.step
        t0 = time.perf_counter()
        nonfinite = 0
        marks = [t0]
        with quiet():
            while True:
                trainer.train(num_steps=chunk, log_every=1 << 30)
                if not math.isfinite(trainer._history[-1]["loss"]):
                    nonfinite += chunk
                marks.append(time.perf_counter())
                if marks[-1] - t0 >= seconds:
                    break
        sync(device)
        elapsed = time.perf_counter() - t0
        steps = trainer.step - s0
        per = np.diff(marks) * 1e3 / chunk
        note(t_start, f"window: {steps} steps in {elapsed:.3f} s; ms a step "
             f"by chunk: quartiles {np.percentile(per, [25, 50, 75])}, "
             f"max {per.max():.2f}; alive {int(trainer.alive.sum())}, "
             f"capacity {trainer.params.capacity}")
        if remove:
            remove()
        red, ctx, peak = None, None, 0
        if trace:
            ps = int(mix["profile_steps"])
            first = trainer.step
            frames = int(cfg["frames"])
            stretch = [(first + k) % frames for k in range(ps)]
            pick = stretch[::max(1, ps // int(mix["work_frames"]))]
            # the reference's count of the work is no part of the
            # program's peak
            peak = peak_bytes(device)
            avg, n_alive = _train_work(trainer, scene, cfg, pick, device)
            if torch.device(device).type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            with T.spans_installed(), T.profiled() as pr, quiet():
                trainer.train(num_steps=ps, log_every=1 << 30)
            red = T.reduce_trace(pr["prof"], pr["wall_s"])
            note(t_start, f"spans (device s): {red['span_device_s']}")
            ctx = {"units": ps, "trace": red,
                   "work": avg, "n_gauss": n_alive,
                   "n_tiles": (-(-scene.intr["width"] // 16))
                   * (-(-scene.intr["height"] // 16)),
                   "pixels": scene.intr["width"] * scene.intr["height"],
                   "untraced_unit_s": elapsed / steps,
                   "refine_s": sink["refine_s"], "window_units": steps}
    peak = max(peak, peak_bytes(device))
    del trainer
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = train_reference(cfg, mix, scene, lowp=False)
    nums = train_numbers(prog, ref)
    return Outcome(end_to_end={"setup_s": setup_s,
                               "step_ms": 1e3 * elapsed / steps},
                   attempted=steps, failed=nonfinite,
                   checks=judge(nums, limits), memory_peak=peak, trace=red,
                   layer_ctx=ctx)


# -- rendering ------------------------------------------------------------


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
    p = {f: scene.state[f] for f in PROGRAM_FIELDS}
    bg = torch.zeros(3, device=scene.state["means"].device)
    out = {}
    for i in frames:
        o, _, _ = R.render(p, scene.state["alive"], ref_cam(scene, i), bg,
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
                          [ref_cam(scene, i) for i in range(len(cams))])
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


def run_render(cfg: Dict, mix: Dict, limits: Dict, seed: int,
               seconds: float, trace: bool, device, t_start: float,
               fault: Optional[Callable] = None) -> Outcome:
    from dnsplatter_torch.models import dn_model

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
            with T.spans_installed(), T.profiled() as pr:
                for i in idx:
                    with T.record_function("get_outputs"):
                        out = frame(i)
                    sync(device)
                    tr = time.perf_counter()
                    {k: out[k].cpu() for k in keys}
                    readback += time.perf_counter() - tr
            red = T.reduce_trace(pr["prof"], pr["wall_s"])
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
            _, w, _ = R.render(p, scene.state["alive"], ref_cam(scene, i),
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


DRIVERS = {"train": run_train, "render": run_render}
