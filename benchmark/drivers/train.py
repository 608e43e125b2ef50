"""The `train` traffic's driver: training steps through `Trainer.train`.

The Trainer resumes from the benchmark's state through its own checkpoint
loader, and its first `checked_steps` steps go through the window's own
call (`Trainer.train`), one at a time, so the check can read the loss of
each, the first gradient from Adam's state, and the state before and
after the refinement that follows the last. The window then drives
`Trainer.train(chunk_steps)` until `--seconds` have passed. Once the
program's state is freed, the configuration's plain reference
(`cells.reference`) follows the checked steps from the same state.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from harness import cells
from harness import scene as S
from harness import trace as T
from harness.driving import (PROGRAM_FIELDS, Frames, Outcome,
                             checkpoint_buffer, judge, leaf_gaps, note,
                             peak_bytes, program_cameras, quiet, ref_cam,
                             sync)


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


def _event_tap(R, trainer, start: Dict[str, torch.Tensor], out: Dict):
    """A wrapper of the Trainer's refinement that reads, for the check,
    the change of the state before it (`change`) and what it did to the
    rows (`event`, as the reference's `R.Event` has it)."""
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
                trainer._refinement = _event_tap(cells.reference(cfg),
                                                 trainer, st, last)
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
    R = cells.reference(cfg)
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
        p0, scene.state["alive"], [ref_cam(R, scene, i) for i in idx],
        [scene.targets[i] for i in idx], bgs, s0, sh, cfg["model"],
        cfg["optim"], frames, lowp=lowp)
    grads = {f: float(torch.linalg.norm(first[f].double()))
             for f in PROGRAM_FIELDS}
    return {"losses": losses, "grads": grads,
            "change": _change_norms(p, p0), "event": event}


def event_numbers(prog, ref) -> Dict[str, float]:
    """refine_removed_gap: the rows that one side's refinement removed or
    rewrote and the other's did not, over the reference's count;
    refine_added_gap: the worst of the relative gaps of the number of rows
    added and of their summed means and scales. Both events are the
    reference's `Event`."""
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
    R = cells.reference(cfg)
    p = {f: getattr(trainer.params, f).detach().clone()
         for f in PROGRAM_FIELDS}
    alive = trainer.alive.clone()
    bg = torch.zeros(3, device=device)
    tot: Dict[str, float] = {}
    for i in frames_idx:
        _, w, _ = R.render(p, alive, ref_cam(R, scene, i), bg,
                           int(cfg["sh_degree"]), stats=True)
        for k, v in w.items():
            tot[k] = tot.get(k, 0) + v
    n_alive = int(alive.sum())
    del p, alive
    return {k: v / len(frames_idx) for k, v in tot.items()}, n_alive


def run(cfg: Dict, mix: Dict, limits: Dict, seed: int, seconds: float,
        trace: bool, device, t_start: float,
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
            with T.spans_installed(T.SPANS), T.profiled() as pr, quiet():
                trainer.train(num_steps=ps, log_every=1 << 30)
            red = T.reduce_trace(pr["prof"], pr["wall_s"], T.LABELS)
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
