"""Spans and the device trace of a run's profiled stretch.

The benchmark records its spans from its own files: in a traced run it
wraps attributes of the program's modules with
`torch.profiler.record_function` (a driver's span table; `SPANS`, the
pattern of the program's `scripts/profile_frame.TRAIN_STAGES`, frozen
here, is the `train` and `render` drivers'), profiles a short steady
stretch with CPU and CUDA activity, and reduces the trace to:

* the device time of the kernels launched inside each span;
* the device-busy time, the union of all device operations' intervals;
* the device operations that took most time, and the longest idle gaps,
  each named by the innermost span the host was in when the gap began.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import time
from typing import Callable, Dict, Iterator, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

# (module, attribute, span): each is wrapped in a profiler range of that
# name for the profiled stretch. The Gaussian drivers' table; a driver of
# another kind passes its own.
SPANS = (
    ("dnsplatter_torch.train.trainer", "get_outputs", "get_outputs"),
    ("dnsplatter_torch.ops.rasterize", "bin_gaussians", "bin_gaussians"),
    ("dnsplatter_torch.ops.rasterize_cuda", "forward_tiles",
     "forward_tiles"),
    ("dnsplatter_torch.train.trainer", "compute_loss", "compute_loss"),
    ("torch.autograd", "grad", "autograd_grad"),
    ("dnsplatter_torch.ops.rasterize_cuda", "backward_tiles",
     "backward_tiles"),
    ("dnsplatter_torch.train.trainer", "adam_step", "adam_step"),
    ("dnsplatter_torch.train.trainer", "update_stats", "update_stats"),
)
LABELS = tuple(label for _, _, label in SPANS)


def _ranged(fn: Callable, label: str) -> Callable:
    def wrapped(*a, **kw):
        with record_function(label):
            return fn(*a, **kw)
    return wrapped


@contextlib.contextmanager
def spans_installed(spans: Tuple[Tuple[str, str, str], ...]
                    ) -> Iterator[None]:
    """Every (module, attribute, label) entry of `spans` wrapped for the
    duration."""
    saved = []
    try:
        for mod, attr, label in spans:
            m = importlib.import_module(mod)
            fn = getattr(m, attr)
            saved.append((m, attr, fn))
            setattr(m, attr, _ranged(fn, label))
        yield
    finally:
        for m, attr, fn in reversed(saved):
            setattr(m, attr, fn)


@contextlib.contextmanager
def profiled() -> Iterator[Dict]:
    """Profile the body; on exit the dict holds `prof` and `wall_s`, the
    body's host-clock time ended by a synchronisation."""
    out: Dict = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield out
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
    out["prof"] = prof


def _union(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _is_runtime_call(name: str) -> bool:
    """A CUDA runtime or driver call (a launch, copy or memset), whose
    correlation id the device operation it issued shares."""
    return name.startswith(("cuda", "cu")) and not name.startswith("cub")


def reduce_trace(prof, wall_s: float, labels: Tuple[str, ...]) -> Dict:
    """The profiled stretch's numbers, times in seconds: `span_device_s`
    {span: device time of the operations launched inside it}, for the
    span labels of the driver's table (`labels`), `busy_s`,
    `window_s`, `kernels` (launches), `device_ops` and `idle_gaps` (top
    10 each).

    A device operation belongs to a span when the runtime call that issued
    it (the CUDA launch, copy or memset, which the profiler records with
    the operation's correlation id) started inside one of the span's host
    ranges, on any thread: the autograd engine launches the backward's
    kernels from threads of its own while the span's thread waits in
    `torch.autograd.grad`, and the port's kernels are launched through
    ctypes, outside any torch operator."""
    dev_ops, host_spans, launch_at = [], [], {}
    for e in prof.events():
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            if e.name not in labels:
                dev_ops.append((s, t, e.name, e.id))
            continue
        if e.name in labels:
            host_spans.append((s, t, e.name))
        elif _is_runtime_call(e.name):
            launch_at[e.id] = s
    if not dev_ops:
        raise RuntimeError("the profiler recorded no device activity")
    dev_ops.sort()
    span_s = {}
    for label in labels:
        ivs = sorted((s, t) for s, t, n in host_spans if n == label)
        if not ivs:
            continue
        starts = [s for s, _ in ivs]
        total = 0.0
        for s, t, _, cid in dev_ops:
            at = launch_at.get(cid, s)
            k = bisect.bisect_right(starts, at) - 1
            if k >= 0 and at < ivs[k][1]:
                total += t - s
        span_s[label] = total
    by_name: Dict[str, float] = {}
    for s, t, name, _ in dev_ops:
        by_name[name] = by_name.get(name, 0.0) + (t - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, end = [], dev_ops[0][0]
    for s, t, _, _ in dev_ops:
        if s > end:
            gaps.append((s - end, end))
        end = max(end, t)
    gaps.sort(reverse=True)

    def host_label(at: float) -> str:
        inside = [(t - s, name) for s, t, name in host_spans if s <= at < t]
        return min(inside)[1] if inside else "outside_spans"

    idle = [[host_label(at), g] for g, at in gaps[:10]]
    kernels = sum(1 for _, _, n, _ in dev_ops
                  if not n.startswith(("Memcpy", "Memset")))
    return {"span_device_s": span_s,
            "busy_s": _union([(s, t) for s, t, _, _ in dev_ops]),
            "window_s": wall_s, "kernels": kernels,
            "device_ops": [[n[:120], v] for n, v in top],
            "idle_gaps": idle}
