"""The program's recorder of spans and counters, and its `torch.profiler`
trace (counterpart of dnsplatter_tpu/utils/profiling.py).

The reference exposes nerfstudio's `@profiler.time_function` plus rays/s
and fps timers. Here one recorder serves every stage of the training step
and the served frame:

* `span(name)` brackets a stage (the names are `SPANS`). While recording,
  a span keeps its host start and end (`perf_counter_ns`), its parent (the
  innermost span open on its thread; on the autograd engine's thread, the
  span open around the `torch.autograd.grad` call that started the
  backward), its stream time (a pair of pooled CUDA events recorded on the
  current stream at entry and exit, read on the device's clock), and a
  range on the profiler's clock, in the same trace as the device
  operations. The range is a plain host range: a `record_function` range
  would also be mirrored onto the device's timeline as an annotation,
  which a trace reader would count as a device operation.
* `count(name, v)` adds to a counter (`COUNTERS`); a device scalar is kept
  as it is and summed when the record is read, so counting launches
  nothing.
* `host_read(site, fn, *args)` makes a blocking device-to-host read and
  counts it as `sync.<site>`.

The recorder is on while a `torch.profiler` records (so `trace()` and any
profiled stretch record) or inside `recording()`. Off, `span` returns one
shared no-op context after one check and `count` returns at once: no
allocation, lock, device operation or event. `record()` synchronises
once, resolves the events and sums: `{"spans": {name: {n, host_ms,
stream_ms, parent}}, "counters": {name: total}}`, the counters including
`launch.<wrapper>`, the increase of `ops/rasterize_cuda.LAUNCHES` while
recording. `reset()` clears the record. What is kept is bounded: past
`MAX_ENTRIES` spans the oldest are folded into the sums.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import torch

# Span name: what it brackets.
SPANS = {
    "train.data": "Trainer.train: the frame's camera and targets "
                  "(data.get, _downscaled, _device_batch)",
    "train.step": "train_step: one optimizer step",
    "train.forward": "the step's render (outputs_fn)",
    "train.loss": "the step's compute_loss",
    "train.backward": "the step's torch.autograd.grad call",
    "train.optim": "apply_gradients (Adam, densification statistics) and "
                   "the pose optimizer",
    "train.refine": "Trainer._refinement where it acts",
    "train.eval": "Trainer.eval_image",
    "train.log": "Trainer.train's log block (the loss and the alive count "
                 "read back)",
    "model.outputs": "dn_model.get_outputs: one frame",
    "render.screen": "render.screen_space: projection, SH, normals",
    "render.finish": "tiles to image, render.finish, outputs_dict",
    "raster.bin": "rasterize.bin_gaussians",
    "raster.payload": "the payload table's gather in _raster_fwd",
    "raster.tiles": "the forward_tiles kernel's call",
    "raster.backward": "_RasterizeFn.backward",
    "raster.reduce": "the backward's sort and reduction to per-Gaussian "
                     "gradients",
    "raster.live_slots": "rasterize.live_pair_slots",
}

# Counter name: what it counts, where.
COUNTERS = {
    "project.rows": "capacity rows screen_space computes",
    "project.visible": "of them, in the frustum, alive and in the crop box",
    "bin.calls": "bin_gaussians' calls",
    "bin.pairs_listed": "(Gaussian, tile) pairs bin_gaussians listed, "
                        "before the capacity drop",
    "bin.pair_capacity": "the pair capacity those binnings had",
    "bwd.pairs_listed": "pairs listed by the binnings whose backward ran",
    "bwd.live_slots": "pair slots the backward's reduction by key read",
    "sync.<site>": "blocking device-to-host reads, by site (host_read)",
    "launch.<wrapper>": "rasterize_cuda.LAUNCHES' increase while recording",
}

# Spans kept unresolved before the oldest are folded into the sums.
MAX_ENTRIES = 4096
# Device scalars kept per counter before they are summed on the device.
MAX_PENDING = 1024

_profiler_enabled = torch.autograd._profiler_enabled
_host_range = torch._C._profiler._RecordFunctionFast
_graph_task_id = torch._C._current_graph_task_id  # -1 off the engine
_OFF = contextlib.nullcontext()

_lock = threading.Lock()
_local = threading.local()
_forced = 0  # depth of recording() blocks
_entries: collections.deque = collections.deque()  # open order
_sums: Dict[str, list] = {}  # name -> [n, host_ns, stream_ms, parents]
_counts: Dict[str, float] = {}
_pending: Dict[str, List[torch.Tensor]] = {}
_grad_callers: List["_Span"] = []  # spans open around a backward call
_events: List[torch.cuda.Event] = []  # the pool
_launch0: Optional[Dict[str, int]] = None
_launch1: Optional[Dict[str, int]] = None


def enabled() -> bool:
    """Whether the recorder records (a profiler records, or inside
    `recording()`)."""
    return bool(_forced) or _profiler_enabled()


def _launches() -> Dict[str, int]:
    from dnsplatter_torch.ops import rasterize_cuda

    return dict(rasterize_cuda.LAUNCHES)


def _started() -> None:
    """Under the lock: the launch counts at the first span or count."""
    global _launch0, _launch1
    if _launch0 is None:
        _launch0 = _launch1 = _launches()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "grad", "parent", "t0", "t1", "ev", "range")

    def __init__(self, name: str, grad: bool):
        self.name, self.grad = name, grad
        self.t1 = None
        self.ev = None

    def __enter__(self):
        st = _stack()
        parent = st[-1] if st else None
        with _lock:
            _started()
            if parent is None and _grad_callers and _graph_task_id() >= 0:
                parent = _grad_callers[-1]
            if torch.cuda.is_initialized():
                self.ev = [_events.pop() if _events
                           else torch.cuda.Event(enable_timing=True)
                           for _ in range(2)]
            _entries.append(self)
            if self.grad:
                _grad_callers.append(self)
        self.parent = parent
        st.append(self)
        self.range = _host_range(self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        if self.ev is not None:
            self.ev[0].record()
        return self

    def __exit__(self, *exc):
        global _launch1
        if self.ev is not None:
            self.ev[1].record()
        self.t1 = time.perf_counter_ns()
        self.range.__exit__(None, None, None)
        st = _stack()
        st.pop()
        with _lock:
            if self.grad and self in _grad_callers:
                _grad_callers.remove(self)
            if not st:
                _launch1 = _launches()
            while len(_entries) > MAX_ENTRIES and _entries[0].t1 is not None:
                _fold(_entries.popleft())
        return False


def span(name: str, grad: bool = False):
    """A context that records the stage `name` while recording, and does
    nothing otherwise. `grad`: the block calls `torch.autograd.grad`, and
    spans the autograd engine's threads open take it as their parent."""
    if not (_forced or _profiler_enabled()):
        return _OFF
    return _Span(name, grad)


def count(name: str, v=1) -> None:
    """Add `v` (a number or a device scalar, kept unread) to a counter
    while recording."""
    if not (_forced or _profiler_enabled()):
        return
    if isinstance(v, torch.Tensor):
        v = v.detach()
    with _lock:
        _started()
        if not isinstance(v, torch.Tensor):
            _counts[name] = _counts.get(name, 0) + v
            return
        vals = _pending.setdefault(name, [])
        vals.append(v)
        if len(vals) > MAX_PENDING:
            vals[:] = [torch.stack([t.reshape(()).double()
                                    for t in vals]).sum()]


def host_read(site: str, fn, *args):
    """`fn(*args)`, a read that blocks the host until the device has
    caught up, counted as `sync.<site>` while recording."""
    if _forced or _profiler_enabled():
        count("sync." + site)
    return fn(*args)


def _fold(e: _Span) -> None:
    """Under the lock: a closed span into the sums."""
    s = _sums.get(e.name)
    if s is None:
        s = _sums[e.name] = [0, 0, None, collections.Counter()]
    s[0] += 1
    s[1] += e.t1 - e.t0
    if e.ev is not None:
        e.ev[1].synchronize()
        s[2] = (s[2] or 0.0) + e.ev[0].elapsed_time(e.ev[1])
        _events.extend(e.ev)
        e.ev = None
    s[3][e.parent.name if e.parent is not None else None] += 1


def record() -> Dict[str, Dict]:
    """The record so far: `spans` {name: {n, host_ms, stream_ms (None
    without a card), parent (the most frequent)}} of the closed spans, and
    `counters` {name: total}. Synchronises once."""
    with _lock:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        still_open = [e for e in _entries if e.t1 is None]
        for e in _entries:
            if e.t1 is not None:
                _fold(e)
        _entries.clear()
        _entries.extend(still_open)
        by_dev: Dict[torch.device, list] = {}
        for name, vals in _pending.items():
            for v in vals:
                by_dev.setdefault(v.device, []).append((name, v))
        for items in by_dev.values():
            host = torch.stack([v.reshape(()).double()
                                for _, v in items]).cpu().tolist()
            for (name, _), x in zip(items, host):
                _counts[name] = _counts.get(name, 0) + x
        _pending.clear()
        counts = {k: int(v) if float(v).is_integer() else v
                  for k, v in _counts.items()}
        if _launch0 is not None:
            for k, v in _launch1.items():
                if v > _launch0.get(k, 0):
                    counts[f"launch.{k}"] = v - _launch0.get(k, 0)
        spans = {name: {"n": n, "host_ms": ns / 1e6, "stream_ms": ms,
                        "parent": parents.most_common(1)[0][0]}
                 for name, (n, ns, ms, parents) in _sums.items()}
    return {"spans": spans, "counters": counts}


def reset() -> None:
    """Clear the record (spans open now are dropped when they close)."""
    global _launch0, _launch1
    with _lock:
        for e in _entries:
            if e.ev is not None and e.t1 is not None:
                _events.extend(e.ev)
        _entries.clear()
        _sums.clear()
        _counts.clear()
        _pending.clear()
        _grad_callers.clear()
        _launch0 = _launch1 = None


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record inside the block, the record cleared at the outermost
    entry; read it with `record()`."""
    global _forced
    with _lock:
        outer = _forced == 0
    if outer:
        reset()
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


@contextlib.contextmanager
def trace(log_dir: Path) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU activity, and CUDA where a card is present)
    and write a Chrome trace, `trace.json`, into `log_dir`. Yields the
    profiler, whose `events()` / `key_averages()` the caller may read. The
    recorder records the block: `record()` reads it afterwards, and the
    trace holds each span as a host range."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    reset()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def rays_per_sec(width: int, height: int, seconds: float) -> float:
    """The reference's eval throughput metric."""
    return width * height / max(seconds, 1e-9)
