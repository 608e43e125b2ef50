"""Profiling helpers (counterpart of dnsplatter_tpu/utils/profiling.py).

The reference exposes nerfstudio's `@profiler.time_function` plus rays/s
and fps timers. Here: a `torch.profiler` trace (host and CUDA activities,
kernel timelines viewable in Perfetto or chrome://tracing) plus
accumulating wall-clock section timers.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: Path) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU activity, and CUDA where a card is present)
    and write a Chrome trace, `trace.json`, into `log_dir`. Yields the
    profiler, whose `events()` / `key_averages()` the caller may read."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


class SectionTimers:
    """Accumulating wall-clock timers (the time_function equivalent)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "mean_ms": round(1e3 * self.totals[k]
                                 / max(self.counts[k], 1), 3),
            }
            for k in sorted(self.totals)
        }


def rays_per_sec(width: int, height: int, seconds: float) -> float:
    """The reference's eval throughput metric."""
    return width * height / max(seconds, 1e-9)
