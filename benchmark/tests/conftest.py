"""Shared pieces of the benchmark's tests: the harness on the import path,
a tiny copy of a cell's configuration for CPU runs, and the `card`
fixture that skips a test without an NVIDIA card."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny(config: str, n: int = 6000, tiles: int = 4) -> dict:
    """The configuration at a size the CPU runs in seconds: `n` Gaussians
    (capacity 1.25 n, rounded up to 4096), frames of `tiles` x 3/4
    `tiles` tiles at the configuration's field of view, 6 frames on the
    path."""
    from harness import cells

    cfg = cells.config(cells.load_benchmark(), config)
    w = 16 * tiles
    h = 12 * tiles
    cfg.update(num_gaussians=n, capacity=-(-int(1.25 * n) // 4096) * 4096,
               width=w, height=h,
               focal=cfg["focal"] * w / cfg["width"], frames=6)
    return cfg


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark measures only there")
    return torch.device("cuda")
