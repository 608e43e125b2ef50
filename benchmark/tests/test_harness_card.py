"""On the card: a short run of a cell prints a correct result line."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_short_render_run(card, trace):
    proc = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload",
         "room_1m.render", "--seed", str(2**31 + 3), "--seconds", "2",
         "--trace", str(trace)], capture_output=True, text=True, cwd=ROOT,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0
        assert "render.kernels_per_frame" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"setup_s", "render_fps",
                                        "render_p95_ms"}
