"""The `prior` kind's driver, the DSINE-B5 reference and their check, at a
CPU size: DSINE's decoder and refinement narrowed (bottleneck 64), the B5
at its published widths, 64x96 frames, 6 of them. The check passes the
program, and fails each planted fault and the reference computed in
bfloat16 (the card's TF32 control has no CPU counterpart). The work count
is held against PyTorch's own count of the reference's forward."""

from __future__ import annotations

import ast
import time

import numpy as np
import pytest
import torch

import calibrate_prior
from drivers import prior as PD
from harness import cells

from conftest import ROOT

NARROW = {"nf": 64, "feature_dim": 16, "hidden_dim": 16, "head_hidden": 32,
          "nrn_hidden": 16}
SEED = 2**31 + 11


def _cell():
    """The cell's configuration at the CPU size, its mix and limits."""
    bench = cells.load_benchmark()
    w = cells.workload(bench, "dsine_b5.infer")
    cfg = cells.config(bench, w["config"])
    cfg.update(widths=NARROW, width=96, height=64,
               focal=cfg["focal"] * 96 / cfg["width"], frames=6)
    return cfg, cells.traffic(w["traffic"]), cells.limits(w["name"])


def _run(fault=None):
    torch.set_num_threads(1)
    cfg, mix, lim = _cell()
    oc = cells.driver(mix["kind"]).run(cfg, mix, lim, SEED, 0.3, False,
                                       "cpu", time.perf_counter(),
                                       fault=fault)
    return oc


def test_program_passes_the_check():
    oc = _run()
    assert oc.attempted >= 1 and oc.failed == 0
    assert all(c["value"] <= c["limit"] for c in oc.checks.values()), \
        oc.checks
    assert set(oc.end_to_end) == {"setup_s", "render_fps", "render_p95_ms"}


@pytest.mark.parametrize("fault", sorted(calibrate_prior.FAULTS))
def test_planted_faults_fail(fault):
    oc = _run(calibrate_prior.FAULTS[fault])
    assert any(c["value"] > c["limit"] for c in oc.checks.values()), \
        oc.checks


def test_bfloat16_reference_fails():
    torch.set_num_threads(1)
    cfg, mix, lim = _cell()
    R = cells.reference(cfg)
    arrays, frames, K = PD.prior_inputs(cfg, SEED)
    sample = PD.prior_sample(cfg, mix, SEED)
    want = PD.prior_reference(R, arrays, frames, sample, K, "cpu")
    low = PD.prior_reference(R, arrays, frames, sample, K, "cpu",
                             dtype=torch.bfloat16)
    nums = PD.prior_numbers(low, want)
    assert any(nums[k] > v for k, v in lim.items()), nums


@pytest.mark.parametrize("hw", [(576, 1024), (64, 96), (70, 100)])
def test_flops_is_the_counted_work(hw):
    """`flops` against `FlopCounterMode` over the reference's forward at
    the published widths, on meta tensors (shapes only): within 1%, the
    elementwise products it counts besides being a few in 10^5."""
    from torch.utils.flop_counter import FlopCounterMode

    from dnsplatter_torch.priors import dsine

    R = cells.reference(_cell()[0])
    with torch.device("meta"):
        shapes = dsine.DSINE().state_dict()
    arrays = {k: torch.empty(v.shape, device="meta")
              for k, v in shapes.items()}
    h, w = hw
    top, bottom, left, right = R.pad_to_32(h, w)
    img = torch.empty(1, 3, h + top + bottom, w + left + right,
                      device="meta")
    K = np.array([[700.0, 0, (w - 1) / 2], [0, 700.0, (h - 1) / 2],
                  [0, 0, 1]])
    with FlopCounterMode(display=False) as fc:
        R.forward(arrays, img, K)
    assert R.flops(h, w) == pytest.approx(fc.get_total_flops(), rel=0.01)


def test_span_labels_are_not_program_spans():
    from dnsplatter_torch.utils import profiling

    assert PD.LABELS == ("predict_normals", "dsine_forward")
    assert not set(PD.LABELS) & set(profiling.SPANS)
    # each labelled attribute exists where the table says
    import importlib

    for mod, attr, _ in PD.SPANS:
        assert callable(getattr(importlib.import_module(mod), attr))


def test_reference_imports_no_program():
    tree = ast.parse((ROOT / "benchmark" / "references" / "dsine_b5.py")
                     .read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in {
                "jax", "dnsplatter_tpu", "dnsplatter_torch"}, n
