"""The reference's work counts and the roofline arithmetic against a hand
count on a one-tile scene."""

from __future__ import annotations

import math

import pytest
import torch

from harness import reference as R
from harness import work as W

CAM = R.Cam(c2w=torch.eye(4), fx=10.0, fy=10.0, cx=8.0, cy=8.0, width=16,
            height=16)


def _screen(opacities, depths):
    """Gaussians centred on the one tile, flat (conic 0), so that
    every pixel sees them at their opacity."""
    n = len(opacities)
    return R.Screen(
        means2d=torch.full((n, 2), 8.0),
        conics=torch.zeros(n, 3),
        opac=torch.tensor(opacities),
        feats=torch.arange(7 * n, dtype=torch.float32).reshape(n, 7) / 10,
        depth=torch.tensor(depths), valid=torch.ones(n, dtype=torch.bool),
        rxy=torch.full((n, 2), 8.0), radius=torch.full((n,), 8.0))


def test_one_translucent_gaussian():
    sc = _screen([0.5], [1.0])
    bins = R.bin_tiles(sc, CAM)
    img, alpha, w = R.rasterize(sc, bins, CAM, stats=True)
    assert w == {"fwd_visits": 256, "fwd_needed": 1, "accepted": 256,
                 "bwd_visits": 256, "bwd_replayed": 1}
    assert torch.allclose(alpha, torch.full_like(alpha, 0.5), atol=1e-6)
    assert torch.allclose(img[0, 0], 0.5 * sc.feats[0], atol=1e-6)
    fwd = W.forward_tiles(w, 1)
    assert fwd["ops"] == 256 * 28 + 256 * 2 * 7
    assert fwd["bytes"] == 1 * 13 * 4 + 3 * 4 + 256 * 9 * 4
    bwd = W.backward_tiles(w, 1)
    assert bwd["ops"] == 256 * 28 + 256 * (45 + 28 + 6 + 7)
    assert bwd["bytes"] == 1 * (13 + 7) * 4 + 3 * 4 + 256 * 10 * 4
    assert W.least_s(fwd) == max(fwd["ops"] / 67e12, fwd["bytes"] / 3.35e12)


def test_termination_ends_the_list():
    # the first (nearest) Gaussian clamps at alpha 0.999 (T -> 1e-3), the
    # second would take T to 5e-5 <= 1e-4: it ends the pixel uncomposited;
    # the third is never reached
    sc = _screen([1.0, 0.95, 0.5], [1.0, 2.0, 3.0])
    bins = R.bin_tiles(sc, CAM)
    assert bins.ids.tolist() == [0, 1, 2]
    img, alpha, w = R.rasterize(sc, bins, CAM, stats=True)
    assert w == {"fwd_visits": 2 * 256, "fwd_needed": 2, "accepted": 256,
                 "bwd_visits": 256, "bwd_replayed": 1}
    assert torch.allclose(alpha, torch.full_like(alpha, 0.999), atol=1e-6)


def test_depth_order_is_depthq():
    # listed in the opposite order of depth: the tile composites by depth
    sc = _screen([0.5, 0.5], [3.0, 1.0])
    bins = R.bin_tiles(sc, CAM)
    assert bins.ids.tolist() == [1, 0]
    img, _, _ = R.rasterize(sc, bins, CAM)
    want = 0.5 * sc.feats[1] + 0.25 * sc.feats[0]
    assert torch.allclose(img[3, 5], want, atol=1e-6)


def test_backward_matches_autograd_of_the_dense_sum():
    torch.manual_seed(0)
    n = 5
    sc = R.Screen(means2d=torch.rand(n, 2) * 16,
                  conics=torch.tensor([[0.05, 0.01, 0.04]] * n),
                  opac=torch.rand(n) * 0.8 + 0.1,
                  feats=torch.rand(n, 7), depth=torch.rand(n) + 1,
                  valid=torch.ones(n, dtype=torch.bool),
                  rxy=torch.full((n, 2), 16.0), radius=torch.full((n,), 16.0))
    bins = R.bin_tiles(sc, CAM)
    gi, ga = torch.rand(16, 16, 7), torch.rand(16, 16, 1)
    g, absgrad = R.rasterize_backward(sc, bins, CAM, gi, ga)
    leaves = [sc.means2d.requires_grad_(), sc.conics.requires_grad_(),
              sc.opac.requires_grad_(), sc.feats.requires_grad_()]
    img, alpha, _ = R._composite(*leaves, bins, torch.tensor([0]),
                                 int(bins.counts.max()), CAM, False, False)
    s = (img[0].reshape(16, 16, 7) * gi).sum() + (
        alpha[0].reshape(16, 16, 1) * ga).sum()
    want = torch.autograd.grad(s, leaves)
    for a, b in zip(g, want):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)
    # one tile: each Gaussian's absolute per-tile gradient is that of its
    # whole means2d gradient
    assert torch.allclose(absgrad, want[0].abs(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("units", [1, 20])
def test_roofline_share_arithmetic(units):
    from harness.cells import reader

    w = {"fwd_visits": 10_000_000, "fwd_needed": 100_000,
         "accepted": 2_000_000, "bwd_visits": 3_000_000,
         "bwd_replayed": 90_000}
    least = W.least_s(W.forward_tiles(w, 2304))
    ctx = {"units": units, "work": w, "n_tiles": 2304,
           "trace": {"span_device_s": {"forward_tiles": units * 2 * least}}}
    assert math.isclose(reader("train.forward_tiles_roofline")(ctx), 50.0)
    ctx["trace"]["span_device_s"]["forward_tiles"] = 0.0
    assert reader("train.forward_tiles_roofline")(ctx) is None


@pytest.mark.parametrize("name", ["train.idle_share", "render.idle_share"])
def test_idle_share_is_the_stretchs_own(name):
    """Busy and wall time of the same stretch: the share stays in [0,
    100] however the stretch compares with the untraced window."""
    from harness.cells import reader

    ctx = {"units": 50, "untraced_unit_s": 0.040,
           "trace": {"busy_s": 2.5, "window_s": 2.9}}
    assert math.isclose(reader(name)(ctx), 100.0 * (1 - 2.5 / 2.9))


def test_pair_counts_agree_with_binning():
    import sys
    sys.path.insert(0, str(__import__("conftest").BENCH_DIR))
    from conftest import tiny
    from harness import scene as S
    from harness.driving import ref_cam

    cfg = tiny("dnsplatter_room_1m")
    sc = S.make_scene(cfg, 3, "cpu", with_targets=False)
    p = {f: sc.state[f] for f in R.FIELDS}
    cams = [ref_cam(R, sc, i) for i in range(len(sc.c2ws))]
    counts = R.pair_counts(p, sc.state["alive"], cams)
    for cam, n in zip(cams, counts):
        scr = R.project(p, sc.state["alive"], cam, 0)
        want = R.bin_tiles(scr, cam).ids.shape[0]
        assert abs(n - want) <= max(2, want // 1000)
