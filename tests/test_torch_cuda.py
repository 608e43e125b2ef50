"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a GPU every test here skips (the kernels have no CPU mode).
Tolerances: expand_segments bit-equal (it copies 32-bit words);
backward_tiles and the four reductions by chip_smoke.py's checks
(`compare_backward`, `compare_reduce`), stated at each test;
cumsum_lanes_i32 bit-equal (integer adds);
forward_tiles by chip_smoke.py's check: image / t_final within 1e-4
(image: of its max) where `last` agrees; the kernel keeps a running
transmittance product, the plain version exp of summed log1p, so a few
pixels within rounding of the 1e-4 cutoff may stop one splat apart, and
each such pixel must show exactly that.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from dnsplatter_torch.data.synthetic import make_gt_gaussians, ring_cameras
from dnsplatter_torch.ops import rasterize_cuda as rc
from dnsplatter_torch.ops.projection import project_gaussians
from dnsplatter_torch.ops.rasterize import RasterizeConfig, rasterize
from dnsplatter_torch.ops.rasterize_ref import rasterize_pixels_ref


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _projected(dev, n=1500, width=160, height=120, seed=0):
    gt, _ = make_gt_gaussians(np.random.default_rng(seed), n, device=dev)
    cam = ring_cameras(1, width=width, img_height=height, focal=150.0,
                       device=dev)[0]
    proj = project_gaussians(gt.means, gt.quats, torch.exp(gt.scales),
                             cam.viewmat(), cam.fx, cam.fy, cam.cx, cam.cy,
                             width, height)
    feats = torch.rand(n, 7, device=dev,
                       generator=torch.Generator(dev).manual_seed(seed))
    return proj, torch.sigmoid(gt.opacities), feats


@pytest.mark.cuda
@pytest.mark.parametrize("n_segments", [300, 300_000])
def test_expand_segments_kernel_bit_equal(dev, n_segments):
    rng = np.random.default_rng(n_segments)
    lens = rng.integers(0, 6, n_segments)
    starts = torch.as_tensor(
        np.concatenate([[2], 2 + np.cumsum(lens)]).astype(np.int32),
        device=dev)
    out_len = int(starts[-1]) + 77
    ints = torch.as_tensor(
        rng.integers(-2**31, 2**31 - 1, (5, n_segments)).astype(np.int32),
        device=dev)
    # the resident entry with its threshold lifted, so it launches itself
    for entry, kw in ((rc.expand_segments, {"resident_max": 1 << 30}),
                      (rc.expand_segments_stream, {})):
        for vals in (ints, ints.float() * 1e-3):
            before = rc.LAUNCHES[entry.__name__]
            k = entry(vals, starts, out_len, out_dtype=vals.dtype, **kw)
            p = rc.expand_segments_plain(vals, starts, out_len,
                                         out_dtype=vals.dtype)
            assert torch.equal(k.view(torch.int32), p.view(torch.int32))
            assert rc.LAUNCHES[entry.__name__] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [32, 128])
def test_forward_tiles_kernel_matches_plain(dev, chunk):
    proj, op, feats = _projected(dev)
    cfg = RasterizeConfig(width=160, height=120, chunk=chunk,
                          pair_capacity=1 << 16)
    with torch.no_grad(), mock.patch.object(
            rc, "forward_tiles", wraps=rc.forward_tiles) as fwd:
        rasterize(proj.means2d, proj.conics, proj.depths, op, feats,
                  proj.valid, cfg, radii=proj.radii_xy)
    args = fwd.call_args.args
    got = rc.forward_tiles(*args)
    want = rc.forward_tiles_plain(*args)
    chip_smoke.compare_forward(got, want, args[0], args[4])


@pytest.mark.cuda
def test_kernel_path_matches_oracle(dev):
    proj, op, feats = _projected(dev, seed=1)
    cfg = RasterizeConfig(width=160, height=120, chunk=128,
                          pair_capacity=1 << 16)
    with torch.no_grad():
        img, alpha = rasterize(proj.means2d, proj.conics, proj.depths, op,
                               feats, proj.valid, cfg, radii=proj.radii)
    ref, ref_a = rasterize_pixels_ref(proj.means2d, proj.conics,
                                      proj.depths, op, feats, proj.valid,
                                      160, 120, radii=proj.radii)
    err = (img - ref).abs().amax(dim=-1)
    assert float((err > 1e-4).float().mean()) <= 1e-3
    assert float((alpha - ref_a).abs().max()) <= 1e-3
    assert float(alpha.mean()) > 0.1


def _backward_capture(dev, scheme, seed=2):
    """One backward through the autograd function on the card, the two
    backward kernels' arguments captured."""
    proj, op, feats = _projected(dev, seed=seed)
    cfg = RasterizeConfig(width=160, height=120, chunk=128,
                          pair_capacity=1 << 16, sort_scheme=scheme)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (proj.means2d, proj.conics, op, feats)]
    gen = torch.Generator(dev).manual_seed(seed)
    with mock.patch.object(rc, "backward_tiles",
                           wraps=rc.backward_tiles) as bwd, \
            mock.patch.object(rc, "reduce_segments_bykey",
                              wraps=rc.reduce_segments_bykey) as red:
        img, a = rasterize(leaves[0], leaves[1], proj.depths, leaves[2],
                           leaves[3], proj.valid, cfg, radii=proj.radii)
        loss = ((img * torch.randn(img.shape, device=dev, generator=gen)).sum()
                + (a * torch.randn(a.shape, device=dev, generator=gen)).sum())
        loss.backward()
    return bwd.call_args.args, red.call_args.args


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["depthq", "packed"])
def test_backward_tiles_kernel_matches_plain(dev, scheme):
    """chip_smoke.py's check: decoded slab within rel 2^-7 (+ 1e-4 of the
    row's largest value for sums that cancel), at most 0.1% of the elements
    beyond one bf16 ulp, integer zeros where the plain version has them,
    two runs bit-equal; the float32 rows within 1e-4 of each row's scale."""
    args, _ = _backward_capture(dev, scheme)
    before = rc.LAUNCHES["backward_tiles"]
    got = rc.backward_tiles(*args, pack_grads=True)
    assert rc.LAUNCHES["backward_tiles"] == before + 1
    assert torch.equal(got, rc.backward_tiles(*args, pack_grads=True))
    want = rc.backward_tiles_plain(*args, pack_grads=True)
    rep = chip_smoke.compare_backward(got, want, args[8])
    assert rep["elements"] > 10_000
    got32 = rc.backward_tiles(*args, pack_grads=False)
    want32 = rc.backward_tiles_plain(*args, pack_grads=False)
    assert got32.shape == want32.shape == (16, args[0].shape[1])
    scale = want32.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
    assert float(((got32 - want32).abs() / scale).max()) <= 1e-4
    assert torch.equal(got32 == 0, want32 == 0) or float(
        ((got32 == 0) != (want32 == 0)).float().mean()) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["depthq", "packed"])
def test_reduce_segments_bykey_kernel_matches_plain(dev, scheme):
    _, (slab, ru, n) = _backward_capture(dev, scheme)
    before = rc.LAUNCHES["reduce_segments_bykey"]
    got = rc.reduce_segments_bykey(slab, ru, n)
    assert rc.LAUNCHES["reduce_segments_bykey"] == before + 1
    assert torch.equal(got, rc.reduce_segments_bykey(slab, ru, n))
    chip_smoke.compare_reduce(got, rc.reduce_segments_bykey_plain(slab, ru,
                                                                  n))
    # sentinel lanes and an id without lanes
    keys = torch.tensor([0, 0, 2, 2, 2, 5, 5], dtype=torch.int32, device=dev)
    vals = torch.arange(1, 8, device=dev, dtype=torch.float32)
    vals[-2:] = 1e9
    word = rc.pack_bf16_2(vals, -vals)
    out = rc.reduce_segments_bykey(torch.stack([word, keys]), 1, 5)
    want = torch.tensor([[3.0, 0.0, 12.0, 0.0, 0.0],
                         [-3.0, 0.0, -12.0, 0.0, 0.0],
                         [3.0, 0.0, 12.0, 0.0, 0.0],
                         [3.0, 0.0, 12.0, 0.0, 0.0]], device=dev)
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_autograd_function_matches_oracle(dev):
    rep = chip_smoke.oracle_grad_check(dev)
    assert rep["depthq.means2d.max_scaled_err"] < 2e-2


@pytest.mark.cuda
def test_backward_wrappers_refuse_bad_inputs(dev):
    args, (slab, ru, n) = _backward_capture(dev, "depthq")
    bad = list(args)
    bad[3] = bad[3][:, :, :100]  # g_out with the wrong pixel count
    with pytest.raises(ValueError, match="g_out"):
        rc.backward_tiles(*bad)
    with pytest.raises(ValueError, match="ru"):
        rc.reduce_segments_bykey(slab, 9, n)
    with pytest.raises(ValueError, match="slab"):
        rc.reduce_segments_bykey(slab.float(), ru, n)


def _random_ranges(rng, n, dev, max_len=12):
    lens = rng.integers(0, max_len, n)
    lens[rng.uniform(size=n) < 0.3] = 0
    lens[5] = 1500  # one long range, walked by a single thread
    return torch.as_tensor(
        np.concatenate([[0], np.cumsum(lens)]).astype(np.int32), device=dev)


def _random_packed(rng, pr, length, dev):
    vals = torch.as_tensor(
        rng.normal(size=(2 * pr, length)).astype(np.float32), device=dev)
    return torch.stack([rc.pack_bf16_2(vals[2 * i], vals[2 * i + 1])
                        for i in range(pr)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1000), (5, 2048), (3, 1_000_003)])
def test_cumsum_lanes_i32_kernel_bit_equal(dev, shape):
    """Integer adds: bit-equal to torch.cumsum at any magnitude, the int32
    wrap included; one block, exactly one tile, and many tiles with a
    ragged end."""
    rng = np.random.default_rng(shape[1])
    for lo, hi in ((-50, 60), (1 << 26, 1 << 28)):
        x = torch.as_tensor(rng.integers(lo, hi, shape).astype(np.int32),
                            device=dev)
        before = rc.LAUNCHES["cumsum_lanes_i32"]
        got = rc.cumsum_lanes_i32(x)
        assert rc.LAUNCHES["cumsum_lanes_i32"] == before + 1
        assert torch.equal(got, rc.cumsum_lanes_i32_plain(x))
    with pytest.raises(ValueError, match="contiguous"):
        rc.cumsum_lanes_i32(x.t())


@pytest.mark.cuda
@pytest.mark.parametrize("gw", [16, 15, 3])
def test_reduce_segments_kernel_matches_plain(dev, gw):
    """rtol 1e-5 / atol 1e-5 of the row's scale (the kernel adds a range in
    lane order, index_add_ in any order), exact zeros for empty ranges, two
    runs bit-equal; lanes past starts[N] hold 1e9 and are never read."""
    rng = np.random.default_rng(gw)
    n = 5000
    starts = _random_ranges(rng, n, dev)
    length = int(starts[-1]) + 100
    grads = torch.as_tensor(rng.normal(size=(gw, length)).astype(np.float32),
                            device=dev)
    grads[:, int(starts[-1]):] = 1e9
    before = rc.LAUNCHES["reduce_segments"]
    got = rc.reduce_segments(grads, starts, n)
    assert rc.LAUNCHES["reduce_segments"] == before + 1
    assert torch.equal(got, rc.reduce_segments(grads, starts, n))
    chip_smoke.compare_reduce(got, rc.reduce_segments_plain(grads, starts, n),
                              "reduce_segments")
    with pytest.raises(ValueError, match="grads"):
        rc.reduce_segments(grads.int(), starts, n)
    with pytest.raises(ValueError, match="boundaries"):
        rc.reduce_segments(grads, starts[:-1], n)


@pytest.mark.cuda
@pytest.mark.parametrize("pr", [7, 4, 1])
def test_reduce_segments_packed_kernel_matches_plain(dev, pr):
    """As `reduce_segments`, on bf16 pairs decoded in the kernel."""
    rng = np.random.default_rng(pr)
    n = 5000
    starts = _random_ranges(rng, n, dev)
    packed = _random_packed(rng, pr, int(starts[-1]) + 100, dev)
    packed[:, int(starts[-1]):] = 0x4E6E4E6E  # ~1e9 in both halves
    before = rc.LAUNCHES["reduce_segments_packed"]
    got = rc.reduce_segments_packed(packed, starts, n)
    assert rc.LAUNCHES["reduce_segments_packed"] == before + 1
    assert torch.equal(got, rc.reduce_segments_packed(packed, starts, n))
    chip_smoke.compare_reduce(
        got, rc.reduce_segments_packed_plain(packed, starts, n),
        "reduce_segments_packed")
    with pytest.raises(ValueError, match="packed"):
        rc.reduce_segments_packed(packed.float(), starts, n)


@pytest.mark.cuda
@pytest.mark.parametrize("kp,pr", [(4, 7), (2, 4)])
def test_reduce_segments_packed_multi_kernel_matches_plain(dev, kp, pr):
    rng = np.random.default_rng(kp)
    n = 5000
    starts = torch.stack([_random_ranges(rng, n, dev, max_len=4 + 3 * j)
                          for j in range(kp)])
    cp = int(starts[:, -1].max()) + 64
    packed = torch.stack([_random_packed(rng, pr, cp, dev)
                          for _ in range(kp)])
    for j in range(kp):
        packed[j, :, int(starts[j, -1]):] = 0x4E6E4E6E
    before = rc.LAUNCHES["reduce_segments_packed_multi"]
    got = rc.reduce_segments_packed_multi(packed, starts, n)
    assert rc.LAUNCHES["reduce_segments_packed_multi"] == before + 1
    assert torch.equal(got,
                       rc.reduce_segments_packed_multi(packed, starts, n))
    chip_smoke.compare_reduce(
        got, rc.reduce_segments_packed_multi_plain(packed, starts, n),
        "reduce_segments_packed_multi")
    with pytest.raises(ValueError, match="boundaries"):
        rc.reduce_segments_packed_multi(packed, starts[:1], n)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    {"compact_frac": 0.0, "sort_scheme": "packed32"},
    {"compact_frac": 0.0, "reduce_pieces": 4},
    {"grad_reduce": "segsum"},
    {"sort_scheme": "tilekey", "exact_cull": True},
])
def test_other_reductions_match_the_default_path(dev, kw):
    """Every route of the backward on the card against the default route
    (by key, compacted) on the same frame: the bf16 tolerance, rtol 2e-2 /
    atol 2e-3 of each array's largest magnitude."""
    proj, op, feats = _projected(dev, seed=4)
    gen = torch.Generator(dev).manual_seed(4)
    w_img = torch.randn(120, 160, 7, device=dev, generator=gen)
    grads = []
    for extra in ({}, kw):
        cfg = RasterizeConfig(width=160, height=120, chunk=128,
                              pair_capacity=1 << 16, **extra)
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (proj.means2d, proj.conics, op, feats)]
        img, a = rasterize(leaves[0], leaves[1], proj.depths, leaves[2],
                           leaves[3], proj.valid, cfg, radii=proj.radii)
        grads.append(torch.autograd.grad((img * w_img).sum() + a.sum(),
                                         leaves))
    for g0, g1 in zip(*grads):
        scale = float(g0.abs().max())
        assert scale > 0
        err = (g1 - g0).abs() / scale
        assert float((err - (2e-3 + 2e-2 * g0.abs() / scale)).max()) <= 0
