"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a GPU every test here skips (the kernels have no CPU mode).
Tolerances: expand_segments bit-equal (it copies 32-bit words);
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
