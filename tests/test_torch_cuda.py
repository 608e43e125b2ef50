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
sh_colors (the kernel pair against `eval_sh` on the concatenated
coefficients, run by torch on the card): colours, d_features_dc and
d_features_rest within 1e-5 of the array's largest magnitude (about 100
float32 ulps: the kernel fuses each product and sum into one FMA and
normalizes the direction in its own order, where torch rounds every
elementwise op apart, so values move by a few ulps of the largest term);
d_dirs within 1e-4 of the largest magnitude over the ordinary rows, and of
its own row's for rows with a zero, tiny or small direction (the basis
derivatives sum up to 25 terms that cancel, then divide by |dirs|); the
coefficient rows past the active degree exactly zero. Random rows are kept
1e-3 or more from the colour clamp so that rounding cannot put the two
sides of one row on different sides of it; rows placed exactly on it must
agree (a tie passes the gradient).
project_screen (the kernel pair against `project_screen_plain`, run by
torch on the card, through autograd): radii, radii_xy and valid equal (the
forward rounds as torch's ops round, see csrc/project_screen.cu); means2d,
conics, depths, opacities and features within 1e-6 of each array's largest
magnitude (bit-equal with torch 2.11 on an H100; the bound leaves room for
another build's exp / log); the gradients of means, quats, scales,
opacities and colors within 1e-5 of each array's largest magnitude (the
backward's own order of operations: about 100 float32 ulps of the largest
term); the camera's (viewmat and c2w, summed over every row) within 1e-4 of
the largest.
ssim (the kernel pair against `losses.ssim_plain`, run by torch on the card,
through autograd): the per-pixel map bit-equal to `ssim_map_plain` (the
kernel rounds each product and sum where torch's ops round them, in their
order), the mean within 1e-6 relative (the kernel sums in float64, torch in
float32), d img1 within 1e-5 of its largest magnitude (the backward's own
order of operations), two runs bit for bit.
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


def _expand_both_entries(vals, starts, out_len):
    """Both entries, int32 and float32 rows: bit-equal to the plain
    version, each counted once a call."""
    for entry, kw in ((rc.expand_segments, {"resident_max": 1 << 30}),
                      (rc.expand_segments_stream, {})):
        for v in (vals, vals.float() * 1e-3):
            before = rc.LAUNCHES[entry.__name__]
            k = entry(v, starts, out_len, out_dtype=v.dtype, **kw)
            assert rc.LAUNCHES[entry.__name__] == before + 1
            p = rc.expand_segments_plain(v, starts, out_len, out_dtype=v.dtype)
            assert k.shape == p.shape == (vals.shape[0], out_len)
            assert torch.equal(k.view(torch.int32), p.view(torch.int32))


# Segment lengths and output length of each edge case, as (lengths, first
# start, out_len - starts[N]). The kernel covers 2,048 positions a CTA.
_EXPAND_CASES = {
    # the ragged end: out_len % 4 != 0 (rows start unaligned)
    "out_len_not_multiple_of_4": (np.full(3001, 3), 0, 6),
    "first_start_above_0": (np.full(2000, 2), 5000, 11),
    # overflow: the positions past the capacity are absent
    "out_len_below_starts_n": (np.full(4000, 5), 7, -9001),
    "one_segment_many_chunks": (np.array([3, 50_000, 2, 0, 7]), 1, 100),
    # 100,000 empty segments between two chunks' worth of short ones: a
    # window too wide to mark, searched instead
    "empty_stretch": (np.concatenate([np.full(700, 3), np.zeros(100_000, int),
                                      np.full(700, 2)]), 0, 64),
    # runs of empty segments sharing starts[0] and starts[N]: outside the
    # window
    "leading_and_trailing_empties": (np.concatenate([
        np.zeros(5000, int), np.full(1000, 3), np.zeros(300_000, int)]), 100,
        50),
    # the search path with positions before starts[0] and past starts[N]
    "empty_stretch_after_first": (np.concatenate([
        np.zeros(10, int), np.full(100, 2), np.zeros(50_000, int),
        np.full(100, 2)]), 1000, 33),
    # every segment edge on a chunk edge
    "chunk_edges": (np.array([2048, 2048, 4096, 1024, 1024, 0, 2048]), 0,
                    2048),
    "all_before_start": (np.array([4, 4]), 9000, -5008),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_EXPAND_CASES))
@pytest.mark.parametrize("rows", [1, 4, 5, 10, 11])
def test_expand_segments_kernel_edges(dev, case, rows):
    """The chunked kernel's edges, bit-equal through both entries."""
    lens, first, extra = _EXPAND_CASES[case]
    starts_np = np.concatenate([[first], first + np.cumsum(lens)])
    starts = torch.as_tensor(starts_np.astype(np.int32), device=dev)
    out_len = int(starts_np[-1]) + extra
    assert out_len > 0
    rng = np.random.default_rng(rows)
    vals = torch.as_tensor(
        rng.integers(-2**31, 2**31 - 1, (rows, len(lens))).astype(np.int32),
        device=dev)
    _expand_both_entries(vals, starts, out_len)


@pytest.mark.cuda
def test_expand_segments_kernel_odd_shapes(dev):
    """out_len of 1, 3 and one past a chunk; a single segment; an empty
    value table; a row count that leaves only some rows aligned."""
    rng = np.random.default_rng(5)
    for n, out_len in ((1, 1), (1, 3), (7, 2049), (0, 10), (40, 4098)):
        lens = rng.integers(0, 120, n)
        starts = torch.as_tensor(
            np.concatenate([[1], 1 + np.cumsum(lens)]).astype(np.int32),
            device=dev)
        vals = torch.as_tensor(
            rng.integers(-2**31, 2**31 - 1, (3, n)).astype(np.int32),
            device=dev)
        _expand_both_entries(vals, starts, out_len)


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


def _bykey_case(rng, keys, ru, dev, pad, integer=False):
    """A key-sorted slab for `keys`: ru rows of random bf16 pairs (normal,
    or small integers, whose sums are exact in any order), the key row
    last, the row stride padded to a multiple of 4 words or not."""
    length = len(keys)
    stride = -(-length // 4) * 4 if pad else length
    buf = torch.zeros((ru + 1, stride), dtype=torch.int32, device=dev)
    slab = buf[:, :length]
    if integer:
        v = torch.as_tensor(rng.integers(-8, 9, (2 * ru, length)).astype(
            np.float32), device=dev)
        slab[:ru] = torch.stack([rc.pack_bf16_2(v[2 * i], v[2 * i + 1])
                                 for i in range(ru)])
    else:
        slab[:ru] = _random_packed(rng, ru, length, dev)
    slab[ru] = torch.as_tensor(np.asarray(keys, dtype=np.int32), device=dev)
    return slab


def _check_bykey(slab, ru, n):
    """compare_reduce against the plain version, two runs bit-equal, exact
    zeros for every id without lanes."""
    before = rc.LAUNCHES["reduce_segments_bykey"]
    got = rc.reduce_segments_bykey(slab, ru, n)
    assert rc.LAUNCHES["reduce_segments_bykey"] == before + 1
    assert got.shape == (2 * ru + 2, n)
    assert torch.equal(got, rc.reduce_segments_bykey(slab, ru, n))
    want = rc.reduce_segments_bykey_plain(slab, ru, n)
    chip_smoke.compare_reduce(got, want)
    keys = slab[ru].long()
    has = torch.zeros(n, dtype=torch.bool, device=slab.device)
    has[keys[(keys >= 0) & (keys < n)]] = True
    assert not bool(got[:, ~has].ne(0).any())
    return got, want


def _bykey_keys(case, rng):
    """(keys, n) of each edge case. The kernel owns 256 ids a CTA and walks
    their lanes 512 at a time."""
    if case == "long_run":  # one id over 150,000 lanes, many tiles
        return np.sort(np.concatenate([rng.integers(0, 900, 3000),
                                       np.full(150_000, 300)])), 900
    if case == "run_offsets":  # runs of 513 lanes start at every offset mod 512
        return np.repeat(np.arange(600), 513), 600
    if case == "missing_both_ends":  # keys from 1,000 up, the last 1,000 ids empty
        return np.sort(rng.integers(1000, 9000, 20_001)), 10_000
    if case == "all_sentinel":
        return np.full(4099, 5000), 5000
    if case == "sentinel_tail":  # compact_frac >= 1: a tail as long as n
        return np.concatenate([np.sort(rng.integers(0, 3000, 7001)),
                               np.full(3000, 3000)]), 3000
    if case == "negative_keys":  # padding below 0 is never summed
        return np.concatenate([np.full(37, -1), np.sort(
            rng.integers(0, 500, 2000)), np.full(9, 500)]), 500
    if case == "sparse":  # most ids without lanes, gaps across CTAs
        return np.sort(rng.choice(200_000, 1501, replace=False)), 200_000
    raise KeyError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["long_run", "run_offsets",
                                  "missing_both_ends", "all_sentinel",
                                  "sentinel_tail", "negative_keys", "sparse"])
@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("ids", [256, 512])
def test_reduce_segments_bykey_kernel_edges(dev, case, pad, ids,
                                            monkeypatch):
    """The id-block kernel's edges at ru = 7 (the main path's), with the row
    stride padded (16-byte loads) and not, in blocks of 256 and of 512 ids.
    The fields are small integers, so every sum is exact in any order:
    compare_reduce's tolerance, and bit-equal to the plain version as
    well."""
    monkeypatch.setattr(rc, "bykey_ids_per_cta", lambda n, slots: ids)
    rng = np.random.default_rng(len(case))
    keys, n = _bykey_keys(case, rng)
    got, want = _check_bykey(
        _bykey_case(rng, keys, 7, dev, pad, integer=True), 7, n)
    assert torch.equal(got, want)
    if case == "all_sentinel":
        assert not bool(got.ne(0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("ru", [1, 2, 3, 4, 5, 6, 7])
def test_reduce_segments_bykey_kernel_every_ru(dev, ru):
    """Every row count, on a length that is not a multiple of 4, runs of 1
    to 40 lanes, gaps, and the sentinel tail."""
    rng = np.random.default_rng(ru)
    n = 7000
    ids = np.sort(rng.choice(n, 2500, replace=False))
    keys = np.repeat(ids, rng.integers(1, 40, ids.size))
    tail = 1234 + (1 if (len(keys) + 1234) % 4 == 0 else 0)
    keys = np.concatenate([keys, np.full(tail, n)])
    assert len(keys) % 4 != 0
    for pad in (True, False):
        _check_bykey(_bykey_case(rng, keys, ru, dev, pad), ru, n)
    # 7,000 ids make one partial wave: the wrapper takes 256; 512 too
    assert rc.bykey_ids_per_cta(n, rc._bykey_slots(dev, ru)) == 256
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rc, "bykey_ids_per_cta", lambda n, slots: 512)
        _check_bykey(_bykey_case(rng, keys, ru, dev, True), ru, n)


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


def _check_cumsum(x):
    """Bit-equal to the plain version, two runs bit-equal, one launch a
    call."""
    before = rc.LAUNCHES["cumsum_lanes_i32"]
    got = rc.cumsum_lanes_i32(x)
    assert rc.LAUNCHES["cumsum_lanes_i32"] == before + 1
    assert torch.equal(got, rc.cumsum_lanes_i32_plain(x))
    assert torch.equal(got, rc.cumsum_lanes_i32(x))
    assert rc.LAUNCHES["cumsum_lanes_i32"] == before + 2
    return got


T = rc.CUMSUM_TILE


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4, 5])
@pytest.mark.parametrize("lanes", [
    1, 2, 3, 1000, 2048,  # inside one tile; C % 4 in {1, 2, 3}: rows misaligned
    T - 1, T, T + 1, T + 2, 2 * T + 1,  # around the tile's edges
    1_000_003,
    1000 * T + 7,  # over 1,000 tiles a row: the look-back reaches far
])
def test_cumsum_lanes_i32_kernel_bit_equal(dev, rows, lanes):
    """Integer adds: bit-equal to torch.cumsum at any magnitude, the int32
    wrap included (values over the whole int32 range), a row of zeros, rows
    that start off a 16-byte boundary (C % 4 != 0: the kernel's scalar
    heads and tails), small values too; two runs bit-equal."""
    rng = np.random.default_rng(rows * lanes)
    big = rng.integers(-2**31, 2**31, (rows, lanes), dtype=np.int64)
    x = torch.as_tensor(big.astype(np.int32), device=dev)
    if rows > 1:
        x[rows // 2] = 0
    got = _check_cumsum(x)
    if rows > 1:
        assert not bool(got[rows // 2].ne(0).any())
    _check_cumsum(torch.as_tensor(
        rng.integers(-50, 60, (rows, lanes)).astype(np.int32), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [4 * T, 3 * T + 2])
def test_cumsum_lanes_i32_kernel_unaligned_table(dev, lanes):
    """A contiguous table that starts 4 bytes past a 16-byte boundary (a
    view into a larger buffer): its 16-byte words do not line up with the
    output's, so the kernel takes every word singly; still bit-equal. The
    wrapper refuses what the kernel does not take."""
    rng = np.random.default_rng(lanes)
    buf = torch.as_tensor(rng.integers(-2**31, 2**31, 3 * lanes + 1,
                                       dtype=np.int64).astype(np.int32),
                          device=dev)
    x = buf[1:].view(3, lanes)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    _check_cumsum(x)
    with pytest.raises(ValueError, match="contiguous"):
        rc.cumsum_lanes_i32(x.t())
    with pytest.raises(ValueError, match="contiguous"):
        rc.cumsum_lanes_i32(x.float())
    with pytest.raises(ValueError, match="65535"):
        rc.cumsum_lanes_i32(torch.zeros((65536, 1), dtype=torch.int32,
                                        device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("gw", [16, 15, 3])
def test_reduce_segments_kernel_matches_plain(dev, gw):
    """rtol 1e-5 / atol 1e-5 of the row's scale (the kernel adds a range by
    a segmented scan in a fixed tree order, index_add_ in any order), exact
    zeros for empty ranges, two runs bit-equal; lanes past starts[N] hold
    1e9 and are never read."""
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
    with pytest.raises(ValueError, match="grads"):
        rc.reduce_segments(torch.zeros((17, 8), device=dev), starts, n)


def _segment_lens(case, rng):
    """(lengths of the N ranges, first boundary) of each edge case. The
    kernel owns 128 ids a CTA and walks their lanes 512 at a time."""
    if case == "long_ranges":  # 2,304 and 100,000 lanes, many tiles each
        lens = rng.integers(0, 40, 1500)
        lens[100], lens[700] = 2304, 100_000
        return lens, 3
    if case == "run_offsets":  # 513 lanes: runs start at every offset mod 512
        return np.full(600, 513), 5
    if case == "empty_ends_and_block":
        # empty ids at both ends, and ids 2,000-2,999 empty: whole CTAs
        # without lanes; n not a multiple of 128
        lens = rng.integers(0, 13, 5001)
        lens[:300] = lens[-300:] = lens[2000:3000] = 0
        return lens, 37
    if case == "all_empty":
        return np.zeros(777, np.int64), 6
    if case == "one_id":
        return np.array([5000]), 1
    raise KeyError(case)


def _segments_case(rng, lens, first, gw, dev, pad, integer=True):
    """grads (gw, C) over ranges of `lens` from lane `first`: small integers
    (every sum exact in any order) or normal values; the lanes before
    starts[0] and from starts[N] on hold 1e9 and NaN; the row stride
    padded to a multiple of 4 words or left odd."""
    starts = np.concatenate([[first], first + np.cumsum(lens)])
    length = int(starts[-1]) + 11
    stride = -(-length // 4) * 4 if pad else length | 1
    buf = torch.zeros((gw, stride), device=dev)
    grads = buf[:, :length]
    vals = (rng.integers(-8, 9, (gw, length)) if integer
            else rng.normal(size=(gw, length)))
    grads.copy_(torch.as_tensor(vals.astype(np.float32), device=dev))
    grads[:, :first] = float("nan")
    grads[:, int(starts[-1])::2] = 1e9
    grads[:, int(starts[-1]) + 1::2] = float("nan")
    return grads, torch.as_tensor(starts.astype(np.int32), device=dev)


def _check_segments(grads, starts, n):
    """compare_reduce against the plain version, two runs bit-equal, exact
    zeros for every empty range, one launch a call."""
    before = rc.LAUNCHES["reduce_segments"]
    got = rc.reduce_segments(grads, starts, n)
    assert rc.LAUNCHES["reduce_segments"] == before + 1
    assert got.shape == (grads.shape[0], n)
    assert torch.equal(got, rc.reduce_segments(grads, starts, n))
    want = rc.reduce_segments_plain(grads, starts, n)
    chip_smoke.compare_reduce(got, want, "reduce_segments")
    empty = starts[1:] == starts[:-1]
    assert not bool(got[:, empty].ne(0).any())
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["long_ranges", "run_offsets",
                                  "empty_ends_and_block", "all_empty",
                                  "one_id"])
@pytest.mark.parametrize("pad", [True, False])
def test_reduce_segments_kernel_edges(dev, case, pad):
    """The id-block kernel's edges at GW = 15 (the main path's), with the
    row stride padded (16-byte loads) and not, starts[0] > 0. The fields are small integers, so every sum is
    exact in any order: compare_reduce's tolerance, and bit-equal to the
    plain version as well. NaN and 1e9 outside [starts[0], starts[N])
    never reach a sum."""
    rng = np.random.default_rng(len(case))
    lens, first = _segment_lens(case, rng)
    grads, starts = _segments_case(rng, lens, first, 15, dev, pad)
    got, want = _check_segments(grads, starts, len(lens))
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).all())
    if case == "all_empty":
        assert not bool(got.ne(0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("gw", list(range(1, 17)))
def test_reduce_segments_kernel_every_gw(dev, gw):
    """Every row count, on ranges of 0 to 40 lanes with a 2,304-lane one,
    n not a multiple of the block: integer fields bit-equal to the plain
    version, normal ones within compare_reduce, with the stride padded and
    not."""
    rng = np.random.default_rng(gw)
    lens = rng.integers(0, 41, 7001)
    lens[rng.uniform(size=lens.size) < 0.3] = 0
    lens[4321] = 2304
    n = lens.size
    for pad in (True, False):
        got, want = _check_segments(
            *_segments_case(rng, lens, 9, gw, dev, pad), n)
        assert torch.equal(got, want)
        _check_segments(*_segments_case(rng, lens, 2, gw, dev, pad,
                                        integer=False), n)


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


def _tile_case(dev, tile, n_feats, counts, seed, offset=3):
    """Synthetic tile kernel inputs: tiles_x = 4, tile t holds counts[t]
    pairs around it (a count of -N: N opaque, wide splats that end every
    pixel of the tile within a few pairs). The first tile starts `offset`
    columns into the payload and the row stride is odd, so neither the
    starts nor the rows are 16-byte aligned."""
    rng = np.random.default_rng(seed)
    tiles_x = 4
    n_tiles = len(counts)
    pw = 6 + n_feats
    cols = []
    for t, c in enumerate(counts):
        n = abs(c)
        x0, y0 = (t % tiles_x) * tile, (t // tiles_x) * tile
        a = rng.uniform(0.02, 0.3, n)
        cc = rng.uniform(0.02, 0.3, n)
        b = rng.uniform(-0.5, 0.5, n) * np.sqrt(a * cc)
        op = rng.uniform(0.01, 0.12, n)
        if c < 0:
            a, cc, b, op = a * 1e-3, cc * 1e-3, b * 1e-3, np.full(n, 0.99)
        cols.append(np.stack([
            x0 + rng.uniform(-2, tile + 2, n), y0 + rng.uniform(-2, tile + 2, n),
            a, b, cc, op, *rng.uniform(0.0, 1.0, (n_feats, n))]))
    body = np.concatenate(cols, axis=1)
    lens = np.array([abs(c) for c in counts])
    width = offset + body.shape[1] + 5
    width += 1 - width % 2  # odd
    payload = np.zeros((-(-pw // 8) * 8, width), np.float32)
    payload[:pw, offset:offset + body.shape[1]] = body
    starts = np.concatenate([[0], np.cumsum(lens)]) + offset
    as_t = lambda x, dt: torch.as_tensor(np.asarray(x, dt), device=dev)
    return (as_t(payload, np.float32), as_t(starts, np.int32),
            as_t(lens, np.int32), n_tiles, n_feats, tile, tiles_x, 128)


# pair counts per tile around the kernels' batches (forward 256 pairs,
# backward 32), and a tile that ends every pixel in its first batch
EDGE_COUNTS = [0, 1, 31, 32, 33, 255, 256, 257, 700, -600, 2, 95]


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("n_feats", [1, 2, 7, 8])
def test_forward_tiles_kernel_edges(dev, tile, n_feats):
    """chip_smoke.py's forward check at the batch edges, tiles 8 and 16,
    odd and even channel counts, unaligned starts; a NaN conic is skipped
    like a miss, and a tile whose pixels all end early stops."""
    args = _tile_case(dev, tile, n_feats, EDGE_COUNTS, seed=tile + n_feats)
    payload, starts = args[0], args[1]
    payload[2, int(starts[4]) + 5] = float("nan")
    before = rc.LAUNCHES["forward_tiles"]
    got = rc.forward_tiles(*args)
    assert rc.LAUNCHES["forward_tiles"] == before + 1
    want = rc.forward_tiles_plain(*args)
    chip_smoke.compare_forward(got, want, payload, n_feats)
    again = rc.forward_tiles(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    # the preconditions the case is built for
    last = want[2][:, 0]
    assert int(last[0].max()) == -1 and int(last[1].max()) == 0
    assert bool((last[9] < 8).all())  # 600 opaque splats: all ended
    assert int(last[8].max()) >= 256  # a pixel composited past one batch


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("n_feats", [1, 2, 7, 8])
@pytest.mark.parametrize("pack", [True, False])
def test_backward_tiles_kernel_edges(dev, tile, n_feats, pack):
    """chip_smoke.py's backward check at the batch edges (packed: decoded
    within rel 2^-7 + 1e-4 of the row's largest value, <= 0.1% beyond one
    bf16 ulp, integer zeros kept; float32 rows: the same element bound),
    two runs bit-equal, no word written past a tile's deepest
    contributor."""
    fargs = _tile_case(dev, tile, n_feats, EDGE_COUNTS, seed=tile * n_feats)
    payload, starts, counts, n_tiles = fargs[:4]
    _, t_final, last = rc.forward_tiles_plain(*fargs)
    p = tile * tile
    gen = torch.Generator(dev).manual_seed(n_feats)
    g_out = torch.randn((n_tiles, n_feats, p), device=dev, generator=gen)
    g_alpha = torch.randn((n_tiles, 1, p), device=dev, generator=gen)
    args = (payload, starts, counts, g_out, g_alpha, t_final, last,
            *fargs[3:])
    before = rc.LAUNCHES["backward_tiles"]
    got = rc.backward_tiles(*args, pack_grads=pack)
    assert rc.LAUNCHES["backward_tiles"] == before + 1
    assert torch.equal(got, rc.backward_tiles(*args, pack_grads=pack))
    want = rc.backward_tiles_plain(*args, pack_grads=pack)
    if pack:
        rep = chip_smoke.compare_backward(got, want, n_feats)
        assert rep["elements"] > 1000
    else:
        # compare_backward's element bound, on float32 rows
        row_max = want.abs().amax(dim=1, keepdim=True)
        mag = torch.maximum(got.abs(), want.abs())
        bound = chip_smoke.BWD_REL * mag + chip_smoke.BWD_ATOL * row_max
        assert not bool(((got - want).abs() > bound).any())
    # nothing past a tile's deepest contributor, nor outside the tiles
    ml = last.reshape(n_tiles, p).amax(dim=1)
    assert int(ml[9]) < 8 and int(ml[8]) >= 256
    written = (got.view(torch.int32) != 0).any(dim=0)
    col = torch.arange(payload.shape[1], device=dev)
    tile_of = torch.searchsorted(starts.long(), col, right=True) - 1
    inside = (tile_of >= 0) & (tile_of < n_tiles)
    t_c = tile_of.clamp(0, n_tiles - 1)
    live = inside & (col - starts.long()[t_c] <= ml[t_c])
    assert not bool((written & ~live).any())


@pytest.mark.cuda
def test_tile_kernels_refuse_misaligned_inputs(dev):
    """backward_tiles reads four pixels as one 16-byte word: a 4-byte
    offset view is refused, not misread."""
    fargs = _tile_case(dev, 16, 7, [40, 3], seed=0)
    _, t_final, last = rc.forward_tiles_plain(*fargs)
    g = torch.zeros(2 * 7 * 256 + 1, device=dev)[1:].view(2, 7, 256)
    g_alpha = torch.zeros_like(t_final)
    with pytest.raises(ValueError, match="g_out"):
        rc.backward_tiles(*fargs[:3], g, g_alpha, t_final, last,
                          *fargs[3:])


# -- meshing and mesh evaluation on the card, against the port's CPU run ------
#
# Tolerances: the sparse TSDF's weights and tsdf within 1e-5 on all but 0.5%
# of the observed voxels (the card may contract a voxel centre's multiply-add
# into one rounding, so a voxel a hair from a pixel boundary or the band's
# edge can land on the other side, within one pixel's depth step over the
# truncation); the Poisson indicator rel 1e-4 of its largest magnitude (FFT
# and CG); densities rel 1e-5; mesh depth rel 1e-5 where both hit, with hit
# masks apart on at most 0.1% of the pixels; native marching the numpy path's
# surface (equal counts, sorted vertex radii within 1e-4; its own order).


def _sphere_frames(n=4, h=64, w=64, f=58.0, radius=2.0):
    from dnsplatter_torch.ops.camera import look_at

    out = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        eye = (0.3 * np.cos(ang), 0.1, 0.3 * np.sin(ang))
        tgt = (2.5 * np.cos(ang), 0.0, 2.5 * np.sin(ang))
        c2w = look_at(eye, tgt, device="cpu").numpy().astype(np.float64)
        c2w_cv = c2w @ np.diag([1.0, -1.0, -1.0, 1.0])
        vv, uu = np.mgrid[0:h, 0:w]
        dirs = np.stack([(uu + 0.5 - w / 2) / f, (vv + 0.5 - h / 2) / f,
                         np.ones_like(uu, np.float64)], -1) @ c2w_cv[:3, :3].T
        o = c2w_cv[:3, 3]
        a = (dirs * dirs).sum(-1)
        b = 2 * (o * dirs).sum(-1)
        c = (o * o).sum() - radius ** 2
        t = (-b + np.sqrt(np.maximum(b * b - 4 * a * c, 0))) / (2 * a)
        rgb = np.random.default_rng(i).random((h, w, 3)).astype(np.float32)
        out.append((c2w.astype(np.float32), t[..., None].astype(np.float32),
                    rgb, f, w / 2, h / 2))
    return out


@pytest.mark.cuda
def test_sparse_tsdf_card_matches_cpu(dev):
    from dnsplatter_torch.mesh.tsdf_sparse import SparseTSDF, SparseTSDFConfig

    cfg = SparseTSDFConfig(voxel_size=0.05, sdf_trunc=0.15)
    vols = {d: SparseTSDF(np.full(3, -2.4, np.float32), cfg, device=d)
            for d in ("cpu", dev)}
    for c2w, depth, rgb, f, cx, cy in _sphere_frames():
        for d, vol in vols.items():
            vol.integrate(torch.as_tensor(depth, device=d), rgb, c2w, f, f,
                          cx, cy)
    cpu, card = vols["cpu"], vols[dev]
    n = cpu.n_slots
    assert card.n_slots == n > 50
    w0, w1 = cpu.weight[:n], card.weight[:n].cpu()
    seen = (w0 > 0) | (w1 > 0)
    wdiff = (w0 - w1).abs()[seen]
    tdiff = (cpu.tsdf[:n] - card.tsdf[:n].cpu()).abs()[seen]
    assert float((wdiff > 1e-5).float().mean()) <= 5e-3
    assert float((tdiff > 1e-5).float().mean()) <= 5e-3
    assert float(tdiff[wdiff == 0].max()) <= 0.25
    v0, f0, _ = cpu.extract_mesh()
    v1, f1, _ = card.extract_mesh()
    assert abs(len(v1) - len(v0)) <= 0.01 * len(v0)


@pytest.mark.cuda
@pytest.mark.parametrize("solver,res", [("fft", 48), ("cg", 64)])
def test_poisson_card_matches_cpu(dev, solver, res):
    from dnsplatter_torch.mesh.poisson import PoissonConfig, poisson_field

    rng = np.random.default_rng(0)
    d = rng.normal(size=(5000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (0.8 * d + 0.01 * rng.normal(size=d.shape)).astype(np.float32)
    cfg = PoissonConfig(resolution=res, solver=solver)
    cpu = poisson_field(pts, d, cfg, device="cpu")[0]
    card = poisson_field(pts, d, cfg, device=dev)[0].cpu()
    scale = float(cpu.abs().max())
    assert float((card - cpu).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_density_and_mesh_depth_card_match_cpu(dev):
    from dnsplatter_torch.eval.mesh_render import render_mesh_depth
    from dnsplatter_torch.mesh.marching import marching_tetrahedra
    from dnsplatter_torch.models.gaussians import params_to_numpy, \
        params_from_numpy
    from dnsplatter_torch.models.sugar import get_closest_gaussians, \
        get_density

    gt, alive = make_gt_gaussians(np.random.default_rng(1), 2000,
                                  device="cpu")
    card = params_from_numpy(params_to_numpy(gt), device=dev)
    q = np.random.default_rng(2).uniform(-1, 1, (20000, 3)).astype(
        np.float32)
    closest = get_closest_gaussians(q, gt, alive)
    want = get_density(q, gt, alive, closest, clamp=False)
    got = get_density(q, card, alive.to(dev), closest, clamp=False).cpu()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())

    g = np.linspace(-1, 1, 40)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    v, f = marching_tetrahedra(np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.7,
                               backend="numpy")
    v = (v / 39 * 2 - 1).astype(np.float32)
    for cam in ring_cameras(3, radius=2.5, width=160, img_height=120,
                            focal=120.0, device="cpu"):
        z0 = render_mesh_depth(v, f, cam, device="cpu")
        z1 = render_mesh_depth(v, f, cam, device=dev)
        h0, h1 = np.isfinite(z0), np.isfinite(z1)
        assert h0.mean() > 0.1 and (h0 != h1).mean() <= 1e-3
        both = h0 & h1
        assert np.abs(z1[both] - z0[both]).max() <= 1e-5 * z0[both].max()


@pytest.mark.cuda
def test_native_marching_built_into_the_port(dev):
    from dnsplatter_torch import native
    from dnsplatter_torch.mesh.marching import marching_tetrahedra

    g = np.linspace(-1, 1, 30)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    field = (np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.6).astype(np.float32)
    got = marching_tetrahedra(field, backend="native")
    assert native.available(), native.build_error()
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "dnsplatter_torch"
    # the same surface as the numpy path, in its own vertex order
    want = marching_tetrahedra(field, backend="numpy")
    assert len(got[0]) == len(want[0]) and len(got[1]) == len(want[1])
    c = np.array([14.5, 14.5, 14.5])
    np.testing.assert_allclose(np.sort(np.linalg.norm(got[0] - c, axis=1)),
                               np.sort(np.linalg.norm(want[0] - c, axis=1)),
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dpt_hybrid_omnidata", "dsine_b5",
                                  "zoedepth_nyu"])
def test_prior_network_card_matches_cpu(dev, name):
    """Each prior network at its narrow test width, the same weights on the
    card and on the CPU: within chip_smoke.PRIOR_CARD_TOL (1e-4) of the
    output's largest magnitude, float32 with TF32 off on both."""
    rep = chip_smoke.card_vs_cpu(dev, (name,))[name]
    assert rep["card_vs_cpu_rel"] <= chip_smoke.PRIOR_CARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["gnerfacto", "gdepthfacto", "gneusfacto"])
def test_baseline_step_card_matches_cpu(dev, method):
    """One step of each baseline at its own widths, card against CPU, from
    the same weights, pixel draws and sample distances (chip_smoke.py's
    check and tolerances: each device's sample distances within 1e-2 of a
    coarse bin of the other's, loss within 1e-5 relative, each gradient
    within 1e-3 in relative L2)."""
    from dnsplatter_torch.ops.camera import Camera, look_at

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    w, h = 160, 120
    cam = Camera.create(140.0, 140.0, w / 2, h / 2,
                        look_at((0.4, 0.3, 2.5), (0.0, 0.0, 0.0),
                                device="cpu"), w, h, device="cpu")
    frame = (cam, torch.as_tensor(rng.uniform(size=(h, w, 3)),
                                  dtype=torch.float32),
             torch.as_tensor(rng.uniform(0.5, 4.0, (h, w, 1)),
                             dtype=torch.float32),
             torch.as_tensor(rng.uniform(size=(h, w, 3)),
                             dtype=torch.float32))
    cmp = chip_smoke.baseline_card_vs_cpu(method, dev, frame)
    assert cmp["loss_rel_err"] <= chip_smoke.BASELINE_LOSS_RTOL, cmp
    assert cmp["grad_rel_l2"] <= chip_smoke.BASELINE_GRAD_L2, cmp
    assert cmp["ts_max_err_bins"] <= chip_smoke.BASELINE_TS_BINS, cmp


@pytest.mark.cuda
def test_nccl_world_one_dp_step_matches_train_step(dev):
    """`make_dp_train_step` at dp 1 under NCCL (a process group of one, its
    collectives real NCCL calls) against the single-device `train_step` on
    the same state and frame: the four step kernels launched alike; loss,
    parameters and statistics within rtol 1e-5 / atol 1e-6 (expected
    bit-equal: the mean over one rank is exact and the render the same)."""
    import socket

    from dnsplatter_torch.data.synthetic import make_synthetic_scene
    from dnsplatter_torch.models.dn_model import ModelConfig
    from dnsplatter_torch.models.gaussians import FIELDS, init_from_points
    from dnsplatter_torch.parallel import collectives as C
    from dnsplatter_torch.parallel import distributed as D
    from dnsplatter_torch.train.optim import OptimConfig, init_adam
    from dnsplatter_torch.train.strategy import init_stats
    from dnsplatter_torch.train.trainer import train_step

    scene = make_synthetic_scene(seed=0, n_gaussians=300, n_cameras=2,
                                 width=96, height=64, device=dev)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    params, alive, _ = init_from_points(rng, pts, sh_degree=1, capacity=512,
                                        device=dev)
    mc = ModelConfig(use_depth_loss=True, depth_lambda=0.2, sh_degree=1,
                     background_color="black")
    rcfg = RasterizeConfig(width=96, height=64, chunk=32, tile_block=4,
                           pair_capacity=1 << 14, backend="cuda",
                           sort_scheme="depthq")
    cam, batch = scene.get(1)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def fresh():
        p = type(params)(**{f: getattr(params, f).clone() for f in FIELDS})
        return p, alive.clone(), init_adam(p), init_stats(512, dev)

    rc.LAUNCHES.clear()
    want = train_step(mc, OptimConfig(), rcfg, 1, *fresh(), cam, batch, 0)
    torch.cuda.synchronize()
    single = dict(rc.LAUNCHES)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    D.shutdown_distributed()
    try:
        ctx = D.init_distributed(f"127.0.0.1:{port}", 1, 0)
        assert ctx.backend == "nccl" and ctx.initialized
        mesh = D.make_hybrid_mesh(dp=1)
        fn = D.make_dp_train_step(mc, OptimConfig(), rcfg, 1, mesh)
        C.LOG.clear()
        rc.LAUNCHES.clear()
        got = fn(*D.shard_state_hybrid(mesh, *fresh()), cam, batch, 0,
                 frame_idx=[1])
        torch.cuda.synchronize()
        assert dict(rc.LAUNCHES) == single
        assert C.LOG and {r["backend"] for r in C.LOG} == {"nccl"}
    finally:
        D.shutdown_distributed()
    tol = dict(rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[3], want[3], **tol)
    for f in FIELDS:
        torch.testing.assert_close(getattr(got[0], f), getattr(want[0], f),
                                   msg=f, **tol)
    for k in ("grad_sum", "vis_count", "max_2d"):
        torch.testing.assert_close(getattr(got[2], k), getattr(want[2], k),
                                   msg=k, **tol)


# ---------------------------------------------------------------------------
# sh_colors
# ---------------------------------------------------------------------------


def _sh_tie_dc() -> float:
    """A float32 value v with float32(C0) * v == -0.5 exactly, so that a row
    with features_dc v and no rest coefficients sums to 0 at the clamp."""
    from dnsplatter_torch.ops.sh import C0

    c0 = np.float32(C0)
    v = np.float32(-0.5 / C0)
    for _ in range(64):
        if c0 * v == np.float32(-0.5):
            return float(v)
        v = np.nextafter(v, np.float32(0.0), dtype=np.float32)
    raise AssertionError("no float32 tie value found")


def _sh_inputs(n, degree, k, seed):
    """features_dc, features_rest, dirs as float32 numpy arrays, and the
    rows given a special role (empty where n < 31): a zero direction, one
    under 1e-12, one of 1e-8, a colour far below the clamp, a colour exactly
    on it. Every other colour lies 1e-3 or more from the clamp."""
    from dnsplatter_torch.ops.sh import C0, sh_basis

    rng = np.random.default_rng(seed)
    dc = rng.normal(size=(n, 3)).astype(np.float32)
    rest = (0.5 * rng.normal(size=(n, k - 1, 3))).astype(np.float32)
    dirs = (3.0 * rng.normal(size=(n, 3))).astype(np.float32)
    special = []
    if n >= 31:
        special = [0, n // 3, n // 2, 2 * n // 3, n - 1]
        zero, tiny, small, below, tie = special
        dirs[zero] = 0.0
        dirs[tiny] = [1e-13, -2e-13, 3e-14]
        dirs[small] = [1e-8, 2e-8, -1e-8]
        dc[below] = -50.0
        dc[tie] = _sh_tie_dc()
        rest[tie] = 0.0
    d64 = torch.as_tensor(dirs, dtype=torch.float64)
    u = d64 / d64.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    nb = (degree + 1) ** 2
    coeffs = torch.as_tensor(np.concatenate([dc[:, None], rest], 1),
                             dtype=torch.float64)[:, :nb]
    raw = (sh_basis(degree, u)[..., None] * coeffs).sum(1).numpy() + 0.5
    near = np.abs(raw) < 1e-3
    if special:
        near[special[-1]] = False
    dc += np.where(near, np.float32(0.01 / C0), np.float32(0.0))
    return dc, rest, dirs, special


def _sh_leaves(arrays, dev, strided):
    """Leaf tensors on `dev` and the views of them the entry is given: the
    leaves themselves, or non-contiguous views of larger leaves."""
    dc, rest, dirs = (torch.as_tensor(a, device=dev) for a in arrays)
    if not strided:
        leaves = [t.clone().requires_grad_(True) for t in (dc, rest, dirs)]
        return leaves, leaves
    leaves = [torch.stack([dc, -dc], 1).requires_grad_(True),
              rest.transpose(0, 1).contiguous().requires_grad_(True),
              dirs.t().contiguous().requires_grad_(True)]
    views = [leaves[0][:, 0], leaves[1].transpose(0, 1), leaves[2].t()]
    assert not any(v.is_contiguous() for v in views)
    return leaves, views


def _sh_check(dev, n, degree, k, seed=0, strided=False):
    arrays = _sh_inputs(n, degree, k, seed)
    special = arrays[3]
    lk, vk = _sh_leaves(arrays[:3], dev, strided)
    lp, vp = _sh_leaves(arrays[:3], dev, strided)
    w = torch.as_tensor(np.random.default_rng(seed + 1).normal(
        size=(n, 3)).astype(np.float32), device=dev)
    before = (rc.LAUNCHES["sh_colors"], rc.LAUNCHES["sh_colors_backward"])
    got = rc.sh_colors(degree, *vk)
    grads_k = torch.autograd.grad((got * w).sum(), lk)
    assert (rc.LAUNCHES["sh_colors"], rc.LAUNCHES["sh_colors_backward"]) \
        == (before[0] + 1, before[1] + 1)
    want = rc.sh_colors_plain(degree, *vp)
    grads_p = torch.autograd.grad((want * w).sum(), lp, allow_unused=True)
    # the plain path has no gradient path to dirs at degree 0
    grads_p = [torch.zeros_like(t) if g is None else g
               for g, t in zip(grads_p, lp)]
    torch.cuda.synchronize()
    if strided:  # back to (N, 3), (N, K - 1, 3), (N, 3)
        grads_k = [grads_k[0][:, 0], grads_k[1].transpose(0, 1),
                   grads_k[2].t()]
        grads_p = [grads_p[0][:, 0], grads_p[1].transpose(0, 1),
                   grads_p[2].t()]

    def near(a, b, tol, what):
        a, b = a.detach(), b.detach()
        err = float((a - b).abs().max()) if a.numel() else 0.0
        scale = float(b.abs().max()) if b.numel() else 0.0
        assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"

    near(got, want, 1e-5, "colors")
    near(grads_k[0], grads_p[0], 1e-5, "d_features_dc")
    near(grads_k[1], grads_p[1], 1e-5, "d_features_rest")
    assert torch.all(grads_k[1][:, (degree + 1) ** 2 - 1:] == 0)
    ordinary = torch.ones(n, dtype=torch.bool, device=dev)
    ordinary[special[:3]] = False
    near(grads_k[2][ordinary], grads_p[2][ordinary], 1e-4, "d_dirs")
    for row in special[:3]:
        near(grads_k[2][row], grads_p[2][row], 1e-4, f"d_dirs row {row}")
    if special:
        below, tie = special[3:]
        assert torch.all(got[below] == 0) and torch.all(grads_k[0][below] == 0)
        assert torch.all(got[tie] == 0) and torch.equal(grads_k[0][tie],
                                                        grads_p[0][tie])
        assert torch.all(grads_k[0][tie] != 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 1000, 100003])
@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_sh_colors_kernel_matches_plain(dev, degree, n):
    """K = 16 at every degree below 4 (25 at 4), so the rows past the active
    degree must get exact zeros."""
    _sh_check(dev, n, degree, max(16, (degree + 1) ** 2), seed=n + degree)


@pytest.mark.cuda
@pytest.mark.parametrize("degree,k", [(0, 16), (1, 25), (3, 16), (4, 25),
                                      (3, 21)])
def test_sh_colors_kernel_non_contiguous_inputs(dev, degree, k):
    """Views that the wrapper makes contiguous. Where K > (degree + 1)^2 the
    kernel stages the active coefficients word by word and stores zeros
    past them."""
    _sh_check(dev, 1000, degree, k, seed=k, strided=True)


@pytest.mark.cuda
def test_sh_colors_kernel_refuses_bad_inputs(dev):
    n = 64
    dc = torch.zeros(n, 3, device=dev)
    rest = torch.zeros(n, 15, 3, device=dev)
    dirs = torch.ones(n, 3, device=dev)
    bad = {
        "float64": (3, dc.double(), rest, dirs),
        "dc shape": (3, torch.zeros(n, 4, device=dev), rest, dirs),
        "rest rows": (3, dc, torch.zeros(n + 1, 15, 3, device=dev), dirs),
        "rest width": (3, dc, torch.zeros(n, 15, 4, device=dev), dirs),
        "dirs shape": (3, dc, rest, torch.ones(n, 2, device=dev)),
        "dirs on the CPU": (3, dc, rest, torch.ones(n, 3)),
        "degree 4 with K 16": (4, dc, rest, dirs),
        "degree 5": (5, dc, torch.zeros(n, 40, 3, device=dev), dirs),
        "degree -1": (-1, dc, rest, dirs),
    }
    before = dict(rc.LAUNCHES)
    for what, args in bad.items():
        with pytest.raises(ValueError, match="sh_colors"):
            rc.sh_colors(*args)
    assert dict(rc.LAUNCHES) == before


def _counted_train_step(dev):
    """One `train_step` of a small synthetic scene on the card, with
    `rc.LAUNCHES` set to 0 just before it. Returns what a frame of the
    trained state needs: (params, alive, camera, model and raster
    configurations)."""
    from dnsplatter_torch.data.synthetic import make_synthetic_scene
    from dnsplatter_torch.models.dn_model import ModelConfig
    from dnsplatter_torch.models.gaussians import init_from_points
    from dnsplatter_torch.train.optim import OptimConfig, init_adam
    from dnsplatter_torch.train.strategy import init_stats
    from dnsplatter_torch.train.trainer import train_step

    scene = make_synthetic_scene(seed=0, n_gaussians=300, n_cameras=2,
                                 width=96, height=64, device=dev)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    params, alive, _ = init_from_points(rng, pts, sh_degree=3, capacity=512,
                                        device=dev)
    mc = ModelConfig(use_depth_loss=True, depth_lambda=0.2, sh_degree=3,
                     background_color="black")
    rcfg = RasterizeConfig(width=96, height=64, chunk=32, tile_block=4,
                           pair_capacity=1 << 14, backend="cuda",
                           sort_scheme="depthq")
    cam, batch = scene.get(1)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    rc.LAUNCHES.clear()
    out = train_step(mc, OptimConfig(), rcfg, 3, params, alive,
                     init_adam(params), init_stats(512, dev), cam, batch, 0)
    torch.cuda.synchronize()
    return out[0], alive, cam, mc, rcfg


@pytest.mark.cuda
def test_sh_colors_launches_once_a_step_and_once_a_frame(dev):
    """One `train_step` launches the forward and the backward once each;
    one `get_outputs` under no_grad the forward once and the backward
    never."""
    from dnsplatter_torch.models.dn_model import get_outputs

    params, alive, cam, mc, rcfg = _counted_train_step(dev)
    names = ("sh_colors", "sh_colors_backward")
    assert [rc.LAUNCHES[k] for k in names] == [1, 1]
    rc.LAUNCHES.clear()
    with torch.no_grad():
        get_outputs(params, alive, cam, mc, rcfg, sh_degree=3,
                    training=False)
    torch.cuda.synchronize()
    assert [rc.LAUNCHES[k] for k in names] == [1, 0]


# ---------------------------------------------------------------------------
# project_screen
# ---------------------------------------------------------------------------

# room_1m's state capacity and frame
# (benchmark/configs/dnsplatter_room_1m.json)
PS_ROWS, PS_WIDTH, PS_HEIGHT, PS_FOCAL = 1_253_376, 1024, 576, 700.0
PS_TOL = 1e-6  # forward values: x the array's max
PS_GRAD_TOL = 1e-5  # the Gaussians' gradients: x the array's max
PS_CAM_TOL = 1e-4  # the camera's gradients: x the array's max


def _ps_inputs(dev, n, seed, width=PS_WIDTH, height=PS_HEIGHT,
               focal=PS_FOCAL):
    """A camera and n rows on the card: random Gaussians around the view,
    with special rows where n >= 64: log-scale ties (all three equal, and
    the lower two), zero quaternions, dead rows (alive 0), rows behind the
    camera, rows whose normal is perpendicular to the view direction, and
    rows far outside the image."""
    from dnsplatter_torch.ops.camera import Camera, look_at

    rng = np.random.default_rng(seed)
    gt, alive = make_gt_gaussians(rng, n, extent=3.0, scale_shift=-1.0,
                                  device=dev)
    eye = (0.5, 1.4, 4.5)
    c2w = look_at(eye, (0.0, 0.3, 0.0), device=dev)
    cam = Camera.create(focal, focal, width / 2, height / 2, c2w, width,
                        height, device=dev)
    means, quats = gt.means.clone(), gt.quats.clone()
    scales = gt.scales.clone()
    quats = quats * torch.as_tensor(
        rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32), device=dev)
    alive = alive.clone()
    if n >= 64:
        scales[0:8] = scales[0:8, :1]
        scales[8:16, 1] = scales[8:16, 0]
        quats[16:24] = 0.0
        alive[24:32] = 0.0
        means[32:40] = torch.as_tensor(eye, device=dev) + 2.0  # behind
        # identity quats, flattest axis z, seen along x: dots = 0
        quats[40:48] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        scales[40:48] = torch.tensor([-3.0, -3.0, -5.0], device=dev)
        means[40:48] = c2w[:3, 3] + torch.tensor([0.7, 0.0, 0.0], device=dev)
        means[48:56] = torch.tensor([40.0, 0.3, 0.0], device=dev)
    colors = torch.rand(n, 3, device=dev,
                        generator=torch.Generator(dev).manual_seed(seed))
    return cam, (means, quats, scales, gt.opacities.clone(), colors), alive


def _ps_run(entry, cam, arrays, alive, mode, camera_grad, seed,
            grads_of=("means2d", "conics", "depths", "opacities",
                      "features")):
    """The entry's outputs and the gradients of the five inputs (and of c2w
    with `camera_grad`) for random incoming gradients, those of means2d,
    conics, opacities and features as strided columns of one (N, 15) array
    like the rasterizer's backward hands them over."""
    import dataclasses

    leaves = [t.clone().requires_grad_(True) for t in arrays]
    c2w = cam.c2w.clone().requires_grad_(camera_grad)
    cam = dataclasses.replace(cam, c2w=c2w)
    outs = entry(*leaves, alive, cam.viewmat(), cam.c2w, cam.fx, cam.fy,
                 cam.cx, cam.cy, cam.width, cam.height, mode)
    n = arrays[0].shape[0]
    g = torch.Generator(arrays[0].device).manual_seed(seed)
    slab = torch.randn(n, 15, device=arrays[0].device, generator=g)
    gin = {"means2d": slab[:, 0:2], "conics": slab[:, 2:5],
           "opacities": slab[:, 5], "features": slab[:, 6:13],
           "depths": slab[:, 13]}
    named = dict(zip(("means2d", "conics", "depths", "opacities",
                      "features"), outs[:5]))
    inputs = leaves + ([c2w] if camera_grad else [])
    grads = torch.autograd.grad([named[k] for k in grads_of],
                                inputs, [gin[k] for k in grads_of],
                                allow_unused=True)
    grads = [torch.zeros_like(t) if d is None else d
             for d, t in zip(grads, inputs)]
    return [o.detach() for o in outs], grads


def _ps_near(a, b, tol, what):
    err = float((a - b).abs().max()) if a.numel() else 0.0
    scale = float(b.abs().max()) if b.numel() else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _ps_check(dev, n, mode, camera_grad=False, seed=0, **kw):
    cam, arrays, alive = _ps_inputs(dev, n, seed)
    before = (rc.LAUNCHES["project_screen"],
              rc.LAUNCHES["project_screen_backward"])
    got, gk = _ps_run(rc.project_screen, cam, arrays, alive, mode,
                      camera_grad, seed + 1, **kw)
    assert (rc.LAUNCHES["project_screen"],
            rc.LAUNCHES["project_screen_backward"]) == (before[0] + 1,
                                                        before[1] + 1)
    want, gp = _ps_run(rc.project_screen_plain, cam, arrays, alive, mode,
                       camera_grad, seed + 1, **kw)
    torch.cuda.synchronize()
    names = ("means2d", "conics", "depths", "opacities", "features", "valid",
             "radii_xy", "radii")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name in ("valid", "radii_xy", "radii"):
            assert torch.equal(a, b), f"{name}: {int((a != b).sum())} differ"
        else:
            _ps_near(a, b, PS_TOL, name)
    if n >= 1000:
        assert int(got[5].sum()) > 0  # some rows are visible
    for name, a, b in zip(("d_means", "d_quats", "d_scales", "d_opacities",
                           "d_colors", "d_c2w"), gk, gp):
        _ps_near(a, b, PS_CAM_TOL if name == "d_c2w" else PS_GRAD_TOL, name)
    return got, gk


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["classic", "antialiased"])
def test_project_screen_kernel_matches_plain(dev, mode):
    """At room_1m's capacity and frame."""
    _ps_check(dev, PS_ROWS, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["classic", "antialiased"])
def test_project_screen_kernel_camera_gradients(dev, mode):
    """camera_optimizer_mode "SO3xR3": c2w takes a gradient, through
    viewmat and through the normals' frame change."""
    _ps_check(dev, PS_ROWS, mode, camera_grad=True, seed=5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 64, 127, 129, 4099])
def test_project_screen_kernel_small_and_partial_grads(dev, n):
    """Ragged last CTAs, and gradients of the features alone: the other
    incoming gradients are None."""
    _ps_check(dev, n, "classic", camera_grad=True, seed=n,
              grads_of=("features",))


@pytest.mark.cuda
def test_project_screen_kernel_unaligned_quats(dev):
    """Quaternion rows not on a 16-byte boundary take the word loads."""
    cam, arrays, alive = _ps_inputs(dev, 1000, 3)
    buf = torch.empty(1000 * 4 + 1, device=dev)
    buf[1:] = arrays[1].reshape(-1)
    quats = buf[1:].view(1000, 4)
    assert quats.data_ptr() % 16 != 0
    arrays = (arrays[0], quats, *arrays[2:])
    got = rc.project_screen(*arrays, alive, cam.viewmat(), cam.c2w, cam.fx,
                            cam.fy, cam.cx, cam.cy, cam.width, cam.height)
    want = rc.project_screen_plain(*arrays, alive, cam.viewmat(), cam.c2w,
                                   cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
                                   cam.height)
    for a, b in zip(got, want):
        assert torch.equal(a, b) if a.dtype == torch.bool else \
            float((a - b).abs().max()) <= PS_TOL * float(b.abs().max())


@pytest.mark.cuda
def test_project_screen_kernel_refuses_bad_inputs(dev):
    cam, arrays, alive = _ps_inputs(dev, 64, 0, width=96, height=64)
    means, quats, scales, opac, colors = arrays
    cam_args = (cam.viewmat(), cam.c2w, cam.fx, cam.fy, cam.cx, cam.cy)
    fx_cpu = cam.fx.cpu()
    bad = {
        "float64 means": ((means.double(), quats, scales, opac, colors,
                           alive) + cam_args),
        "quats shape": ((means, quats[:, :3], scales, opac, colors, alive)
                        + cam_args),
        "scales rows": ((means, quats, scales[:-1], opac, colors, alive)
                        + cam_args),
        "opacities shape": ((means, quats, scales, opac[:, None], colors,
                             alive) + cam_args),
        "colors on the CPU": ((means, quats, scales, opac, colors.cpu(),
                               alive) + cam_args),
        "viewmat shape": ((means, quats, scales, opac, colors, alive,
                           cam_args[0][:3]) + cam_args[1:]),
        "fx on the CPU": ((means, quats, scales, opac, colors, alive)
                          + cam_args[:2] + (fx_cpu,) + cam_args[3:]),
        "fx needs a gradient": ((means, quats, scales, opac, colors, alive)
                                + cam_args[:2]
                                + (cam.fx.clone().requires_grad_(True),)
                                + cam_args[3:]),
    }
    before = dict(rc.LAUNCHES)
    for what, args in bad.items():
        with pytest.raises(ValueError, match="project_screen"):
            rc.project_screen(*args, 96, 64)
    assert dict(rc.LAUNCHES) == before


@pytest.mark.cuda
def test_project_screen_launches_once_a_step_and_once_a_frame(dev):
    """One Trainer step at the benchmark's defaults (`TrainConfig()`)
    launches the forward once and the backward once and reads the host as
    before (the nonzero of the live slots, then the loss and the alive count
    at the end of `train`); a served frame launches the forward alone."""
    from dnsplatter_torch.data.synthetic import make_synthetic_scene
    from dnsplatter_torch.models.dn_model import ModelConfig
    from dnsplatter_torch.train.trainer import TrainConfig, Trainer
    from dnsplatter_torch.utils import profiling

    scene = make_synthetic_scene(seed=0, n_gaussians=300, n_cameras=4,
                                 width=96, height=64, pair_capacity=1 << 14,
                                 device=dev)
    pts, cols = scene.seed_points(np.random.default_rng(1), noise=0.03)
    tr = Trainer(scene, (pts, cols),
                 model_cfg=ModelConfig(use_depth_loss=True, depth_lambda=0.2,
                                       warmup_length=10_000),
                 train_cfg=TrainConfig(), device=dev)
    tr.train(2, log_every=1 << 30)
    with profiling.recording():
        tr.train(1, log_every=1 << 30)
    c = profiling.record()["counters"]
    assert c["launch.project_screen"] == 1
    assert c["launch.project_screen_backward"] == 1
    assert c["launch.sh_colors"] == 1
    assert {k: v for k, v in c.items() if k.startswith("sync.")} == {
        "sync.live_slots": 1, "sync.loss": 1, "sync.alive_count": 1}
    from dnsplatter_torch.models.dn_model import get_outputs

    cam, _ = scene.get(0)
    rc.LAUNCHES.clear()
    with torch.no_grad():
        get_outputs(tr.params, tr.alive, cam, tr.model_cfg,
                    tr._raster_cfg(cam), sh_degree=3, training=False)
    torch.cuda.synchronize()
    assert [rc.LAUNCHES[k] for k in ("project_screen",
                                     "project_screen_backward")] == [1, 0]


# ---------------------------------------------------------------------------
# ssim
# ---------------------------------------------------------------------------


def _ssim_pair(dev, h, w, c, seed):
    """A target in [0, 1] and a prediction near it, with patches of 0.5 and
    0.25 where whole windows see one value."""
    g = torch.Generator(dev).manual_seed(seed)
    gt = torch.rand(h, w, c, device=dev, generator=g)
    pred = torch.clamp(
        gt + 0.05 * torch.randn(h, w, c, device=dev, generator=g), 0.0, 1.0)
    pred[2:h - 3, 3:w // 2 + 8] = 0.5
    gt[4:h - 1, 1:w // 2] = 0.25
    return pred, gt


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,k", [(1200, 1600, 3, 11), (576, 1024, 3, 11),
                                     (37, 45, 3, 11), (23, 17, 1, 7),
                                     (40, 52, 4, 3), (11, 11, 3, 11)])
def test_ssim_kernel_matches_plain(dev, h, w, c, k):
    from dnsplatter_torch.models import losses as L

    pred, gt = _ssim_pair(dev, h, w, c, seed=h + w + c + k)
    win = L._gaussian_window(k, 1.5, device=dev)
    before = (rc.LAUNCHES["ssim"], rc.LAUNCHES["ssim_backward"])
    mean, smap = rc.ssim_forward(pred, gt, win, 1e-4, 9e-4, per_pixel=True)
    assert torch.equal(smap.view(torch.int32),
                       L.ssim_map_plain(pred, gt, k).view(torch.int32))
    lk = pred.clone().requires_grad_(True)
    lp = pred.clone().requires_grad_(True)
    got = L.ssim(lk, gt, kernel_size=k)
    gk = torch.autograd.grad(got, lk)[0]
    want = L.ssim_plain(lp, gt, kernel_size=k)
    gp = torch.autograd.grad(want, lp)[0]
    assert (rc.LAUNCHES["ssim"], rc.LAUNCHES["ssim_backward"]) == (
        before[0] + 2, before[1] + 1)
    assert torch.equal(got.detach(), mean)
    want = float(want.detach())
    assert abs(float(mean) - want) <= 1e-6 * abs(want)
    assert float((gk - gp).abs().max()) <= 1e-5 * float(gp.abs().max())
    again = L.ssim(lk, gt, kernel_size=k)
    assert torch.equal(again.detach(), mean)
    assert torch.equal(torch.autograd.grad(again, lk)[0], gk)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c", [(40, 52, 3), (37, 45, 3)])
def test_ssim_kernel_reads_unaligned_images(dev, h, w, c):
    """Images that start 4 bytes past a 16-byte boundary (the staging's
    four-load path for every quad) give the same bits as aligned copies:
    the map, the mean and d img1."""
    from dnsplatter_torch.models import losses as L

    pred, gt = _ssim_pair(dev, h, w, c, seed=h * w)
    win = L._gaussian_window(11, 1.5, device=dev)
    shifted = []
    for t in (pred, gt):
        buf = torch.empty(t.numel() + 1, device=dev)
        view = buf[1:].view(h, w, c)
        view.copy_(t)
        assert view.data_ptr() % 16 == 4
        shifted.append(view)
    want = rc.ssim_forward(pred, gt, win, 1e-4, 9e-4, per_pixel=True)
    got = rc.ssim_forward(*shifted, win, 1e-4, 9e-4, per_pixel=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    g = torch.ones((), device=dev)
    assert torch.equal(rc.ssim_backward(*shifted, win, 1e-4, 9e-4, g),
                       rc.ssim_backward(pred, gt, win, 1e-4, 9e-4, g))


@pytest.mark.cuda
def test_ssim_routes_by_input(dev):
    """On the card `losses.ssim` runs the kernel or raises: a window over 11
    taps, float64, an image smaller than the window, five channels, shapes
    that differ and img2 taking a gradient raise a ValueError there and in
    the kernel's own wrapper, launch nothing and never reach
    `ssim_plain`."""
    from dnsplatter_torch.models import losses as L

    pred, gt = _ssim_pair(dev, 40, 48, 3, seed=1)
    five = torch.rand(40, 48, 5, device=dev)
    cases = {
        "kernel 13": (pred, gt, 13),
        "float64": (pred.double(), gt.double(), 11),
        "small": (pred[:9], gt[:9], 11),
        "channels": (five, five.flip(0), 11),
        "shapes": (pred, gt[:, :47], 11),
        "img2 grad": (pred, gt.clone().requires_grad_(True), 11),
    }
    before = dict(rc.LAUNCHES)
    for what, (a, b, k) in cases.items():
        with pytest.raises(ValueError, match="ssim"):
            L.ssim(a, b, k)
        with pytest.raises(ValueError, match="ssim"):
            rc.ssim(a, b, L._gaussian_window(k, 1.5, device=dev), 1e-4,
                    9e-4)
    assert dict(rc.LAUNCHES) == before
    L.ssim(pred, gt, 11)
    assert rc.LAUNCHES["ssim"] == before.get("ssim", 0) + 1


@pytest.mark.cuda
def test_ssim_launches_once_a_step(dev):
    """One `train_step` launches the SSIM forward and backward once
    each."""
    _counted_train_step(dev)
    assert [rc.LAUNCHES[k] for k in ("ssim", "ssim_backward")] == [1, 1]
