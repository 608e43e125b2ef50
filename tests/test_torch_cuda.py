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
