"""dnsplatter_torch's boundary reductions and prefix sum against the JAX
package: the plain versions of `reduce_segments_packed`,
`reduce_segments_packed_multi`, `reduce_segments` and `cumsum_lanes_i32`
held to the Pallas kernels (interpreter) on the same numpy-seeded inputs,
and the autograd function under the configurations that reach them held to
`jax.grad` of the JAX pallas backend; the kernel wrappers' arguments and
refusals through fake C entries, and the A/B script's knowledge of the
two kernels' C entries.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from dnsplatter_torch.ops import rasterize as trz
from dnsplatter_torch.ops import rasterize_cuda as rc
from dnsplatter_tpu.ops import rasterize as jrz
from dnsplatter_tpu.ops import rasterize_pallas as rp

from test_torch_backward import _assert_grads_close, _grads_both
from test_torch_rasterize import make_scene

# one process per core already: no intra-op threads on top
torch.set_num_threads(1)
NEW_KERNELS = ("reduce_segments_packed", "reduce_segments_packed_multi",
               "reduce_segments", "cumsum_lanes_i32")


def _ranges(rng, n, empty_frac=0.3, max_len=9):
    """(N + 1,) ascending boundaries from 0 with empty ranges, id 7 among
    them."""
    lens = rng.integers(1, max_len, n)
    lens[rng.uniform(size=n) < empty_frac] = 0
    lens[7] = 0
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _pack_rows(vals):
    """(2 PR, L) float32 -> (PR, L) int32 of bf16 pairs, by the JAX packer."""
    return np.stack([np.asarray(jrz._pack_bf16_2(jnp.asarray(vals[2 * i]),
                                                 jnp.asarray(vals[2 * i + 1])))
                     for i in range(vals.shape[0] // 2)])


def _bf16(vals):
    return np.asarray(jnp.asarray(vals).astype(jnp.bfloat16).astype(
        jnp.float32))


def _expect_packed(v16, starts, n):
    """Per-range sums of the bf16-rounded values, in float64."""
    out = np.zeros((v16.shape[0] + 2, n))
    for g in range(n):
        seg = v16[:, starts[g]:starts[g + 1]].astype(np.float64)
        out[:-2, g] = seg.sum(axis=1)
        out[-2, g] = np.abs(seg[0]).sum()
        out[-1, g] = np.abs(seg[1]).sum()
    return out


@pytest.mark.parametrize("shape", [(4, 1000), (5, 5000), (1, 2049)])
def test_cumsum_lanes_i32_plain_bit_equal(shape):
    """Below 2^24 (where the Pallas kernel is exact) bit for bit; above it
    the port still adds integers exactly, and wraps like int32."""
    rng = np.random.default_rng(shape[1])
    x = rng.integers(-50, 60, shape).astype(np.int32)
    want = np.asarray(rp.cumsum_lanes_i32(jnp.asarray(x)))
    got = rc.cumsum_lanes_i32(torch.as_tensor(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() < 1 << 24
    big = rng.integers(1 << 26, 1 << 28, shape).astype(np.int32)
    got = rc.cumsum_lanes_i32(torch.as_tensor(big)).numpy()
    np.testing.assert_array_equal(
        got, np.cumsum(big.astype(np.int64), axis=1).astype(np.int32))
    assert rc.LAUNCHES["cumsum_lanes_i32"] == 0


@pytest.mark.parametrize("gw,seed", [(16, 0), (11, 1)])
def test_reduce_segments_plain_matches_pallas(gw, seed):
    """Float32 sums over contiguous ranges, rtol 1e-5 (another summation
    order); lanes past starts[N] hold 1e9 and must never be read."""
    rng = np.random.default_rng(seed)
    n = 300
    starts = _ranges(rng, n)
    length = int(starts[-1]) + 40
    grads = rng.normal(size=(gw, length)).astype(np.float32)
    grads[:, starts[-1]:] = 1e9
    # the Pallas kernel streams 512-lane chunks: it wants a tail, of zeros
    padded = np.concatenate([grads[:, :starts[-1]],
                             np.zeros((gw, 512), np.float32)], axis=1)
    want = np.asarray(rp.reduce_segments(jnp.asarray(padded),
                                         jnp.asarray(starts), n))[:, :n]
    got = rc.reduce_segments(torch.as_tensor(grads), torch.as_tensor(starts),
                             n).numpy()
    assert got.shape == (gw, n)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    empty = np.diff(starts) == 0
    assert empty[7] and (got[:, empty] == 0.0).all()
    assert rc.LAUNCHES["reduce_segments"] == 0


@pytest.mark.parametrize("pr,seed", [(4, 0), (7, 1)])
def test_reduce_segments_packed_plain_matches_pallas(pr, seed):
    rng = np.random.default_rng(seed)
    n = 300
    starts = _ranges(rng, n)
    length = int(starts[-1]) + 40
    vals = rng.normal(size=(2 * pr, length)).astype(np.float32)
    vals[:, starts[-1]:] = 1e9
    packed = _pack_rows(vals)
    padded = np.concatenate([packed[:, :starts[-1]],
                             np.zeros((pr, 512), np.int32)], axis=1)
    want = np.asarray(rp.reduce_segments_packed(
        jnp.asarray(padded), jnp.asarray(starts), n))[:, :n]
    got = rc.reduce_segments_packed(torch.as_tensor(packed),
                                    torch.as_tensor(starts), n).numpy()
    assert got.shape == (2 * pr + 2, n)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _expect_packed(_bf16(vals), starts, n),
                               rtol=1e-5, atol=1e-5)
    empty = np.diff(starts) == 0
    assert empty[7] and (got[:, empty] == 0.0).all()
    assert rc.LAUNCHES["reduce_segments_packed"] == 0


@pytest.mark.parametrize("kp,pr,seed", [(2, 4, 0), (4, 7, 1)])
def test_reduce_segments_packed_multi_plain_matches_pallas(kp, pr, seed):
    """KP pieces of different lengths in one (KP, PR, CP) tensor, each with
    its own piece-local boundaries; the lanes past a piece's end hold 1e9."""
    rng = np.random.default_rng(seed)
    n = 300
    starts = np.stack([_ranges(rng, n, empty_frac=0.5, max_len=4 + 2 * j)
                       for j in range(kp)])
    cp = int(starts[:, -1].max()) + 8
    vals = rng.normal(size=(kp, 2 * pr, cp)).astype(np.float32)
    for j in range(kp):
        vals[j, :, starts[j, -1]:] = 1e9
    packed = np.stack([_pack_rows(vals[j]) for j in range(kp)])
    padded = np.zeros((kp, pr, cp + 512), np.int32)
    for j in range(kp):
        padded[j, :, :starts[j, -1]] = packed[j, :, :starts[j, -1]]
    want = np.asarray(rp.reduce_segments_packed_multi(
        jnp.asarray(padded), jnp.asarray(starts), n))[:, :n]
    got = rc.reduce_segments_packed_multi(
        torch.as_tensor(packed), torch.as_tensor(starts), n).numpy()
    assert got.shape == (2 * pr + 2, n)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    expect = sum(_expect_packed(_bf16(vals[j]), starts[j], n)
                 for j in range(kp))
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)
    empty = (np.diff(starts, axis=1) == 0).all(axis=0)
    assert empty[7] and (got[:, empty] == 0.0).all()
    assert rc.LAUNCHES["reduce_segments_packed_multi"] == 0


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The argument checks run before the kernel is built, so they can be
    driven on the CPU through the meta device, which is neither a card nor
    the CPU: every wrapper refuses it by name."""
    x = torch.zeros((4, 64), dtype=torch.int32, device="meta")
    s = torch.zeros((9,), dtype=torch.int32, device="meta")
    for call in (lambda: rc.reduce_segments_packed(x, s, 8),
                 lambda: rc.reduce_segments_packed_multi(x[None], s[None], 8),
                 lambda: rc.reduce_segments(x.float(), s, 8),
                 lambda: rc.cumsum_lanes_i32(x)):
        with pytest.raises(ValueError, match="no kernel or plain path"):
            call()


_CFG_KW = dict(width=48, height=32, tile_size=16, chunk=16, tile_block=2,
               pair_capacity=1 << 13)


@pytest.mark.parametrize("scheme,pieces,kernel", [
    ("packed32", 0, "reduce_segments_packed"),
    ("packed32", 4, "reduce_segments_packed_multi"),
    ("depthq", 2, "reduce_segments_packed_multi"),
])
def test_rasterize_grads_packed_boundary_paths_match_jax(scheme, pieces,
                                                         kernel):
    """compact_frac = 0: the whole slab sorted by id and summed over the
    ranges known from binning, in one piece or in several. Both sides pack
    per-pair gradients to bf16: rtol 2e-2 / atol 2e-3 of each array's
    largest magnitude (tests/test_rasterize_pallas.py:57)."""
    s = make_scene(1, n=250, width=48, height=32, f=4)
    cfg_kw = dict(_CFG_KW, grad_reduce="sortpack", sort_scheme=scheme,
                  reduce_pieces=pieces, compact_frac=0.0)
    used = []
    with pytest.MonkeyPatch.context() as mp:
        for name in NEW_KERNELS + ("reduce_segments_bykey",):
            orig = getattr(rc, name)
            mp.setattr(rc, name, lambda *a, _o=orig, _n=name: (
                used.append(_n), _o(*a))[1])
        jg, tg = _grads_both(s, cfg_kw, seed=1, f=4)
    assert used == [kernel]
    _assert_grads_close(jg, tg, rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("scheme,f", [("packed", 4), ("depthq", 7)])
def test_rasterize_grads_segsum_match_jax(scheme, f):
    """The exact float32 reduction: the JAX package's segment_sum against
    the port's sorted runs through `reduce_segments`, rtol 1e-4 / atol 1e-5
    (tests/test_rasterize_pallas.py:55): only summation order differs."""
    s = make_scene(2, n=250, width=48, height=32, f=f)
    cfg_kw = dict(_CFG_KW, grad_reduce="segsum", sort_scheme=scheme)
    used = []
    orig = rc.reduce_segments
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rc, "reduce_segments",
                   lambda g, st, n: (used.append(g.shape), orig(g, st, n))[1])
        jg, tg = _grads_both(s, cfg_kw, seed=2, f=f)
    assert used == [(8 + f, cfg_kw["pair_capacity"] + cfg_kw["chunk"])]
    _assert_grads_close(jg, tg, rtol=1e-4, atol=1e-5)


def test_boundary_paths_agree_with_the_default_path():
    """One frame, five routes: the packed routes see the same bf16 per-pair
    values and differ only in float32 summation order (rtol 1e-4 / atol
    1e-5 of each array's scale); segsum, which never rounds to bf16, sits
    within rtol 2e-2 / atol 1e-2 of them (per-pair bf16 rounding under
    sums that cancel). Culling on, so the ranges hold culled slots."""
    s = make_scene(3, n=300, width=64, height=48, f=7)
    base = dict(width=64, height=48, tile_size=16, chunk=32, tile_block=4,
                pair_capacity=1 << 14, sort_scheme="packed",
                exact_cull=True)
    routes = {
        "bykey": {},
        "full": {"compact_frac": 1.0},
        "packed": {"compact_frac": 0.0},
        "multi": {"compact_frac": 0.0, "reduce_pieces": 3},
        "segsum": {"grad_reduce": "segsum"},
    }
    grads = {}
    for name, kw in routes.items():
        leaves = [torch.as_tensor(s[k]).clone().requires_grad_(True)
                  for k in ("means2d", "conics", "opac", "feats")]
        sink = torch.zeros_like(leaves[0]).requires_grad_(True)
        img, a = trz.rasterize(
            leaves[0], leaves[1], torch.as_tensor(s["depths"]), leaves[2],
            leaves[3], torch.as_tensor(s["valid"]),
            trz.RasterizeConfig(**dict(base, **kw)), absgrad_sink=sink,
            radii=torch.as_tensor(s["radii_xy"]))
        loss = (img ** 2).sum() + (a ** 2).sum()
        grads[name] = [g.numpy() for g in
                       torch.autograd.grad(loss, leaves + [sink])]
    for name in ("full", "packed", "multi"):
        _assert_grads_close(grads["bykey"], grads[name], rtol=1e-4,
                            atol=1e-5)
    _assert_grads_close(grads["segsum"], grads["bykey"], rtol=2e-2,
                        atol=1e-2)


def test_compare_reduce_names_its_kernel():
    """chip_smoke.py's reduce comparison serves every reduction kernel and
    names the one that disagreed."""
    want = torch.randn(10, 40)
    chip_smoke.compare_reduce(want.clone(), want, "reduce_segments_packed")
    with pytest.raises(AssertionError, match="reduce_segments_packed "):
        chip_smoke.compare_reduce(want * 1.01, want,
                                  "reduce_segments_packed")


def test_reduce_segments_plain_matches_pallas_heavy_tail():
    """The main path's row count (GW = 15) over a heavy-tailed set of
    ranges, one of them a Gaussian over many tiles (2,304 lanes), against
    the Pallas kernel by chip_smoke's `compare_reduce`: rtol 1e-5, atol
    1e-5 of the row's largest magnitude (another summation order over
    2,304 terms that cancel); lanes past starts[N] hold 1e9 and NaN and
    are never read."""
    rng = np.random.default_rng(15)
    n = 40
    lens = rng.integers(0, 9, n)
    lens[3] = 0
    lens[17] = 2304
    starts = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    length = int(starts[-1]) + 40
    grads = rng.normal(size=(15, length)).astype(np.float32)
    grads[:, starts[-1]::2] = 1e9
    grads[:, starts[-1] + 1::2] = np.nan
    padded = np.concatenate([grads[:, :starts[-1]],
                             np.zeros((15, 512), np.float32)], axis=1)
    want = np.asarray(rp.reduce_segments(jnp.asarray(padded),
                                         jnp.asarray(starts), n))[:, :n]
    got = rc.reduce_segments(torch.as_tensor(grads), torch.as_tensor(starts),
                             n)
    chip_smoke.compare_reduce(got, torch.as_tensor(want), "reduce_segments")
    assert bool((got[:, 3] == 0.0).all()) and bool(torch.isfinite(got).all())
    assert rc.LAUNCHES["reduce_segments"] == 0


@pytest.mark.parametrize("rows,c,aligned,words", [
    (4, 12_582_912, True, 1 + 4 * 1024),  # the serve-2p24 table
    (4, 12_582_912, False, 1 + 4 * 1025),
    (1, 1, True, 2),
    (1, 1, False, 2),
    (3, 12_285, False, 1 + 3),  # 12,285 + 3 lanes fill one tile exactly
    (3, 12_286, False, 1 + 3 * 2),
    (5, 12_289, True, 1 + 5 * 2),
])
def test_cumsum_scratch_words(rows, c, aligned, words):
    """The prefix sum's scratch: its tile counter, then one status word per
    12,288-lane tile of each row; a row that may start off a 16-byte
    boundary is tiled from the boundary below and needs 3 lanes more."""
    assert rc.CUMSUM_TILE == 12288
    assert rc.cumsum_scratch_words(rows, c, aligned) == words


@pytest.mark.parametrize("tile,words", [(4096, 1 + 4 * 3072),
                                        (8192, 1 + 4 * 1536),
                                        (16384, 1 + 4 * 768)])
def test_cumsum_scratch_words_other_tiles(tile, words):
    """The scratch of a variant prefix sum with other tiles (the A/B
    script's `--cumsum-tile`), at the serve-2p24 table."""
    assert rc.cumsum_scratch_words(4, 12_582_912, True, tile) == words


class _FakeEntry:
    """Stands in for a kernel's C entry: records the arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def card_route(monkeypatch):
    """The wrappers' checks and arguments on the CPU: every tensor routed to
    the kernel, whose C entries are fakes."""
    fakes = collections.defaultdict(_FakeEntry)
    monkeypatch.setattr(rc, "_route", lambda t, what: True)
    monkeypatch.setattr(rc, "_entry", lambda name: fakes[name])
    monkeypatch.setattr(rc, "_stream", lambda: 0)
    monkeypatch.setattr(rc, "LAUNCHES", collections.Counter())
    return fakes


def test_cumsum_wrapper_arguments_and_refusals(card_route):
    """cumsum_lanes_i32 sizes its zeroed scratch by `cumsum_scratch_words`,
    launches once, and refuses a table the kernel does not take."""
    fakes = card_route
    x = torch.arange(4 * 4097, dtype=torch.int32).reshape(4, 4097)
    rc.cumsum_lanes_i32(x)
    (args,) = fakes["cumsum_lanes_i32"].calls
    assert args[0] == x.data_ptr()
    assert args[3:] == (rc.cumsum_scratch_words(4, 4097, False), 4, 4097, 0)
    assert rc.LAUNCHES["cumsum_lanes_i32"] == 1
    for bad, match in ((x.t(), "contiguous"), (x.float(), "int32"),
                       (x[None], "int32"),
                       (torch.zeros((65536, 1), dtype=torch.int32), "65535")):
        with pytest.raises(ValueError, match=match):
            rc.cumsum_lanes_i32(bad)
    assert rc.LAUNCHES["cumsum_lanes_i32"] == 1


def test_reduce_segments_wrapper_arguments_and_refusals(card_route):
    """reduce_segments passes the slab's stride and length, GW and n,
    launches once, and refuses a slab or boundaries the kernel does not
    take."""
    fakes = card_route
    n = 126_976  # the train-100k state
    grads = torch.zeros((15, 64))
    starts = torch.zeros(n + 1, dtype=torch.int32)
    rc.reduce_segments(grads, starts, n)
    (args,) = fakes["reduce_segments"].calls
    assert args[1:3] == (64, 64) and args[4:6] == (15, n)
    assert args[3] == starts.data_ptr() and args[8] == 0
    assert rc.LAUNCHES["reduce_segments"] == 1
    for g, s, match in (
            (torch.zeros((17, 64)), starts, "grads"),  # GW > 16
            (torch.zeros((0, 64)), starts, "grads"),
            (grads.int(), starts, "grads"),
            (torch.zeros((64, 15)).t(), starts, "grads"),  # not row-contiguous
            (grads, starts[:-1], "boundaries"),
            (grads, starts.long(), "boundaries"),
            (grads, starts.view(1, -1), "boundaries"),
            (grads, torch.zeros(2 * n + 2, dtype=torch.int32)[::2],
             "boundaries")):
        with pytest.raises(ValueError, match=match):
            rc.reduce_segments(g, s, n)
    assert rc.LAUNCHES["reduce_segments"] == 1


def test_ab_script_knows_the_prefix_sum_and_segment_reduction():
    """ab_tile_kernels.py's entries for the two kernels: every current C
    entry's parameter types match the wrapper's ctypes; the earlier
    three-kernel prefix sum's entry matches BASELINE_ARGTYPES and differs
    from the current one, while the one-thread-per-id reduction's is the
    current one's (the redesign kept its arguments); the ptxas lookup
    finds the scan and the GW = 15 reduction instance."""
    from pathlib import Path

    from dnsplatter_torch.scripts import ab_tile_kernels as ab

    ctype = {"const void*": ab._VP, "void*": ab._VP, "int": ab._I,
             "long long": ab._LL}
    csrc = Path(rc.kernel_build.CSRC_DIR)
    for name, (lib, sym, argtypes) in rc._ENTRIES.items():
        params = ab.c_entry_params((csrc / f"{lib}.cu").read_text(), sym)
        assert [ctype[p] for p in params] == argtypes, name
    old = {
        "cumsum_lanes_i32": (
            'extern "C" int dns_cumsum_lanes_i32(const void* x, void* out, '
            'void* totals,\n    int totals_per_row, int rows, long long c,\n'
            '    void* stream) {'),
        "reduce_segments": (
            'extern "C" int dns_reduce_segments(const void* grads, long long '
            'stride, int len,\n    const void* starts, int gw, int n, void* '
            'out,\n    long long out_stride, void* stream) {'),
    }
    params = {name: (ab.c_entry_params(src, rc._ENTRIES[name][1]),
                     ab.c_entry_params((csrc / f"{name}.cu").read_text(),
                                       rc._ENTRIES[name][1]))
              for name, src in old.items()}
    old_scan, new_scan = params["cumsum_lanes_i32"]
    assert [ctype[p] for p in old_scan] == ab.BASELINE_ARGTYPES[
        "cumsum_lanes_i32"]
    assert old_scan != new_scan
    old_reduce, new_reduce = params["reduce_segments"]
    assert old_reduce == new_reduce
    assert "reduce_segments" not in ab.BASELINE_ARGTYPES

    def entry(mangled, regs, smem):
        return (f"ptxas info    : Compiling entry function '{mangled}' for "
                f"'sm_90a'\nptxas info    : Used {regs} registers, used 1 "
                f"barriers, {smem} bytes smem, 400 bytes cmem[0]\n")

    scan = (entry("_ZN12_GLOBAL__N_112add_offsetsEPjPKjixi", 30, 128)
            + entry("_ZN12_GLOBAL__N_110scan_tilesEPKjPjPyxixb", 32, 144))
    rep = ab._report("cumsum_lanes_i32", scan, 256,
                     ab.TAGS[("current", "cumsum_lanes_i32")])
    assert rep == {"registers": 32, "smem": 144, "threads": 256,
                   "resident_ctas": 8}
    red = "".join(entry(f"_ZN12_GLOBAL__N_122reduce_segments_kernelILi{gw}"
                        "EEEvPKfxiPKiiPfxb", 40 + gw, gw * 512 + 716)
                  for gw in range(1, 17))
    rep = ab._report("reduce_segments", red, ab.THREADS["reduce_segments"],
                     ab.TAGS[("current", "reduce_segments")])
    assert (rep["registers"], rep["smem"]) == (55, 8396)
    legacy = "".join(entry(f"_ZN12_GLOBAL__N_122reduce_segments_kernelILi{gw}"
                           "EEEvPKfxiPKiiPfx", 30 + gw, 0)
                     for gw in range(1, 17))
    rep = ab._report("reduce_segments", legacy, 128,
                     ab.TAGS[("baseline", "reduce_segments")])
    assert (rep["registers"], rep["smem"]) == (45, 0)
    assert set(ab.KERNELS) == set(ab.ENTRY_NAMES) == set(ab.THREADS) == set(
        ab.REPS)
    assert all((v, k) in ab.TAGS for v in ("baseline", "current")
               for k in ab.KERNELS)
