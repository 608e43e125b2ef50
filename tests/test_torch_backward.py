"""dnsplatter_torch's rasterizer backward against the JAX package.

The plain versions of `backward_tiles` and `reduce_segments_bykey` are held
to the Pallas kernels (interpreter) on the same payload, CSR, cotangents,
`t_final` and `last`; the autograd function is held to `jax.grad` of the
JAX pallas backend at the JAX package's own sortpack tolerance. The CPU
parts of chip_smoke.py's checks (slab comparison, the work count behind the
backward's bound) are tested here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from dnsplatter_torch.ops import rasterize as trz
from dnsplatter_torch.ops import rasterize_cuda as rc
from dnsplatter_tpu.ops import rasterize as jrz
from dnsplatter_tpu.ops import rasterize_pallas as rp

from test_torch_rasterize import _jax_payload, make_scene

# one process per core already: no intra-op threads on top
torch.set_num_threads(1)
GRAD_NAMES = ["means2d", "conics", "opacities", "features", "absgrad"]


def test_pack_bf16_2_bit_equal():
    """The integer round-to-nearest-even packer against the JAX package's
    astype(bfloat16) packer, word for word: normals, ties (exactly half an
    ulp, both parities), -0.0, subnormals, the largest finite values and
    infinities."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=4096).astype(np.float32) * np.exp(
        rng.uniform(-30, 30, 4096)).astype(np.float32)
    special = np.array(
        [0.0, -0.0, 1.0, -1.0, 1e-40, -1e-40, 1.4e-45, 3.0e38, -3.0e38,
         np.inf, -np.inf, 65504.0], np.float32)
    # ties: a bf16 value plus exactly half its ulp, even and odd mantissas
    base = (rng.integers(0x3000, 0x4F00, 512).astype(np.uint32) << 16)
    ties = (base | 0x8000).view(np.float32)
    near = np.concatenate([(base | 0x7FFF).view(np.float32),
                           (base | 0x8001).view(np.float32)])
    x = np.concatenate([a, special, ties, -ties, near])
    y = x[::-1].copy()
    want = np.asarray(jrz._pack_bf16_2(jnp.asarray(x), jnp.asarray(y)))
    got = rc.pack_bf16_2(torch.as_tensor(x), torch.as_tensor(y))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    hi, lo = rc.unpack_bf16_2(got)
    j_hi, j_lo = jrz._unpack_bf16_2(jnp.asarray(want))
    np.testing.assert_array_equal(hi.numpy().view(np.int32),
                                  np.asarray(j_hi).view(np.int32))
    np.testing.assert_array_equal(lo.numpy().view(np.int32),
                                  np.asarray(j_lo).view(np.int32))


def _backward_inputs(seed, chunk, f=4, n=400, opaque_front=False):
    """Payload and CSR from the JAX binning, forward residuals from the
    JAX forward kernel, random cotangents."""
    s = make_scene(seed, n=n, width=64, height=48, f=f)
    if opaque_front:
        s["opac"] = np.where(s["depths"] < np.median(s["depths"]), 0.98,
                             s["opac"]).astype(np.float32)
    cfg = jrz.RasterizeConfig(width=64, height=48, tile_size=16, chunk=chunk,
                              tile_block=4, pair_capacity=1 << 13,
                              backend="pallas")
    payload, starts, counts = _jax_payload(cfg, s)
    t = cfg.n_tiles_padded
    geom = (t, f, 16, cfg.tiles_x, chunk)
    _, tfin, last = rp.forward_tiles(jnp.asarray(payload), jnp.asarray(starts),
                                     jnp.asarray(counts), *geom)
    rng = np.random.default_rng(seed + 50)
    g_out = rng.normal(size=(t, f, 256)).astype(np.float32)
    g_alpha = rng.normal(size=(t, 1, 256)).astype(np.float32)
    arrays = (payload, starts, counts, g_out, g_alpha, np.asarray(tfin),
              np.asarray(last))
    return arrays, geom


def _jax_backward_merged(arrays, geom, pack_grads):
    """rp.backward_tiles with each tile's staged head window merged into
    the slab as ops/rasterize.py:1419-1423 does."""
    chunk = geom[4]
    grads, stage, _ = rp.backward_tiles(*(jnp.asarray(a) for a in arrays),
                                        *geom, pack_grads=pack_grads)
    nwin = grads.shape[1] // chunk
    w0 = jnp.asarray(arrays[1])[:-1] // chunk
    merged = (grads.reshape(grads.shape[0], nwin, chunk)
              .at[:, w0].add(jnp.moveaxis(stage, 0, 1))
              .reshape(grads.shape[0], nwin * chunk))
    return np.asarray(merged)


@pytest.mark.parametrize("seed,chunk,f", [(0, 16, 4), (1, 32, 7)])
def test_backward_tiles_plain_matches_pallas_f32(seed, chunk, f):
    """Unpacked rows: rtol 1e-4 of each row's largest magnitude (the same
    arithmetic, another summation order over the 256 pixels)."""
    arrays, geom = _backward_inputs(seed, chunk, f=f)
    want = _jax_backward_merged(arrays, geom, pack_grads=False)
    got = rc.backward_tiles(*(torch.as_tensor(a) for a in arrays), *geom,
                            pack_grads=False).numpy()
    assert got.shape == want.shape == (16, arrays[0].shape[1])
    for r in list(range(6 + f)) + [14, 15]:
        scale = max(np.abs(want[r]).max(), 1e-6)
        np.testing.assert_allclose(got[r] / scale, want[r] / scale,
                                   rtol=1e-4, atol=1e-4, err_msg=f"row {r}")
    assert np.abs(want[:6 + f]).max() > 1e-2  # the scene has gradients
    assert rc.LAUNCHES["backward_tiles"] == 0


@pytest.mark.parametrize("seed,chunk,f", [(2, 16, 4), (3, 32, 7)])
def test_backward_tiles_plain_matches_pallas_packed(seed, chunk, f):
    """Packed rows, decoded: within one bf16 ulp (a sum rounded in another
    order can land on the other side of a rounding boundary), and integer
    zeros in every slot the Pallas kernel leaves unwritten."""
    arrays, geom = _backward_inputs(seed, chunk, f=f, opaque_front=True)
    want = _jax_backward_merged(arrays, geom, pack_grads=True)
    got = rc.backward_tiles(*(torch.as_tensor(a) for a in arrays), *geom,
                            pack_grads=True)
    assert got.dtype == torch.int32 and got.shape == want.shape
    ru = rc.packed_rows(f)
    a = chip_smoke.decode_slab(got, f).numpy()
    b = chip_smoke.decode_slab(torch.as_tensor(want), f).numpy()
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-38))) - 7.0)
    # one bf16 ulp, plus the float32 rounding of a sum of 256 terms that
    # cancel (1e-6 of the row's largest value)
    slack = 1e-6 * np.abs(b).max(axis=1, keepdims=True)
    assert (np.abs(a - b) <= ulp + slack).all()
    assert (np.abs(a - b) > 0).mean() < 0.05
    # rows past the packed fields, and slots past each tile's deepest
    # contributor, are integer zeros in both
    assert (got[ru:] == 0).all()
    p, starts, counts, last = 256, arrays[1], arrays[2], arrays[6]
    dead = np.ones(got.shape[1], bool)
    for t in range(geom[0]):
        ml = min(int(last[t].max()), int(counts[t]) - 1)
        dead[starts[t]:starts[t] + ml + 1] = False
    assert dead.sum() > 0.2 * int(starts[geom[0]])  # early termination
    assert (got.numpy()[:, dead] == 0).all()
    assert (want[:, dead] == 0).all()


def test_reduce_segments_bykey_plain_unit():
    """The data of the JAX package's direct kernel test: sorted keys, an id
    without pairs, sentinel lanes holding 1e9 that must never be read."""
    rng = np.random.default_rng(0)
    n, ru = 300, 4
    keys = np.sort(rng.integers(0, n, 2000)).astype(np.int32)
    keys = keys[keys != 7]
    keys = np.concatenate([keys, np.full(40, n, np.int32)])
    length = len(keys)
    vals = rng.normal(size=(2 * ru, length)).astype(np.float32)
    vals[:, keys == n] = 1e9
    rows = [jrz._pack_bf16_2(jnp.asarray(vals[2 * i]),
                             jnp.asarray(vals[2 * i + 1])) for i in range(ru)]
    slab_j = jnp.stack(rows + [jnp.asarray(keys)]
                       + [jnp.zeros((length,), jnp.int32)] * (8 - ru - 1))
    slab_j = jnp.pad(slab_j, ((0, 0), (0, 512)))
    blk = 256
    n_pad = -(-n // blk) * blk
    qs = np.minimum(np.arange(n_pad // blk + 1) * blk, n).astype(np.int32)
    coarse = jnp.asarray(np.searchsorted(keys, qs, side="left"), jnp.int32)
    want = np.asarray(rp.reduce_segments_bykey(slab_j, coarse, ru, n,
                                               blk=blk))[:, :n]
    # the port's slab needs neither the zero tail nor the padding rows
    slab_t = torch.as_tensor(np.asarray(slab_j)[:ru + 1, :length].copy())
    got = rc.reduce_segments_bykey(slab_t, ru, n).numpy()
    assert got.shape == (2 * ru + 2, n)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    v16 = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16).astype(
        jnp.float32))
    expect = np.zeros((2 * ru + 2, n), np.float32)
    for g in range(n):
        m = keys == g
        expect[:2 * ru, g] = v16[:, m].sum(axis=1)
        expect[2 * ru, g] = np.abs(v16[0, m]).sum()
        expect[2 * ru + 1, g] = np.abs(v16[1, m]).sum()
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)
    assert (got[:, 7] == 0.0).all()  # the id without pairs
    assert rc.LAUNCHES["reduce_segments_bykey"] == 0


def _grads_both(s, cfg_kw, seed, f, jax_backend="pallas", torch_kw=None):
    """Gradients of sum(img * w_img) + sum(alpha * w_a) from jax.grad of the
    JAX rasterizer and from the port's autograd function."""
    width, height = cfg_kw["width"], cfg_kw["height"]
    rng = np.random.default_rng(seed + 70)
    w_img = rng.normal(size=(height, width, f)).astype(np.float32)
    w_a = rng.normal(size=(height, width, 1)).astype(np.float32)
    jcfg = jrz.RasterizeConfig(backend=jax_backend, **cfg_kw)
    depths, valid = jnp.asarray(s["depths"]), jnp.asarray(s["valid"])
    radii = jnp.asarray(s["radii_xy"])

    def jloss(m, c, o, ft, sink):
        img, a = jrz.rasterize(m, c, depths, o, ft, valid, jcfg,
                               absgrad_sink=sink, radii=radii)
        return jnp.sum(img * w_img) + jnp.sum(a * w_a)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(s["means2d"]), jnp.asarray(s["conics"]),
        jnp.asarray(s["opac"]), jnp.asarray(s["feats"]),
        jnp.zeros_like(jnp.asarray(s["means2d"])))

    tcfg = trz.RasterizeConfig(**dict(jcfg._asdict(), **(torch_kw or {})))
    leaves = [torch.as_tensor(s[k]).clone().requires_grad_(True)
              for k in ("means2d", "conics", "opac", "feats")]
    sink = torch.zeros_like(leaves[0]).requires_grad_(True)
    img, a = trz.rasterize(leaves[0], leaves[1], torch.as_tensor(s["depths"]),
                           leaves[2], leaves[3], torch.as_tensor(s["valid"]),
                           tcfg, absgrad_sink=sink,
                           radii=torch.as_tensor(s["radii_xy"]))
    loss = (img * torch.as_tensor(w_img)).sum() + (a * torch.as_tensor(
        w_a)).sum()
    tg = torch.autograd.grad(loss, leaves + [sink])
    return [np.asarray(g) for g in jg], [g.numpy() for g in tg]


def _assert_grads_close(jg, tg, rtol, atol):
    for name, gj, gt in zip(GRAD_NAMES, jg, tg):
        scale = max(np.abs(gj).max(), 1e-6)
        np.testing.assert_allclose(gt / scale, gj / scale, rtol=rtol,
                                   atol=atol, err_msg=name)
    assert np.abs(jg[0]).max() > 1e-3 and np.abs(jg[4]).max() > 1e-3


@pytest.mark.parametrize("scheme", ["packed", "depthq"])
def test_rasterize_grads_match_jax_pallas(scheme):
    """Both sides pack per-pair gradients to bf16 and sum them per
    Gaussian; per array, scaled by its largest magnitude, they agree to
    rtol 2e-2 / atol 2e-3, the JAX package's sortpack tolerance against
    its exact path (tests/test_rasterize_pallas.py:57)."""
    s = make_scene(1, n=250, width=48, height=32, f=4)
    cfg_kw = dict(width=48, height=32, tile_size=16, chunk=16, tile_block=2,
                  pair_capacity=1 << 13, grad_reduce="sortpack",
                  sort_scheme=scheme)
    jg, tg = _grads_both(s, cfg_kw, seed=1, f=4)
    _assert_grads_close(jg, tg, rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("compact_frac", [0.625, 0.02, 1.0])
def test_depthq_composition_matches_jax_xla(compact_frac):
    """The three depthq legs of the JAX package's decision-path test
    (tests/test_rasterize_pallas.py:90-104): depthq keys, the streamed
    expand entry, the sortpack reduction with compaction on, with a budget
    the JAX side overflows, and off; 7 channels; against the JAX package's
    exact XLA backend, forward rtol 1e-5 / atol 1e-6, gradients at the
    sortpack tolerance."""
    s = make_scene(5, n=350, width=64, height=48, f=7)
    cfg_kw = dict(width=64, height=48, tile_size=16, chunk=32, tile_block=4,
                  pair_capacity=1 << 14, grad_reduce="sortpack",
                  sort_scheme="depthq", compact_frac=compact_frac)
    orig = rc.expand_segments
    calls = []

    def forced_stream(vals, starts, out_len, **kw):
        calls.append(vals.shape)
        return orig(vals, starts, out_len, resident_max=128, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rc, "expand_segments", forced_stream)
        jg, tg = _grads_both(s, cfg_kw, seed=5, f=7, jax_backend="xla")
        with torch.no_grad():
            t_img, t_a = trz.rasterize(
                *(torch.as_tensor(s[k]) for k in
                  ("means2d", "conics", "depths", "opac", "feats", "valid")),
                trz.RasterizeConfig(**dict(cfg_kw, backend="xla")),
                radii=torch.as_tensor(s["radii_xy"]))
    assert calls
    j_img, j_a = jrz.rasterize(
        *(jnp.asarray(s[k]) for k in
          ("means2d", "conics", "depths", "opac", "feats", "valid")),
        jrz.RasterizeConfig(backend="xla", **cfg_kw),
        radii=jnp.asarray(s["radii_xy"]))
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(t_a.numpy(), np.asarray(j_a), rtol=1e-5,
                               atol=1e-6)
    _assert_grads_close(jg, tg, rtol=2e-2, atol=2e-3)


def test_compaction_drops_no_contributing_pair():
    """Dropping the slots past each tile's deepest contributor is a pure
    re-summation: with and without it the reduction sees the same bf16
    per-pair values, so the sums differ only by float32 summation order
    (rtol 1e-4 / atol 1e-5 of each array's scale, as in the JAX package's
    test). An opaque near layer ends most pixels early, so most slots are
    dead and a dropped live one would show as a large error."""
    s = make_scene(9, n=400, width=64, height=48, f=4)
    s["opac"] = np.where(s["depths"] < np.median(s["depths"]), 0.98,
                         s["opac"]).astype(np.float32)
    cfg_kw = dict(width=64, height=48, tile_size=16, chunk=32, tile_block=4,
                  pair_capacity=1 << 14, grad_reduce="sortpack",
                  sort_scheme="depthq")
    kept = []
    orig = rc.reduce_segments_bykey

    def spy(slab, ru, n):
        kept.append(slab.shape[1])
        return orig(slab, ru, n)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rc, "reduce_segments_bykey", spy)
        _, g_on = _grads_both(s, cfg_kw, seed=9, f=4,
                              torch_kw={"compact_frac": 0.375})
        _, g_off = _grads_both(s, cfg_kw, seed=9, f=4,
                               torch_kw={"compact_frac": 1.0})
    assert kept[0] < 0.8 * kept[1]  # compaction really dropped slots
    for name, ga, gb in zip(GRAD_NAMES, g_off, g_on):
        scale = max(np.abs(ga).max(), 1e-6)
        np.testing.assert_allclose(gb / scale, ga / scale, rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("length", [4001, 4000, 3])
def test_reduce_bykey_pads_the_slab_rows(length):
    """`_reduce_bykey` hands the reduction a key-sorted slab whose row
    stride is the length rounded up to a multiple of 4 words (the kernel's
    16-byte loads); the sums are those of the plain reduction of the same
    lanes, the sentinel lanes excluded."""
    rng = np.random.default_rng(length)
    n, ru = 700, 3
    keys = torch.as_tensor(rng.integers(0, n + 1, length).astype(np.int32))
    vals = torch.as_tensor(rng.normal(size=(2 * ru, length)).astype(
        np.float32))
    slab = torch.stack([rc.pack_bf16_2(vals[2 * i], vals[2 * i + 1])
                        for i in range(ru)])
    cfg = trz.RasterizeConfig(width=32, height=32, compact_frac=1.0)
    binned = trz._Binned(pair_orig=keys, starts=None, counts=None,
                         gauss_starts=None, total_pairs=None)
    seen = []
    orig = rc.reduce_segments_bykey

    def spy(sorted_slab, ru_, n_):
        seen.append(sorted_slab)
        return orig(sorted_slab, ru_, n_)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rc, "reduce_segments_bykey", spy)
        got = trz._reduce_bykey(cfg, binned, slab, None, ru, n)
    (sorted_slab,) = seen
    assert sorted_slab.shape == (ru + 1, length)
    assert sorted_slab.stride() == (-(-length // 4) * 4, 1)
    assert bool((sorted_slab[ru][1:] >= sorted_slab[ru][:-1]).all())
    want = rc.reduce_segments_bykey_plain(
        torch.cat([slab, keys[None]]), ru, n)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _packed_slab(rows, n_feats):
    rows = list(rows) + [torch.zeros_like(rows[0])] * ((6 + n_feats) % 2)
    words = [rc.pack_bf16_2(rows[2 * i], rows[2 * i + 1])
             for i in range(len(rows) // 2)]
    return torch.stack(words + [torch.zeros_like(words[0])] * (8 - len(words)))


def test_compare_backward_accepts_rounding_and_refuses_errors():
    """chip_smoke.py's slab comparison: a slab whose values moved by one
    bf16 rounding step on a few elements passes; a wrong value, too many
    moved values, or a non-zero word where the plain slab has an integer
    zero are refused."""
    f = 7
    gen = torch.Generator().manual_seed(0)
    vals = torch.randn(6 + f, 4000, generator=gen)
    vals[:, 3000:] = 0.0  # slots no tile replays
    want = _packed_slab(vals, f)
    rep = chip_smoke.compare_backward(want.clone(), want, f)
    assert rep["max_abs_err"] == 0.0 and rep["beyond_one_ulp_frac"] == 0.0

    nudged = want.clone()
    nudged[0, :3] += 1  # low half up by one bf16 step on three elements
    rep = chip_smoke.compare_backward(nudged, want, f)
    assert rep["out_of_tolerance"] == 0 and rep["max_abs_err"] > 0.0

    wrong = want.clone()
    wrong[1, 5] = rc.pack_bf16_2(vals[2, 5:6] + 0.5, vals[3, 5:6])[0]
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.compare_backward(wrong, want, f)

    many = want.clone()
    many[:, :200] += 2  # two steps on 5% of the elements
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.compare_backward(many, want, f)

    dirty = want.clone()
    dirty[2, 3500] = 0x8000  # -0.0 in a slot that must be integer zero
    with pytest.raises(AssertionError, match="zero_words_broken"):
        chip_smoke.compare_backward(dirty, want, f)


def test_compare_reduce_and_backward_work():
    """chip_smoke.py's reduce comparison and the work count behind the
    backward's bound: a pixel replays last + 1 pairs, of which its
    composited ones cost the gradient arithmetic; a tile reads up to its
    deepest contributor."""
    want = torch.randn(16, 50)
    want[:, 7] = 0.0
    chip_smoke.compare_reduce(want + 1e-6 * want, want)
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.compare_reduce(want * 1.001, want)
    off = want.clone()
    off[3, 7] = 1e-9
    with pytest.raises(AssertionError, match="zero_sums_broken"):
        chip_smoke.compare_reduce(off, want)

    arrays, geom = _backward_inputs(0, 16, f=4, n=800)
    payload, starts, counts, _, _, _, last = (torch.as_tensor(a)
                                              for a in arrays)
    t = geom[0]
    work = chip_smoke.backward_work(payload, starts, counts, t, 16, geom[3],
                                    last, 4)
    lastn = arrays[6].reshape(t, 256)
    assert work["visits"] == int((lastn + 1).sum())
    assert 0 < work["accepted"] <= work["visits"]
    assert work["replayed"] == int((lastn.max(axis=1) + 1).sum())
    assert work["replayed"] <= int(arrays[1][t])
    assert work["ops"] > work["visits"] and work["bytes"] > 0
    # a group of 128 pixels sums a pair if any of its quarters does
    s32, s128 = work["warp_pair_steps_32"], work["warp_pair_steps_128"]
    assert 0 < s128 <= s32 <= min(4 * s128, work["accepted"])
    assert s128 <= 2 * work["replayed"]


def test_render_sinks_match_jax():
    """`render` with both sinks: the gradient of `xys_sink` is the
    screen-space mean gradient, that of `absgrad_sink` its per-pair
    absolute sum; against jax.grad of the JAX render (exact XLA backend) at
    the sortpack tolerance, with the parameter gradients alongside."""
    from dnsplatter_torch.models.gaussians import params_from_numpy
    from dnsplatter_torch.ops import render as tr
    from dnsplatter_torch.ops.camera import Camera as TCamera
    from dnsplatter_tpu.data.synthetic import make_gt_gaussians, ring_cameras
    from dnsplatter_tpu.ops import render as jr

    n, w, h = 200, 48, 32
    gt, alive = make_gt_gaussians(jax.random.PRNGKey(2), n, sh_degree=1)
    rest = np.random.default_rng(0).normal(0, 0.1, (n, 3, 3)).astype(
        np.float32)
    jcam = ring_cameras(1, width=w, img_height=h, focal=40.0)[0]
    tcam = TCamera.create(40.0, 40.0, w / 2, h / 2, np.asarray(jcam.c2w), w,
                          h, device="cpu")
    kw = dict(width=w, height=h, tile_size=16, chunk=16, tile_block=2,
              pair_capacity=1 << 13)
    rng = np.random.default_rng(1)
    w_rgb = rng.normal(size=(h, w, 3)).astype(np.float32)
    w_d = rng.normal(size=(h, w, 1)).astype(np.float32)
    w_n = rng.normal(size=(h, w, 3)).astype(np.float32)
    arrays = {f: np.asarray(getattr(gt, f)) for f in gt.__dataclass_fields__}
    arrays["features_rest"] = rest
    bg = np.array([0.2, 0.4, 0.6], np.float32)

    def jloss(means, quats, xys, absg):
        import dataclasses as dc
        p = dc.replace(gt, means=means, quats=quats,
                       features_rest=jnp.asarray(rest))
        out, _ = jr.render(p, alive, jcam, jrz.RasterizeConfig(**kw),
                           sh_degree_to_use=1, background=jnp.asarray(bg),
                           xys_sink=xys, absgrad_sink=absg)
        return (jnp.sum(out.rgb * w_rgb) + jnp.sum(out.depth * w_d)
                + jnp.sum(out.normal * w_n))

    zeros = jnp.zeros((n, 2))
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(gt.means, gt.quats, zeros,
                                                zeros)
    tp = params_from_numpy(arrays, device="cpu")
    leaves = [tp.means.clone().requires_grad_(True),
              tp.quats.clone().requires_grad_(True),
              torch.zeros(n, 2, requires_grad=True),
              torch.zeros(n, 2, requires_grad=True)]
    import dataclasses as dc
    out, info = tr.render(
        dc.replace(tp, means=leaves[0], quats=leaves[1]), torch.ones(n), tcam,
        trz.RasterizeConfig(**kw), sh_degree_to_use=1,
        background=torch.as_tensor(bg), xys_sink=leaves[2],
        absgrad_sink=leaves[3])
    loss = ((out.rgb * torch.as_tensor(w_rgb)).sum()
            + (out.depth * torch.as_tensor(w_d)).sum()
            + (out.normal * torch.as_tensor(w_n)).sum())
    tg = torch.autograd.grad(loss, leaves)
    for name, gj, gt_ in zip(["means", "quats", "xys_sink", "absgrad_sink"],
                             jg, tg):
        gj = np.asarray(gj)
        scale = max(np.abs(gj).max(), 1e-6)
        np.testing.assert_allclose(gt_.numpy() / scale, gj / scale, rtol=2e-2,
                                   atol=2e-3, err_msg=name)
    assert (tg[3] >= 0).all() and float(tg[3].sum()) > 0
    assert (tg[3] + 1e-6 >= tg[2].abs() * (1 - 2e-2)).all()
    assert not info.radii.requires_grad  # the radius stays out of the graph


def test_deepest_first_orders_tiles():
    """The backward kernel's tile schedule: a permutation of the tiles,
    deepest contributor first, ties and empty tiles (last = -1) in tile
    order."""
    last = torch.tensor([[[-1, -1]], [[3, 7]], [[2, -1]], [[7, 0]],
                         [[-1, -1]]], dtype=torch.int32)
    order = rc.deepest_first(last, 5)
    assert order.dtype == torch.int32
    assert order.tolist() == [1, 3, 2, 0, 4]


def test_ab_script_reads_ptxas_reports():
    """ab_tile_kernels.py's ptxas parsing and the residency it derives."""
    from dnsplatter_torch.scripts import ab_tile_kernels as ab

    log = ("ptxas info    : Compiling entry function '_ZN1a20forward_tiles_"
           "kernelILi7EEEvPKf' for 'sm_90a'\n"
           "ptxas info    : Used 52 registers, used 1 barriers, 28672 bytes "
           "smem, 400 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_ZN1a21backward_tiles_"
           "kernelILi7ELb1ELi2EEEvPKf' for 'sm_90a'\n"
           "ptxas info    : Used 61 registers, used 1 barriers, 21540 bytes "
           "smem, 400 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_ZN1a21backward_tiles_"
           "kernelILi7ELb1ELi4EEEvPKf' for 'sm_90a'\n"
           "ptxas info    : Used 95 registers, used 1 barriers, 12820 bytes "
           "smem, 400 bytes cmem[0]\n")
    figs = ab.parse_ptxas(log)
    assert figs["_ZN1a20forward_tiles_kernelILi7EEEvPKf"] == {
        "registers": 52, "smem": 28672}
    assert len(figs) == 3
    rep = ab._report("forward_tiles", log, 256,
                     ab.TAGS[("current", "forward_tiles")])
    # 52 registers round up to 56 a thread: 1,792 a warp, 36 warps a SM,
    # 4 CTAs of 8 warps (shared memory would allow 7, threads 8)
    assert rep["resident_ctas"] == 4
    # the four-pixel instance, not the two-pixel one beside it
    rep = ab._report("backward_tiles", log, 64,
                     ab.TAGS[("current", "backward_tiles")])
    assert rep["registers"] == 95 and rep["resident_ctas"] == 10
    assert ab.resident_ctas(32, 13312, 256) == 8
    assert ab.resident_ctas(72, 21028, 128) == 7


def test_ab_script_finds_every_kernel_instance():
    """The A/B script's ptxas lookup for the expansion (no template) and
    the reduction's RU = 7 instance: the id-block design's 512-id block
    among fourteen, or the one-thread-per-id design's one instance per
    RU."""
    from dnsplatter_torch.scripts import ab_tile_kernels as ab

    def entry(name, args, regs, smem):
        return (f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1"
                f"{len(name)}{name}{args}EvPKixiiPfxb' for 'sm_90a'\n"
                f"ptxas info    : Used {regs} registers, used 1 barriers, "
                f"{smem} bytes smem, 400 bytes cmem[0]\n")

    new = "".join(entry("reduce_bykey_kernel", f"ILi{ru}ELi{ids}EE",
                        40 + ru + ids // 256, (2 * ru + 2) * ids * 4 + 56)
                  for ru in range(1, 8) for ids in (256, 512))
    old = "".join(entry("reduce_bykey_kernel", f"ILi{ru}EE", 30 + ru, 0)
                  for ru in range(1, 8))
    expand = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122"
              "expand_segments_kernelEPKjPKiPjiiib' for 'sm_90a'\n"
              "ptxas info    : Used 32 registers, used 1 barriers, 8232 bytes "
              "smem, 400 bytes cmem[0]\n")
    red = "reduce_segments_bykey"
    for version, log, regs, smem in (("current", new, 49, 32824),
                                     ("baseline", new, 49, 32824),
                                     ("baseline", old, 37, 0)):
        rep = ab._report(red, log, ab.THREADS[red], ab.TAGS[(version, red)])
        assert (rep["registers"], rep["smem"]) == (regs, smem)
    # 56 registers a thread, 4 warps a CTA: registers allow 9 CTAs, shared
    # memory 6
    rep = ab._report(red, new, 128, ab.TAGS[("current", red)])
    assert rep["resident_ctas"] == 6
    rep = ab._report("expand_segments", expand, 256,
                     ab.TAGS[("current", "expand_segments")])
    assert rep == {"registers": 32, "smem": 8232, "threads": 256,
                   "resident_ctas": 8}
    with pytest.raises(RuntimeError, match="expand_segments"):
        ab._report("expand_segments", new, 256, ("E",))
    assert set(ab.KERNELS) == set(ab.ENTRY_NAMES) == set(ab.THREADS)


@pytest.mark.parametrize("n,slots,ids", [
    (1_253_376, 528, 512),  # the 1M training state: 2,448 CTAs of 512
    (126_976, 528, 256),  # the 100k state: 248 CTAs of 512 leave SMs idle
    (269_825, 528, 512),  # 528 CTAs of 512, the last one short
    (269_824, 528, 256),  # 527 CTAs of 512
    (5, 528, 256),
    (10_000_000, 1, 512)])
def test_bykey_ids_per_cta(n, slots, ids):
    """The reduction's block of ids: 512 while 512-id CTAs fill every slot
    of the card, else 256."""
    assert rc.bykey_ids_per_cta(n, slots) == ids


def test_ab_script_tells_c_entries_apart():
    """The A/B script reads a baseline C entry's parameter list, so a
    one-thread-per-id `reduce_segments_bykey` source (no ids per CTA) is
    called with its own argument list."""
    from pathlib import Path

    from dnsplatter_torch.scripts import ab_tile_kernels as ab

    old = ('extern "C" int dns_reduce_segments_bykey(const void* slab, long '
           'long stride,\n    int len, int ru, int n, void* out,\n    long '
           'long out_stride, void* stream) {')
    assert len(ab.c_entry_params(old, "dns_reduce_segments_bykey")) == len(
        ab.BASELINE_ARGTYPES["reduce_segments_bykey"]) == 8
    csrc = Path(rc.kernel_build.CSRC_DIR)
    for name, (lib, sym, argtypes) in rc._ENTRIES.items():
        if name in ab.KERNELS:
            src = (csrc / f"{lib}.cu").read_text()
            assert len(ab.c_entry_params(src, sym)) == len(argtypes), name
