"""dnsplatter_torch binning against the JAX package: expand_segments and
bin_gaussians, bit for bit (integer layouts admit no tolerance).

The JAX kernels run through the Pallas interpreter on the CPU, as the JAX
package's own tests run them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnsplatter_torch.ops import rasterize as trz
from dnsplatter_torch.ops import rasterize_cuda as rc
from dnsplatter_tpu.ops import rasterize as jrz
from dnsplatter_tpu.ops import rasterize_pallas as rp

from test_torch_rasterize import make_scene


def _segments(seed, n=300, out_extra=37, empty_frac=0.3):
    """Ascending starts with empty segments, a nonzero first start and an
    output longer than starts[N]."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 9, n)
    lens[rng.uniform(size=n) < empty_frac] = 0
    starts = np.concatenate([[3], 3 + np.cumsum(lens)]).astype(np.int32)
    out_len = int(starts[-1]) + out_extra
    ints = rng.integers(-(1 << 23), 1 << 23, (4, n)).astype(np.int32)
    floats = rng.normal(0.0, 1e3, (3, n)).astype(np.float32)
    return starts, out_len, ints, floats


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("entry", ["resident", "stream"])
def test_expand_segments_plain_bit_equal(seed, entry):
    starts, out_len, ints, floats = _segments(seed)
    jax_fn = (rp.expand_segments if entry == "resident"
              else rp._expand_segments_stream)
    # the port's public entries route CPU tensors to the plain version;
    # resident_max=1 sends the resident entry on to the stream entry
    if entry == "resident":
        def port_fn(v, s, n, out_dtype):
            return rc.expand_segments(v, s, n, out_dtype=out_dtype)
    else:
        def port_fn(v, s, n, out_dtype):
            return rc.expand_segments(v, s, n, out_dtype=out_dtype,
                                      resident_max=1)
    for vals, jdt, tdt in ((ints, jnp.int32, torch.int32),
                           (floats, jnp.float32, torch.float32)):
        want = np.asarray(jax_fn(jnp.asarray(vals), jnp.asarray(starts),
                                 out_len, out_dtype=jdt))
        got = port_fn(torch.as_tensor(vals), torch.as_tensor(starts),
                      out_len, tdt).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        # and the definition itself: zeros before starts[0] / past starts[N]
        assert (got[:, :starts[0]] == 0).all()
        assert (got[:, starts[-1]:] == 0).all()
    assert rc.LAUNCHES["expand_segments"] == 0
    assert rc.LAUNCHES["expand_segments_stream"] == 0


def _scene(n=300, w=128, h=96, seed=0, aniso=False):
    rng = np.random.default_rng(seed)
    m2d = rng.uniform(-10, [w + 10, h + 10], (n, 2)).astype(np.float32)
    depths = rng.uniform(0.5, 5.0, n).astype(np.float32)
    if aniso:
        radii = rng.uniform(1, 25, (n, 2)).astype(np.float32)
    else:
        radii = rng.uniform(1, 25, n).astype(np.float32)
    radii = np.stack([radii, radii], -1) if radii.ndim == 1 else radii
    valid = (rng.uniform(size=n) > 0.1).astype(np.float32)
    return m2d, depths, radii, valid


def _bin_both(cfg, m2d, depths, radii, valid, conics=None, opac=None):
    jopt = {} if conics is None else dict(conics=jnp.asarray(conics),
                                          opacities=jnp.asarray(opac))
    topt = {} if conics is None else dict(conics=torch.as_tensor(conics),
                                          opacities=torch.as_tensor(opac))
    jb = jrz.bin_gaussians(cfg, jnp.asarray(m2d), jnp.asarray(depths),
                           jnp.asarray(radii), jnp.asarray(valid), **jopt)
    tcfg = trz.RasterizeConfig(**cfg._asdict())
    tb = trz.bin_gaussians(tcfg, torch.as_tensor(m2d),
                           torch.as_tensor(depths), torch.as_tensor(radii),
                           torch.as_tensor(valid), **topt)
    return jb, tb


def _assert_layout_equal(jb, tb):
    for name in ("starts", "counts", "gauss_starts", "order"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert int(tb.total_pairs) == int(jb.total_pairs)
    end = int(np.asarray(jb.starts)[-1])
    for name in ("pair_gauss", "pair_orig"):
        j = np.asarray(getattr(jb, name))
        t = getattr(tb, name).numpy()
        assert t.shape == j.shape, name
        np.testing.assert_array_equal(t[:end], j[:end], err_msg=name)


@pytest.mark.parametrize("scheme,aniso,seed", [
    ("packed", False, 0),
    ("packed32", True, 1),
    ("auto", True, 2),
])
def test_bin_gaussians_bit_equal(scheme, aniso, seed):
    m2d, depths, radii, valid = _scene(seed=seed, aniso=aniso)
    cfg = jrz.RasterizeConfig(width=128, height=96, tile_size=16, chunk=16,
                              tile_block=4, pair_capacity=1 << 13,
                              backend="pallas", sort_scheme=scheme)
    jb, tb = _bin_both(cfg, m2d, depths, radii, valid)
    _assert_layout_equal(jb, tb)
    # past starts[-1] every slot is dead
    end = int(tb.starts[-1])
    assert (tb.pair_gauss[end:] == len(m2d)).all()


def test_bin_gaussians_overflow_drops_whole_deepest_gaussians():
    m2d, depths, radii, valid = _scene(n=400, seed=3)
    cap = 256
    cfg = jrz.RasterizeConfig(width=128, height=96, tile_size=16, chunk=16,
                              tile_block=4, pair_capacity=cap,
                              backend="pallas")
    jb, tb = _bin_both(cfg, m2d, depths, radii, valid)
    _assert_layout_equal(jb, tb)
    assert int(tb.total_pairs) > cap
    # kept = the shallowest prefix of Gaussians whose ranges fit
    counts = np.diff(tb.gauss_starts.numpy())
    order = tb.order.numpy()
    kept = set(np.nonzero(counts)[0])
    raw = []
    for gi in order:
        if valid[gi] <= 0.5:
            raw.append(0)
            continue
        x0 = np.clip(np.floor((m2d[gi, 0] - radii[gi, 0]) / 16), 0, 8)
        x1 = np.clip(np.floor((m2d[gi, 0] + radii[gi, 0]) / 16) + 1, 0, 8)
        y0 = np.clip(np.floor((m2d[gi, 1] - radii[gi, 1]) / 16), 0, 6)
        y1 = np.clip(np.floor((m2d[gi, 1] + radii[gi, 1]) / 16) + 1, 0, 6)
        raw.append(int(max(x1 - x0, 0) * max(y1 - y0, 0)))
    acc, want = 0, set()
    for rank, cnt in enumerate(raw):
        if acc + cnt > cap:
            break
        acc += cnt
        if cnt:
            want.add(rank)
    assert kept == want
    assert int(tb.starts[-1]) == acc


def test_unported_schemes_raise(monkeypatch):
    """The schemes that used to be refused give a valid layout (every tile
    lists its Gaussians front to back, and the same ones as `packed`), and
    what must still refuse does: an unknown scheme, and depthq from
    F32_EXACT_LIMIT Gaussians on (lowered here)."""
    s = make_scene(4, n=120)
    args = tuple(torch.as_tensor(s[k]) for k in
                 ("means2d", "depths", "radii_xy"))
    args += (torch.as_tensor(s["valid"].astype(np.float32)),
             torch.as_tensor(s["conics"]), torch.as_tensor(s["opac"]))
    base = dict(width=64, height=48, chunk=16, tile_block=4,
                pair_capacity=1 << 12)
    ref = trz.bin_gaussians(
        trz.RasterizeConfig(sort_scheme="packed", **base), *args)
    for kw in ({"sort_scheme": "tilekey"}, {"exact_cull": True},
               {"sort_scheme": "depthq", "exact_cull": True}):
        b = trz.bin_gaussians(trz.RasterizeConfig(**dict(base, **kw)), *args)
        np.testing.assert_array_equal(b.starts.numpy(), ref.starts.numpy())
        assert (b.counts <= ref.counts).all() and int(b.counts.sum()) > 0
        starts, counts = b.starts.numpy(), b.counts.numpy()
        ids = b.pair_orig.numpy()
        rids = ref.pair_orig.numpy()
        for t in range(len(counts)):
            mine = ids[starts[t]:starts[t] + counts[t]]
            assert (np.diff(s["depths"][mine]) >= 0).all()
            assert set(mine) <= set(rids[starts[t]:starts[t + 1]])
            if not kw.get("exact_cull"):
                np.testing.assert_array_equal(
                    mine, rids[starts[t]:starts[t + 1]])
    with pytest.raises(ValueError, match="unknown sort_scheme"):
        trz.bin_gaussians(trz.RasterizeConfig(sort_scheme="radix", **base),
                          *args)
    monkeypatch.setattr(trz, "F32_EXACT_LIMIT", 100)
    with pytest.raises(ValueError, match="depthq takes fewer than 100"):
        trz.bin_gaussians(trz.RasterizeConfig(sort_scheme="depthq", **base),
                          *args)


def _park_deepest_off_screen(m2d, depths, radii, k=0, depth=50.0):
    """Gaussian `k` becomes the deepest valid one and covers no tile. Above
    24 depth bits the JAX package files a Gaussian at exactly the largest
    depth into the next tile (float32 rounds its clamp up to 2^qbits;
    ROADMAP.md section C); the port does not, so layouts are compared with
    that depth held by a Gaussian without pairs."""
    m2d, depths, radii = m2d.copy(), depths.copy(), radii.copy()
    m2d[k] = (-1000.0, -1000.0)
    radii[k] = 1.0
    depths[k] = depth
    return m2d, depths, radii


def _depthq_cfg(**kw):
    return jrz.RasterizeConfig(width=128, height=96, tile_size=16, chunk=16,
                               tile_block=4, pair_capacity=1 << 13,
                               backend="pallas", sort_scheme="depthq", **kw)


@pytest.mark.parametrize("aniso,seed", [(False, 4), (True, 5)])
def test_bin_gaussians_depthq_bit_equal_without_ties(aniso, seed):
    """depthq: no depth pre-sort, key tile * 2^qb + quantized depth, the id
    riding as payload. On depths far apart (no two share a quantized
    value) the layout admits no tolerance."""
    m2d, _, radii, valid = _scene(seed=seed, aniso=aniso)
    n = len(m2d)
    depths = np.random.default_rng(seed).permutation(
        np.linspace(2.0, 8.0, n)).astype(np.float32)
    m2d, depths, radii = _park_deepest_off_screen(m2d, depths, radii)
    jb, tb = _bin_both(_depthq_cfg(), m2d, depths, radii, valid)
    _assert_layout_equal(jb, tb)
    np.testing.assert_array_equal(tb.order.numpy(), np.arange(n))
    assert tb.pair_orig is tb.pair_gauss
    # within every tile the pairs run front to back
    starts, counts = tb.starts.numpy(), tb.counts.numpy()
    pg = tb.pair_gauss.numpy()
    for t in range(len(counts)):
        d = depths[pg[starts[t]:starts[t] + counts[t]]]
        assert (np.diff(d) >= 0).all()


def test_bin_gaussians_depthq_overflow_drops_in_array_order():
    m2d, depths, radii, valid = _scene(n=400, seed=3)
    depths = np.random.default_rng(3).permutation(
        np.linspace(2.0, 8.0, 400)).astype(np.float32)
    m2d, depths, radii = _park_deepest_off_screen(m2d, depths, radii)
    jb, tb = _bin_both(_depthq_cfg()._replace(pair_capacity=256), m2d,
                       depths, radii, valid)
    _assert_layout_equal(jb, tb)
    assert int(tb.total_pairs) > 256
    counts = np.diff(tb.gauss_starts.numpy())
    kept = np.nonzero(counts)[0]
    # a prefix in array order: nothing is kept after the first drop
    first_drop = int(np.argmax(np.cumsum(counts) >= counts.sum()))
    assert kept.max() <= first_drop


def test_bin_gaussians_depthq_ties_render_equal():
    """With equal quantized depths inside a tile the JAX sort may order the
    pairs either way (it is not stable, and its order changes from run to
    run), and compositing is not commutative, so neither the layout nor
    the image can be compared element by element. What must hold: the CSR
    is equal, every tile lists the same Gaussians with the same depth
    sequence (the layouts agree up to the order inside a run of equal
    depths), the port's order inside a run is ascending id (its sort is
    stable), and alpha, which does not depend on the order of the pairs a
    pixel composites, agrees to atol 1e-5 on every pixel neither side
    ended early."""
    s = make_scene(6, n=300, width=64, height=48, f=4)
    s["depths"] = np.round(s["depths"] * 2.0) / 2.0  # many exact ties
    s["valid"][0] = True
    s["means2d"], s["depths"], s["radii_xy"] = _park_deepest_off_screen(
        s["means2d"], s["depths"], s["radii_xy"])
    cfg = jrz.RasterizeConfig(width=64, height=48, tile_size=16, chunk=32,
                              tile_block=4, pair_capacity=1 << 14,
                              backend="pallas", sort_scheme="depthq")
    jb, tb = _bin_both(cfg, s["means2d"], s["depths"], s["radii_xy"],
                       s["valid"].astype(np.float32))
    for name in ("starts", "counts", "gauss_starts"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    starts, counts = tb.starts.numpy(), tb.counts.numpy()
    pg_t, pg_j = tb.pair_gauss.numpy(), np.asarray(jb.pair_gauss)
    tied_runs = 0
    for t in range(len(counts)):
        it = pg_t[starts[t]:starts[t] + counts[t]]
        ij = pg_j[starts[t]:starts[t] + counts[t]]
        dt, dj = s["depths"][it], s["depths"][ij]
        np.testing.assert_array_equal(dt, dj)
        assert (np.diff(dt) >= 0).all()
        np.testing.assert_array_equal(np.sort(it), np.sort(ij))
        same = np.diff(dt) == 0
        assert (np.diff(it)[same] > 0).all()  # ascending id inside a run
        tied_runs += int(same.sum())
    assert tied_runs > 50

    j_img, j_a = jrz.rasterize(
        jnp.asarray(s["means2d"]), jnp.asarray(s["conics"]),
        jnp.asarray(s["depths"]), jnp.asarray(s["opac"]),
        jnp.asarray(s["feats"]), jnp.asarray(s["valid"]), cfg,
        radii=jnp.asarray(s["radii_xy"]))
    t_img, t_a = trz.rasterize(
        torch.as_tensor(s["means2d"]), torch.as_tensor(s["conics"]),
        torch.as_tensor(s["depths"]), torch.as_tensor(s["opac"]),
        torch.as_tensor(s["feats"]), torch.as_tensor(s["valid"]),
        trz.RasterizeConfig(**cfg._asdict()),
        radii=torch.as_tensor(s["radii_xy"]))
    assert float(t_a.mean()) > 0.05
    t_a, j_a = t_a.numpy(), np.asarray(j_a)
    open_px = (t_a < 0.99) & (j_a < 0.99)
    assert open_px.mean() > 0.3
    np.testing.assert_allclose(t_a[open_px], j_a[open_px], atol=1e-5)
    # the image moves with the order inside a run, but not far
    assert np.abs(t_img.numpy() - np.asarray(j_img)).max() < 0.05


def test_depthq_deepest_gaussian_stays_in_its_tile():
    """Above 24 depth bits float32 rounds the quantizer's upper clamp
    qmax - 1 up to 2^qbits; left there, the deepest Gaussian's key in tile
    t equals the shallowest Gaussian's key in tile t + 1 (as in the JAX
    package), and whenever that one has the lower id the two swap tiles.
    The port clamps once more as an integer: every tile lists exactly the
    Gaussians whose rectangle covers it, front to back."""
    m2d, _, radii, valid = _scene(seed=8)
    n = len(m2d)
    depths = np.random.default_rng(8).permutation(
        np.linspace(2.0, 8.0, n)).astype(np.float32)
    cfg = _depthq_cfg()
    assert 32 - int(cfg.n_tiles_padded + 1).bit_length() > 24
    # the shallowest (low id) and the deepest (high id) cover every tile
    shallowest, deepest = 1, n - 2
    for k, d in ((shallowest, 1.0), (deepest, 9.0)):
        m2d[k], radii[k], valid[k], depths[k] = (64.0, 48.0), 200.0, 1.0, d
    _, tb = _bin_both(cfg, m2d, depths, radii, valid)
    starts, counts = tb.starts.numpy(), tb.counts.numpy()
    pg = tb.pair_gauss.numpy()
    ts = cfg.tile_size
    x0 = np.clip(np.floor((m2d[:, 0] - radii[:, 0]) / ts), 0, cfg.tiles_x)
    x1 = np.clip(np.floor((m2d[:, 0] + radii[:, 0]) / ts) + 1, 0, cfg.tiles_x)
    y0 = np.clip(np.floor((m2d[:, 1] - radii[:, 1]) / ts), 0, cfg.tiles_y)
    y1 = np.clip(np.floor((m2d[:, 1] + radii[:, 1]) / ts) + 1, 0, cfg.tiles_y)
    for t in range(cfg.n_tiles):
        ids = pg[starts[t]:starts[t] + counts[t]]
        tx, ty = t % cfg.tiles_x, t // cfg.tiles_x
        covers = ((valid > 0.5) & (x0 <= tx) & (tx < x1) & (y0 <= ty)
                  & (ty < y1))
        np.testing.assert_array_equal(np.sort(ids), np.nonzero(covers)[0])
        assert (np.diff(depths[ids]) >= 0).all()
        assert ids[0] == shallowest and ids[-1] == deepest


def _cull_scene(seed, scheme):
    """A projected scene (conics and opacities for the ellipse test) with
    stretched, faint Gaussians, so that a good share of the pairs is
    culled; under depthq the depths are far apart and the deepest Gaussian
    covers no tile."""
    s = make_scene(seed, n=300, width=96, height=64, f=4)
    rng = np.random.default_rng(seed)
    s["opac"] = rng.uniform(0.02, 0.9, 300).astype(np.float32)
    if scheme == "depthq":
        s["depths"] = rng.permutation(np.linspace(2.0, 8.0, 300)).astype(
            np.float32)
        s["valid"][0] = True
        s["means2d"], s["depths"], s["radii_xy"] = _park_deepest_off_screen(
            s["means2d"], s["depths"], s["radii_xy"])
    return s


def _bin_scene(cfg, s):
    return _bin_both(cfg, s["means2d"], s["depths"], s["radii_xy"],
                     s["valid"].astype(np.float32), s["conics"], s["opac"])


def _small_cfg(**kw):
    base = dict(width=96, height=64, tile_size=16, chunk=16, tile_block=4,
                pair_capacity=1 << 13, backend="pallas")
    return jrz.RasterizeConfig(**dict(base, **kw))


def test_bin_gaussians_tilekey_bit_equal():
    """tilekey against the JAX package, and against the port's own packed
    layout: a stable sort on the tile alone reproduces it exactly."""
    s = _cull_scene(10, "tilekey")
    jb, tb = _bin_scene(_small_cfg(sort_scheme="tilekey"), s)
    _assert_layout_equal(jb, tb)
    _, pb = _bin_scene(_small_cfg(sort_scheme="packed"), s)
    for name in ("pair_gauss", "pair_orig", "starts", "counts"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      getattr(pb, name).numpy(), name)
    end = int(tb.starts[-1])
    assert (tb.pair_gauss[end:] == 300).all()


@pytest.mark.parametrize("scheme", ["packed", "packed32", "tilekey",
                                    "depthq"])
def test_bin_gaussians_exact_cull_bit_equal(scheme):
    """Culling moves pairs to their tile's tail and shrinks the count; the
    whole layout, culled slots included, equals the JAX package's."""
    s = _cull_scene(11, scheme)
    cfg = _small_cfg(sort_scheme=scheme, exact_cull=True)
    jb, tb = _bin_scene(cfg, s)
    _assert_layout_equal(jb, tb)
    _, plain = _bin_scene(cfg._replace(exact_cull=False), s)
    np.testing.assert_array_equal(tb.starts.numpy(), plain.starts.numpy())
    culled = int(plain.counts.sum()) - int(tb.counts.sum())
    assert culled > 0.05 * int(plain.counts.sum())
    # a culled slot: the sentinel index under the exact schemes, the real
    # id under depthq; the original id is real under every scheme
    starts, counts = tb.starts.numpy(), tb.counts.numpy()
    t = int(np.argmax(np.diff(starts) - counts))
    slot = starts[t] + counts[t]
    assert slot < starts[t + 1]
    assert int(tb.pair_orig[slot]) < 300
    assert (int(tb.pair_gauss[slot]) == 300) == (scheme != "depthq")
    # without conics and opacities the request is a no-op
    _, no_geo = _bin_both(cfg, s["means2d"], s["depths"], s["radii_xy"],
                          s["valid"].astype(np.float32))
    np.testing.assert_array_equal(no_geo.counts.numpy(),
                                  plain.counts.numpy())


@pytest.mark.parametrize("scheme,cap", [
    ("packed", 1 << 13), ("packed", 256), ("depthq", 1 << 13),
    ("depthq", 256), ("tilekey", 320),
])
def test_bin_gaussians_orig_starts_bit_equal(scheme, cap):
    """Per-original-id ranges of the id-sorted pair list, with the capacity
    holding every pair and with whole Gaussians dropped for it (where the
    drop follows the depth-sorted prefix, not the array order)."""
    s = _cull_scene(12, scheme)
    cfg = _small_cfg(sort_scheme=scheme, pair_capacity=cap,
                     compact_frac=0.0)
    jb, tb = _bin_scene(cfg, s)
    _assert_layout_equal(jb, tb)
    assert (int(tb.total_pairs) > cap) == (cap < 1 << 13)
    np.testing.assert_array_equal(tb.orig_starts.numpy(),
                                  np.asarray(jb.orig_starts))
    # the definition: id g owns that many slots of the list
    end = int(tb.starts[-1])
    hist = np.bincount(tb.pair_orig.numpy()[:end], minlength=300)[:300]
    np.testing.assert_array_equal(np.diff(tb.orig_starts.numpy()), hist)
    # the default path carries none of it
    _, default = _bin_scene(cfg._replace(compact_frac=0.375), s)
    assert default.orig_starts is None and default.piece_starts is None


@pytest.mark.parametrize("kp,scheme,cull", [
    (2, "packed", False), (4, "packed32", True), (4, "depthq", False),
])
def test_bin_gaussians_piece_structure_bit_equal(kp, scheme, cull):
    s = _cull_scene(13, scheme)
    cfg = _small_cfg(sort_scheme=scheme, reduce_pieces=kp, exact_cull=cull,
                     pair_capacity=1024, compact_frac=0.0)
    jb, tb = _bin_scene(cfg, s)
    _assert_layout_equal(jb, tb)
    np.testing.assert_array_equal(tb.piece_bounds.numpy(),
                                  np.asarray(jb.piece_bounds))
    np.testing.assert_array_equal(tb.piece_starts.numpy(),
                                  np.asarray(jb.piece_starts))
    assert tb.piece_starts.dtype == torch.int32
    assert tuple(tb.piece_starts.shape) == (kp, 301)
    # the definition: piece j holds, of id g, its slots inside the piece
    pb = tb.piece_bounds.numpy()
    assert pb[0] == 0 and pb[-1] == int(tb.starts[-1])
    assert (np.diff(pb) > 0).sum() >= 2  # the pairs really are split
    ids = tb.pair_orig.numpy()
    for j in range(kp):
        hist = np.bincount(ids[pb[j]:pb[j + 1]], minlength=300)[:300]
        np.testing.assert_array_equal(
            np.diff(tb.piece_starts.numpy()[j]), hist)
    assert trz.RasterizeConfig(**cfg._asdict()).piece_capacity \
        == cfg.piece_capacity


@pytest.mark.parametrize("scheme", ["tilekey", "packed"])
def test_bin_gaussians_prefix_sum_branch_bit_equal(scheme, monkeypatch):
    """From F32_EXACT_LIMIT Gaussians on (lowered here) the per-pair rows
    come from the scattered differences and `cumsum_lanes_i32`, not from
    `expand_segments`; the layout is the same, Gaussians without pairs in
    the middle and at the end included, and a culling request is a no-op
    there."""
    s = _cull_scene(14, scheme)
    s["valid"][-20:] = False  # no pairs past the last slot in use
    calls = []
    orig = rc.cumsum_lanes_i32
    monkeypatch.setattr(rc, "cumsum_lanes_i32",
                        lambda x: (calls.append(tuple(x.shape)), orig(x))[1])
    monkeypatch.setattr(rc, "expand_segments", None)  # must not be called
    monkeypatch.setattr(trz, "F32_EXACT_LIMIT", 100)
    for cull in (False, True):
        cfg = _small_cfg(sort_scheme=scheme, exact_cull=cull)
        jb, tb = _bin_scene(cfg._replace(exact_cull=False), s)
        tcfg = trz.RasterizeConfig(**cfg._asdict())
        tb = trz.bin_gaussians(
            tcfg, *(torch.as_tensor(s[k]) for k in
                    ("means2d", "depths", "radii_xy")),
            torch.as_tensor(s["valid"].astype(np.float32)),
            torch.as_tensor(s["conics"]), torch.as_tensor(s["opac"]))
        _assert_layout_equal(jb, tb)
    assert calls == [(4, 1 << 13)] * 4
    # capacity overflow: first slots at or past the capacity are dropped
    cfg = _small_cfg(sort_scheme=scheme, pair_capacity=256)
    jb, tb = _bin_scene(cfg, s)
    _assert_layout_equal(jb, tb)
    assert int(tb.total_pairs) > 256
