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


def _bin_both(cfg, m2d, depths, radii, valid):
    jb = jrz.bin_gaussians(cfg, jnp.asarray(m2d), jnp.asarray(depths),
                           jnp.asarray(radii), jnp.asarray(valid))
    tcfg = trz.RasterizeConfig(**cfg._asdict())
    tb = trz.bin_gaussians(tcfg, torch.as_tensor(m2d),
                           torch.as_tensor(depths), torch.as_tensor(radii),
                           torch.as_tensor(valid))
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


def test_unported_schemes_raise():
    m2d, depths, radii, valid = _scene(n=50)
    args = (torch.as_tensor(m2d), torch.as_tensor(depths),
            torch.as_tensor(radii), torch.as_tensor(valid))
    for kw in ({"sort_scheme": "depthq"}, {"sort_scheme": "tilekey"},
               {"exact_cull": True}):
        cfg = trz.RasterizeConfig(width=128, height=96, **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            trz.bin_gaussians(cfg, *args)
