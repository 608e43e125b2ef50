"""dnsplatter_torch compositing against the JAX package and the port's own
dense oracle.

`forward_tiles`' plain version gets the very payload and CSR the JAX
binning builds, and is held to `rp.forward_tiles` (Pallas interpreter) at
rtol 1e-5 / atol 1e-6 with `last` exact: both run the same chunked
log-domain transmittance arithmetic; only summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from dnsplatter_torch.ops import rasterize as trz
from dnsplatter_torch.ops import rasterize_cuda as rc
from dnsplatter_torch.ops.rasterize_ref import rasterize_pixels_ref
from dnsplatter_tpu.ops import rasterize as jrz
from dnsplatter_tpu.ops import rasterize_pallas as rp
from dnsplatter_tpu.ops.projection import project_gaussians

RTOL, ATOL = 1e-5, 1e-6


def make_scene(seed, n=300, width=64, height=48, f=4, behind=0):
    """Projected numpy inputs; the last `behind` Gaussians sit behind the
    camera."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    means[:, 2] += 4.0
    if behind:
        means[-behind:, 2] = -rng.uniform(0.5, 3.0, behind)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-3.5, -1.2, (n, 3))).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, n).astype(np.float32)
    feats = rng.uniform(size=(n, f)).astype(np.float32)
    proj = project_gaussians(jnp.asarray(means), jnp.asarray(q),
                             jnp.asarray(scales), jnp.eye(4), 60.0, 60.0,
                             width / 2, height / 2, width, height)
    out = {k: np.array(getattr(proj, k))
           for k in ("means2d", "conics", "depths", "radii_xy", "valid")}
    out.update(opac=opac, feats=feats)
    return out


def _jax_payload(cfg, s):
    """The JAX pallas path's binning + payload (rasterize.py:1015-1085)."""
    n, f = s["feats"].shape
    valid = s["valid"].astype(np.float32)
    fields = np.concatenate(
        [s["means2d"], s["conics"], (s["opac"] * valid)[:, None], s["feats"],
         np.zeros((n, 13 - 6 - f), np.float32), s["radii_xy"],
         valid[:, None]], -1)
    order = jnp.argsort(jnp.where(valid > 0.5, s["depths"], jnp.inf))
    fields_s = jnp.asarray(fields)[order]
    binned = jrz.bin_gaussians(cfg, jnp.asarray(s["means2d"]),
                               jnp.asarray(s["depths"]),
                               jnp.asarray(s["radii_xy"]), jnp.asarray(valid),
                               order=order, fields_sorted=fields_s)
    pw = 6 + f
    table = np.concatenate([np.asarray(fields_s)[:, :pw],
                            np.zeros((1, pw), np.float32)])
    rows = table[np.asarray(binned.pair_gauss)]
    payload = np.zeros((-(-pw // 8) * 8, rows.shape[0]), np.float32)
    payload[:pw] = rows.T
    return payload, np.array(binned.starts), np.array(binned.counts)


@pytest.mark.parametrize("seed,chunk", [(0, 16), (1, 32)])
def test_forward_tiles_plain_matches_pallas(seed, chunk):
    s = make_scene(seed, n=400, width=64, height=48)
    cfg = jrz.RasterizeConfig(width=64, height=48, tile_size=16, chunk=chunk,
                              tile_block=4, pair_capacity=1 << 13,
                              backend="pallas")
    payload, starts, counts = _jax_payload(cfg, s)
    args = (cfg.n_tiles_padded, 4, 16, cfg.tiles_x, chunk)
    want = rp.forward_tiles(jnp.asarray(payload), jnp.asarray(starts),
                            jnp.asarray(counts), *args)
    got = rc.forward_tiles(torch.as_tensor(payload), torch.as_tensor(starts),
                           torch.as_tensor(counts), *args)
    assert got[2].dtype == torch.int32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # the scene must exercise both terminated and open pixels
    t_final = got[1].numpy()
    assert (t_final < 1e-3).any() and (t_final > 0.1).any()
    assert rc.LAUNCHES["forward_tiles"] == 0


def test_forward_work_counts():
    """chip_smoke.py's count of forward_tiles' least work (its bound): a
    pixel evaluates at least its composited pairs and at most its tile's
    list, and only a pixel that ended (T <= 1e-4 / (1 - 0.999) = 0.1)
    stops early."""
    s = make_scene(0, n=800, width=64, height=48)
    cfg = jrz.RasterizeConfig(width=64, height=48, tile_size=16, chunk=16,
                              tile_block=4, pair_capacity=1 << 14,
                              backend="pallas")
    payload, starts, counts = (torch.as_tensor(a)
                               for a in _jax_payload(cfg, s))
    n_tiles = cfg.n_tiles_padded
    _, t_final, last = rc.forward_tiles(payload, starts, counts, n_tiles, 4,
                                        16, cfg.tiles_x, 16)
    visits, accepted = (t.numpy() for t in chip_smoke.forward_work(
        payload, starts, counts, n_tiles, 16, cfg.tiles_x, last))
    last = last.numpy()[:, 0, :]
    t_final = t_final.numpy()[:, 0, :]
    cnt = np.broadcast_to(counts.numpy()[:n_tiles, None], visits.shape)
    assert (accepted <= last + 1).all()
    assert ((accepted > 0) == (last >= 0)).all()
    assert (visits >= last + 1).all() and (visits >= accepted).all()
    assert (visits <= cnt).all()
    early = visits < cnt
    assert early.any() and (t_final[early] <= 0.1).all()
    assert (visits[t_final > 0.1] == cnt[t_final > 0.1]).all()


def test_forward_check_catches_a_wrong_tile():
    """chip_smoke.py's kernel-vs-plain check on the card, run here on two
    plain results: it passes identical outputs and fails a tile whose
    compositing went wrong."""
    s = make_scene(5, n=400, width=64, height=48)
    cfg = jrz.RasterizeConfig(width=64, height=48, tile_size=16, chunk=16,
                              tile_block=4, pair_capacity=1 << 13,
                              backend="pallas")
    payload, starts, counts = (torch.as_tensor(a)
                               for a in _jax_payload(cfg, s))
    want = rc.forward_tiles(payload, starts, counts, cfg.n_tiles_padded, 4,
                            16, cfg.tiles_x, 16)
    report = chip_smoke.compare_forward(want, want, payload, 4)
    assert report["last_flips"] == 0 and report["max_abs_err"] == 0.0
    # tile 5 stops compositing after its first splat
    t = 5
    assert int(counts[t]) > 1 and (want[2][t] > 0).any()
    bad_img, bad_t, bad_last = (x.clone() for x in want)
    bad_last[t] = torch.minimum(bad_last[t], torch.zeros_like(bad_last[t]))
    bad_img[t] *= 0.5
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.compare_forward((bad_img, bad_t, bad_last), want,
                                   payload, 4)


def _port(cfg, s, **kw):
    tcfg = trz.RasterizeConfig(**cfg._asdict())
    return trz.rasterize(
        torch.as_tensor(s["means2d"]), torch.as_tensor(s["conics"]),
        torch.as_tensor(s["depths"]), torch.as_tensor(s["opac"]),
        torch.as_tensor(s["feats"]), torch.as_tensor(s["valid"]), tcfg,
        radii=torch.as_tensor(s["radii_xy"]), **kw)


@pytest.mark.parametrize("wh,behind", [((64, 48), 0), ((53, 37), 60)])
def test_rasterize_matches_jax_and_oracle(wh, behind):
    width, height = wh
    s = make_scene(2, n=300, width=width, height=height, behind=behind)
    cfg = jrz.RasterizeConfig(width=width, height=height, tile_size=16,
                              chunk=32, tile_block=4, pair_capacity=1 << 14,
                              backend="pallas")
    j_img, j_a = jrz.rasterize(
        jnp.asarray(s["means2d"]), jnp.asarray(s["conics"]),
        jnp.asarray(s["depths"]), jnp.asarray(s["opac"]),
        jnp.asarray(s["feats"]), jnp.asarray(s["valid"]), cfg,
        radii=jnp.asarray(s["radii_xy"]))
    t_img, t_a = _port(cfg, s)
    assert t_img.shape == (height, width, 4)
    assert t_a.shape == (height, width, 1)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(t_a.numpy(), np.asarray(j_a), rtol=RTOL,
                               atol=ATOL)
    o_img, o_a = rasterize_pixels_ref(
        *(torch.as_tensor(s[k]) for k in ("means2d", "conics", "depths",
                                          "opac", "feats", "valid")),
        width, height, radii=torch.as_tensor(s["radii_xy"]))
    np.testing.assert_allclose(t_img.numpy(), o_img.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(t_a.numpy(), o_a.numpy(), rtol=RTOL,
                               atol=ATOL)
    if behind:
        assert not s["valid"][-behind:].any()
        assert np.isfinite(t_img.numpy()).all()


def test_rasterize_empty_scene():
    s = make_scene(3, n=40)
    s["valid"] = np.zeros_like(s["valid"])
    cfg = jrz.RasterizeConfig(width=64, height=48, chunk=32, tile_block=4,
                              pair_capacity=1 << 12)
    img, a = _port(cfg, s)
    assert (img == 0).all() and (a == 0).all()


def test_rasterize_refuses_grad():
    """Inputs that require grad are accepted under every reduction the JAX
    package has: each gives finite, non-zero gradients, and all agree with
    the default route's. What is refused is a `grad_reduce` that names no
    reduction, and only where a gradient is asked for."""
    s = make_scene(4, n=20)
    cfg = jrz.RasterizeConfig(width=64, height=48, chunk=32, tile_block=4,
                              pair_capacity=1 << 12)
    base = dict(cfg._asdict(), grad_reduce="sortpack")
    grads = []
    for kw in ({}, {"compact_frac": 0.0}, {"reduce_pieces": 2},
               {"grad_reduce": "segsum"}):
        s_t = {k: torch.as_tensor(v) for k, v in s.items()}
        s_t["feats"].requires_grad_(True)
        args = (s_t["means2d"], s_t["conics"], s_t["depths"], s_t["opac"],
                s_t["feats"], s_t["valid"])
        img, _ = trz.rasterize(*args, trz.RasterizeConfig(**dict(base, **kw)))
        img.sum().backward()
        g = s_t["feats"].grad
        assert g.shape == s_t["feats"].shape and torch.isfinite(g).all()
        assert float(g.abs().sum()) > 0.0
        grads.append(g)
    for g in grads[1:]:
        torch.testing.assert_close(g, grads[0], rtol=2e-2, atol=2e-3)
    bad = trz.RasterizeConfig(**dict(base, grad_reduce="atomics"))
    with pytest.raises(ValueError, match="unknown grad_reduce"):
        trz.rasterize(*args, bad)
    with torch.no_grad():
        trz.rasterize(*args, bad)
