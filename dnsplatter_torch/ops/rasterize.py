"""Tiled rasterizer, forward (counterpart of dnsplatter_tpu/ops/rasterize.py).

The layout is the JAX package's pallas path: Gaussians are depth-sorted
once, one table gather serves binning and the pair payload, and a single
key sort `tile * (N + 1) + gauss` emits the dense CSR pair list, whose
sorted keys decode to per-pair Gaussian indices. Per-pair binning fields
come from the `expand_segments` kernel and compositing runs in the
`forward_tiles` kernel (ops/rasterize_cuda.py). Sorts, argsorts, gathers
and cumsums stay PyTorch ops, as they were XLA ops outside Pallas.

Semantics match `rasterize_pixels_ref`: alpha = min(0.999, op *
exp(-sigma)), skipped below 1/255 or for sigma < 0; a pixel ends when the
would-be next transmittance drops to <= 1e-4, excluding the Gaussian that
trips it.

This slice is forward only: `sort_scheme` "depthq" and "tilekey",
`exact_cull`, and inputs that require grad raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from dnsplatter_torch.ops import rasterize_cuda as rc

INT32_MAX = 2**31 - 1
UINT32_MAX = 2**32 - 1


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Static rasterizer configuration; the JAX package's fields and
    defaults. `backend`, `tile_block`, `grad_reduce`, `reduce_pieces`
    and `compact_frac` shape the JAX backends and backward; the port's
    forward has one path (the kernels) and reads them only for
    `n_tiles_padded`, which `tile_block` sets."""

    width: int
    height: int
    tile_size: int = 16
    chunk: int = 64
    tile_block: int = 32
    pair_capacity: int = 1 << 20
    backend: str = "xla"
    grad_reduce: str = "sortpack"
    exact_cull: bool = False
    sort_scheme: str = "auto"
    reduce_pieces: int = 0
    compact_frac: float = 0.375

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_size)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_size)

    @property
    def n_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def n_blocks(self) -> int:
        return -(-self.n_tiles // self.tile_block)

    @property
    def n_tiles_padded(self) -> int:
        return self.n_blocks * self.tile_block

    @property
    def pair_buffer(self) -> int:
        """`pair_capacity` dense slots plus one chunk of sentinel tail."""
        return self.pair_capacity + self.chunk


@dataclasses.dataclass(frozen=True)
class _Binned:
    """Depth-sorted Gaussians + dense CSR tile pair list. Tile t's pairs
    occupy [starts[t], starts[t] + counts[t]) in front-to-back order; dead
    slots (pair_gauss == N) lie past starts[-1]."""

    order: torch.Tensor  # (N,) depth sort permutation
    pair_gauss: torch.Tensor  # (C + chunk,) depth-sorted gaussian index
    pair_orig: torch.Tensor  # (C + chunk,) original gaussian id
    starts: torch.Tensor  # (T_padded + 1,) int32
    counts: torch.Tensor  # (T_padded,) int32
    gauss_starts: torch.Tensor  # (N + 1,) per-Gaussian pair ranges
    total_pairs: torch.Tensor  # () int32 raw total (overflow diagnostic)


def _sort_key_bias(cfg: RasterizeConfig, n: int) -> int:
    """Resolve the sort scheme and return the bias that maps its key
    `tile * (N + 1) + gauss` into int32: 0 for `packed` (the key fits
    int32), 2^31 for `packed32` (it fits uint32). `auto` picks packed, then
    packed32, then tilekey (not ported)."""
    scheme = cfg.sort_scheme
    bound = (cfg.n_tiles_padded + 1) * (n + 1)
    if scheme == "auto":
        if bound <= INT32_MAX:
            scheme = "packed"
        elif bound <= UINT32_MAX:
            scheme = "packed32"
        else:
            raise NotImplementedError(
                "sort_scheme 'tilekey' (auto above (tiles+1)*(N+1) > 2^32, "
                "about 1.86M Gaussians at 1024x576) is not ported yet: "
                "ROADMAP.md queue A item 3")
    if scheme in ("depthq", "tilekey"):
        raise NotImplementedError(
            f"sort_scheme {scheme!r} is not ported yet: ROADMAP.md queue A "
            "item 3 (depthq comes with the training slice)")
    if scheme == "packed":
        if bound > INT32_MAX:
            raise ValueError("packed sort key overflows int32 at this "
                             "(tiles, N)")
        return 0
    if scheme == "packed32":
        if bound > UINT32_MAX:
            raise ValueError("packed32 sort key overflows uint32 at this "
                             "(tiles, N)")
        return 2**31
    raise ValueError(f"unknown sort_scheme {scheme!r}")


def _tile_index(v: torch.Tensor, ts: int, hi: int, plus_one: bool
                ) -> torch.Tensor:
    """clip(floor(v / ts) (+1), 0, hi) as int32. The float is clamped
    before the cast, so inf and NaN land where the JAX package's saturating
    cast puts them, and finite values are unchanged."""
    f = torch.nan_to_num(torch.floor(v / ts), nan=0.0).clamp(-2.0, hi + 2.0)
    i = f.to(torch.int32) + (1 if plus_one else 0)
    return i.clamp(0, hi)


def bin_gaussians(
    cfg: RasterizeConfig,
    means2d: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    validf: torch.Tensor,
    order: Optional[torch.Tensor] = None,
    fields_sorted: Optional[torch.Tensor] = None,
) -> _Binned:
    """Global depth sort + dense CSR tile pair list in one sort (see the
    JAX docstring, rasterize.py:286-313).

    Gaussians whose pair range does not fit `pair_capacity` drop whole,
    deepest first. `order` + `fields_sorted` (the depth-sorted payload
    table with radii_x, radii_y, validf in columns 13..15) skip the
    internal gathers.
    """
    if cfg.exact_cull:
        raise NotImplementedError(
            "exact_cull is not ported yet: ROADMAP.md queue A item 3")
    dev = means2d.device
    n = means2d.shape[0]
    ts = cfg.tile_size
    c = cfg.pair_capacity
    k = cfg.chunk
    t_pad = cfg.n_tiles_padded
    key_bias = _sort_key_bias(cfg, n)
    valid = validf > 0.5

    if order is None:
        order = torch.argsort(torch.where(valid, depths, torch.inf),
                              stable=True)
    if fields_sorted is not None:
        m2d_s = fields_sorted[:, 0:2]
        rad_s = fields_sorted[:, 13:15]
        valid_s = fields_sorted[:, 15] > 0.5
    else:
        m2d_s = means2d[order]
        rad_s = radii[order]
        if rad_s.ndim == 1:
            rad_s = torch.stack([rad_s, rad_s], -1)
        valid_s = valid[order]

    x0 = _tile_index(m2d_s[:, 0] - rad_s[:, 0], ts, cfg.tiles_x, False)
    x1 = _tile_index(m2d_s[:, 0] + rad_s[:, 0], ts, cfg.tiles_x, True)
    y0 = _tile_index(m2d_s[:, 1] - rad_s[:, 1], ts, cfg.tiles_y, False)
    y1 = _tile_index(m2d_s[:, 1] + rad_s[:, 1], ts, cfg.tiles_y, True)
    w = (x1 - x0).clamp_min(0)
    h = (y1 - y0).clamp_min(0)
    counts_g = torch.where(valid_s, w.long() * h.long(), 0)
    offs_raw = torch.cumsum(counts_g, 0) - counts_g
    total_raw = counts_g.sum()
    # Overflow drops whole Gaussians, so the histogram below stays exactly
    # consistent with the emitted pairs.
    counts_g = torch.where(offs_raw + counts_g <= c, counts_g, 0)
    offsets = torch.cumsum(counts_g, 0) - counts_g
    total = counts_g.sum()

    # Per-tile pair counts without expansion, exactly, in integers: +1/-1
    # at the four corners of each kept rectangle, then a 2D prefix sum.
    keep = (counts_g > 0).long()
    gx = cfg.tiles_x + 1
    corner_idx = torch.cat([y0 * gx + x0, y0 * gx + x1, y1 * gx + x0,
                            y1 * gx + x1]).long()
    corner_val = torch.cat([keep, -keep, -keep, keep])
    grid = torch.zeros((cfg.tiles_y + 1) * gx, dtype=torch.int64,
                       device=dev)
    grid.index_add_(0, corner_idx, corner_val)
    counts2d = grid.reshape(cfg.tiles_y + 1, gx).cumsum(0).cumsum(1)
    tile_counts = counts2d[:cfg.tiles_y, :cfg.tiles_x].reshape(-1)
    tile_counts = torch.cat([
        tile_counts,
        torch.zeros(t_pad - cfg.n_tiles, dtype=torch.int64, device=dev)])
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(tile_counts, 0)])

    # Per-pair fields [gauss, offset, packed bbox, original id] as
    # piecewise-constant runs over the pair axis: the expand kernel.
    pos = torch.arange(c, dtype=torch.int64, device=dev)
    live = pos < total
    pack_xyw = cfg.tiles_x < 128 and cfg.tiles_y < 128
    gid = torch.arange(n, dtype=torch.int32, device=dev)
    if pack_xyw:
        xyw = (x0 * 128 + y0) * 256 + w.clamp_min(1)
        vals = torch.stack([gid, offsets.int(), xyw, order.int()])
    else:
        vals = torch.stack([gid, offsets.int(), w.clamp_min(1),
                            x0 * 4096 + y0, order.int()])
    gauss_starts = torch.cat([offsets, total[None]]).to(torch.int32)
    acc = rc.expand_segments(vals, gauss_starts, c).long()
    pair_gauss0 = acc[0]
    rank = pos - acc[1]
    if pack_xyw:
        wg = (acc[2] % 256).clamp_min(1)
        x0p = acc[2] // 32768
        y0p = (acc[2] // 256) % 128
        orig0 = acc[3]
    else:
        wg = acc[2].clamp_min(1)
        x0p = acc[3] // 4096
        y0p = acc[3] % 4096
        orig0 = acc[4]
    tile_id = x0p + rank % wg + (y0p + rank // wg) * cfg.tiles_x
    tile_id = tile_id.clamp(0, t_pad)

    # One sort on the packed key, as int32 (the bias shifts packed32's
    # uint32 range down, keeping the order), so the radix sort makes the
    # passes of a 32-bit key. Keys are unique over live pairs, so the
    # layout is deterministic.
    big = n + 1
    sentinel = t_pad * big + n
    key = torch.where(live, tile_id * big + pair_gauss0, sentinel)
    keys, perm = torch.sort((key - key_bias).to(torch.int32))
    ov = torch.where(live, orig0, n)
    pair_orig = ov[perm]
    pair_gauss = (keys.long() + key_bias) % big
    tail = torch.full((k,), n, dtype=torch.int64, device=dev)
    return _Binned(
        order=order,
        pair_gauss=torch.cat([pair_gauss, tail]).to(torch.int32),
        pair_orig=torch.cat([pair_orig, tail]).to(torch.int32),
        starts=starts.to(torch.int32),
        counts=tile_counts.to(torch.int32),
        gauss_starts=gauss_starts,
        total_pairs=total_raw.to(torch.int32),
    )


def _tiles_to_image(cfg: RasterizeConfig, tiles: torch.Tensor
                    ) -> torch.Tensor:
    """(T_padded, P, F) tile-major buffer -> (H, W, F) cropped image."""
    ts = cfg.tile_size
    f = tiles.shape[-1]
    img = tiles[:cfg.n_tiles].reshape(cfg.tiles_y, cfg.tiles_x, ts, ts, f)
    img = img.permute(0, 2, 1, 3, 4).reshape(cfg.tiles_y * ts,
                                             cfg.tiles_x * ts, f)
    return img[:cfg.height, :cfg.width]


def _raster_fwd(cfg: RasterizeConfig, means2d, conics, opacities, features,
                depths, radii, validf):
    """The depth-ordered table path (JAX rasterize.py:1015-1026 and
    :1058-1095): one (N, 16) gather feeds binning and the payload."""
    n = means2d.shape[0]
    f = features.shape[-1]
    if not 1 <= f <= rc.MAX_FEATS:
        raise ValueError(f"rasterize composites 1..{rc.MAX_FEATS} channels, "
                         f"got {f}")
    dev = means2d.device
    opac_masked = torch.where(validf > 0.5, opacities, 0.0)
    order = torch.argsort(torch.where(validf > 0.5, depths, torch.inf),
                          stable=True)
    if f <= 7:
        fields = torch.cat(
            [means2d, conics, opac_masked[:, None], features,
             torch.zeros((n, 13 - 6 - f), device=dev), radii,
             validf[:, None]], dim=-1)
        fields_s = fields[order]
        binned = bin_gaussians(cfg, means2d, depths, radii, validf,
                               order=order, fields_sorted=fields_s)
    else:  # 8 channels leave no room for the binning columns
        fields_s = torch.cat([means2d, conics, opac_masked[:, None],
                              features], dim=-1)[order]
        binned = bin_gaussians(cfg, means2d, depths, radii, validf,
                               order=order)

    pw = 6 + f
    pw_pad = -(-pw // 8) * 8
    table = torch.cat([fields_s[:, :pw], torch.zeros((1, pw), device=dev)])
    rows = table[binned.pair_gauss.long()]  # (C + K, 6 + F)
    payload = torch.zeros((pw_pad, rows.shape[0]), device=dev)
    payload[:pw] = rows.T
    out_t, tfin_t, _ = rc.forward_tiles(
        payload, binned.starts, binned.counts, cfg.n_tiles_padded, f,
        cfg.tile_size, cfg.tiles_x, cfg.chunk)
    image = _tiles_to_image(cfg, out_t.permute(0, 2, 1))
    alpha = _tiles_to_image(cfg, (1.0 - tfin_t).permute(0, 2, 1))
    return image, alpha


def rasterize(
    means2d: torch.Tensor,
    conics: torch.Tensor,
    depths: torch.Tensor,
    opacities: torch.Tensor,
    features: torch.Tensor,
    valid: torch.Tensor,
    cfg: RasterizeConfig,
    radii: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-rasterize screen-space Gaussians (forward only).

    means2d (N, 2) pixel centers, conics (N, 3), depths (N,) camera z,
    opacities (N,) post-sigmoid, features (N, F) with F <= 8, valid (N,)
    bool or {0,1}, radii (N,) or (N, 2) screen extents (default: the
    3-sigma radius of the conic). Returns (image (H, W, F),
    alpha (H, W, 1)).
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (means2d, conics, opacities, features)):
        raise NotImplementedError(
            "rasterize has no backward in the port yet (the autograd "
            "function with backward_tiles comes with the training slice, "
            "ROADMAP.md queue A item 3); call it under torch.no_grad()")
    validf = valid.to(torch.float32)
    if radii is None:
        a, b, c = conics.unbind(-1)
        det_inv = torch.clamp_min(a * c - b * b, 1e-12)
        ca = c / det_inv
        cc = a / det_inv
        mid = 0.5 * (ca + cc)
        disc = torch.sqrt(torch.clamp_min(
            mid * mid - (ca * cc - (b / det_inv) ** 2), 0.0))
        radii = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(mid + disc,
                                                            0.0)))
    if radii.ndim == 1:
        radii = torch.stack([radii, radii], -1)
    return _raster_fwd(cfg, means2d, conics, opacities, features, depths,
                       radii, validf)
