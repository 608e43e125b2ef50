"""Tiled rasterizer with its backward (counterpart of
dnsplatter_tpu/ops/rasterize.py).

The layout is the JAX package's pallas path. Under the exact schemes
(`packed`, `packed32`, `tilekey`, `auto`) Gaussians are depth-sorted once,
one table gather serves binning and the pair payload, and a single key
sort emits the dense CSR pair list: `tile * (N + 1) + gauss` under the
packed schemes, whose sorted keys decode to per-pair Gaussian indices, or a
stable sort on `tile * 2 + cullbit` with the indices riding as payload
under `tilekey`, which has no ceiling on N. Under `depthq` (the Trainer's
scheme) there is no depth pre-sort: the key is `tile * 2^qb + quantized
depth` and the Gaussian id rides the sort as payload. `exact_cull` drops
the (Gaussian, tile) pairs whose ellipse cannot reach 1/255 anywhere on the
tile to the tail of the tile's range and shrinks the tile's count.

Per-pair binning fields come from the `expand_segments` kernel, or at
N >= 2^24 from a scatter of differences and the `cumsum_lanes_i32` kernel;
compositing runs in `forward_tiles`, its gradient in `backward_tiles`
(ops/rasterize_cuda.py). The per-Gaussian sums of the backward take one of
four routes, as the JAX package's do:

* `reduce_segments_bykey` (the default, `compact_frac > 0`): the live pair
  slots are sorted by original Gaussian id and each id's run is summed;
* `reduce_segments_packed` (`compact_frac == 0`): the whole packed slab is
  sorted by id and the runs are bounded by `orig_starts`, the per-id pair
  counts known from binning;
* `reduce_segments_packed_multi` (`reduce_pieces > 1`): the slab is cut at
  tile boundaries into pair-balanced pieces, each sorted on its own, and
  every id sums one run per piece. Piece lengths follow the data here, so
  the JAX package's static `piece_capacity` and its fallback to the
  monolithic sort have no counterpart;
* `reduce_segments` (`grad_reduce="segsum"`, the exact float32 reduction):
  the unpacked float32 slab is sorted by id and its runs summed. The JAX
  package sums the same slab with `jax.ops.segment_sum`; a scatter-add on
  the card adds in arrival order and differs from run to run, so the port
  takes the sorted route: the same per-id float32 sums, in one fixed
  order. A difference of route, not of result.

Sorts, argsorts, gathers and scatters stay PyTorch ops, as they were XLA
ops outside Pallas.

Semantics match `rasterize_pixels_ref`: alpha = min(0.999, op *
exp(-sigma)), skipped below 1/255 or for sigma < 0; a pixel ends when the
would-be next transmittance drops to <= 1e-4, excluding the Gaussian that
trips it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from dnsplatter_torch.ops import rasterize_cuda as rc
from dnsplatter_torch.utils import profiling

INT32_MAX = 2**31 - 1
UINT32_MAX = 2**32 - 1
# From this many Gaussians on, binning builds its per-pair rows by prefix sum
# (`cumsum_lanes_i32`) instead of `expand_segments`, `depthq` refuses, and
# `exact_cull` is a no-op (as it is from this pair capacity on): the JAX
# package's float32 expansion is exact only below it. A module constant so
# that a test can lower it.
F32_EXACT_LIMIT = 1 << 24


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Static rasterizer configuration; the JAX package's fields and
    defaults. The port has one path (the kernels), so `backend` is not
    read and `tile_block` only sets `n_tiles_padded`. `grad_reduce`:
    "sortpack" (bf16-packed per-pair gradients) or "segsum" (exact
    float32). Under sortpack, `reduce_pieces > 1` takes the piecewise
    reduction, else `compact_frac` chooses: 0 the boundary reduction over
    the whole slab; in (0, 1) the reduction by key after dropping the pair
    slots past each tile's deepest contributor (they hold exact zeros);
    >= 1 the reduction by key over every slot. Its value inside (0, 1)
    sized the JAX package's static window budget and is not needed here,
    where the kept length follows the data."""

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
    def n_reduce_pieces(self) -> int:
        return self.reduce_pieces or 1

    @property
    def piece_capacity(self) -> int:
        """The JAX package's static per-piece slab length, kept so that
        configurations compare equal field for field. Nothing reads it:
        the port's pieces are as long as the data makes them."""
        cap = self.pair_capacity // self.n_reduce_pieces + 16384
        return -(-cap // self.chunk) * self.chunk

    @property
    def boundary_reduce(self) -> bool:
        """Whether the backward sums contiguous per-id ranges, and binning
        therefore has to provide `orig_starts`. False on the default path
        (sortpack by key), which pays no N-scale work for it."""
        return (self.grad_reduce != "sortpack" or self.n_reduce_pieces > 1
                or self.compact_frac <= 0.0)

    @property
    def pair_buffer(self) -> int:
        """`pair_capacity` dense slots plus one chunk of sentinel tail."""
        return self.pair_capacity + self.chunk


@dataclasses.dataclass(frozen=True)
class _Binned:
    """Depth-sorted Gaussians + dense CSR tile pair list. Tile t's pairs
    occupy [starts[t], starts[t] + counts[t]) in front-to-back order; dead
    slots (pair_gauss == N) lie past starts[-1]. With `exact_cull`,
    counts[t] <= starts[t+1] - starts[t] and the slots between hold the
    culled pairs: pair_gauss == N under the exact schemes, the real id
    under depthq, so a consumer bounds by `counts`, never by the sentinel.
    `pair_orig` keeps the real id of a culled pair under every scheme."""

    order: torch.Tensor  # (N,) depth sort permutation (identity: depthq)
    pair_gauss: torch.Tensor  # (C + chunk,) index into the payload table
    pair_orig: torch.Tensor  # (C + chunk,) original gaussian id
    starts: torch.Tensor  # (T_padded + 1,) int32
    counts: torch.Tensor  # (T_padded,) int32
    gauss_starts: torch.Tensor  # (N + 1,) per-Gaussian pair ranges
    total_pairs: torch.Tensor  # () int32 raw total (overflow diagnostic)
    # (N + 1,) int32 per-original-id ranges of the pair list once sorted by
    # pair_orig; only where cfg.boundary_reduce
    orig_starts: Optional[torch.Tensor] = None
    # (KP + 1,) slab offsets of the reduction pieces and (KP, N + 1)
    # piece-local per-original-id ranges; only where reduce_pieces > 1
    piece_bounds: Optional[torch.Tensor] = None
    piece_starts: Optional[torch.Tensor] = None


def _resolve_scheme(cfg: RasterizeConfig, n: int) -> Tuple[str, int]:
    """Resolve an exact sort scheme: (scheme, bias). The bias maps the
    packed key `tile * (N + 1) + gauss` into int32: 0 for `packed` (the key
    fits int32), 2^31 for `packed32` (it fits uint32). `auto` picks packed,
    then packed32, then tilekey (above (tiles + 1) * (N + 1) = 2^32, about
    1.86M Gaussians at 1024x576). `depthq` has its own key."""
    scheme = cfg.sort_scheme
    bound = (cfg.n_tiles_padded + 1) * (n + 1)
    if scheme == "auto":
        if bound <= INT32_MAX:
            scheme = "packed"
        elif bound <= UINT32_MAX:
            scheme = "packed32"
        else:
            scheme = "tilekey"
    if scheme == "tilekey":
        return scheme, 0
    if scheme == "packed":
        if bound > INT32_MAX:
            raise ValueError("packed sort key overflows int32 at this "
                             "(tiles, N); use sort_scheme='tilekey'")
        return scheme, 0
    if scheme == "packed32":
        if bound > UINT32_MAX:
            raise ValueError("packed32 sort key overflows uint32 at this "
                             "(tiles, N); use sort_scheme='tilekey'")
        return scheme, 2**31
    raise ValueError(f"unknown sort_scheme {scheme!r}")


def _tile_index(v: torch.Tensor, ts: int, hi: int, plus_one: bool
                ) -> torch.Tensor:
    """clip(floor(v / ts) (+1), 0, hi) as int32. The float is clamped
    before the cast, so inf and NaN land where the JAX package's saturating
    cast puts them, and finite values are unchanged."""
    f = torch.nan_to_num(torch.floor(v / ts), nan=0.0).clamp(-2.0, hi + 2.0)
    i = f.to(torch.int32) + (1 if plus_one else 0)
    return i.clamp(0, hi)


def _tile_bbox(cfg: RasterizeConfig, m2d: torch.Tensor, rad: torch.Tensor):
    """Tile rectangle [x0, x1) x [y0, y1) of each Gaussian's screen extent."""
    ts = cfg.tile_size
    x0 = _tile_index(m2d[:, 0] - rad[:, 0], ts, cfg.tiles_x, False)
    x1 = _tile_index(m2d[:, 0] + rad[:, 0], ts, cfg.tiles_x, True)
    y0 = _tile_index(m2d[:, 1] - rad[:, 1], ts, cfg.tiles_y, False)
    y1 = _tile_index(m2d[:, 1] + rad[:, 1], ts, cfg.tiles_y, True)
    return x0, x1, y0, y1


def _pairs_survive(cfg: RasterizeConfig, tile_id: torch.Tensor,
                   flds: torch.Tensor) -> torch.Tensor:
    """The exact ellipse-tile test (JAX rasterize.py:554-584). `flds` holds
    the per-pair rows [mx, my, a, b, c, log(255 op)]. The minimum of the
    conic quadratic sigma over the tile square is 0 if the centre lies
    inside, else the best of the four clamped edge minimizers; the pair
    survives iff op * exp(-sigma_min) can reach 1/255. The 1e-3 margin
    keeps borderline pairs, so rounding can only cull too little."""
    pmx, pmy, pa, pb, pcc, pthr = flds.unbind(0)
    ts = float(cfg.tile_size)
    ax0 = (tile_id % cfg.tiles_x).float() * ts - pmx
    ay0 = torch.div(tile_id, cfg.tiles_x,
                    rounding_mode="floor").float() * ts - pmy
    ax1 = ax0 + ts
    ay1 = ay0 + ts
    a_ = pa.clamp_min(1e-12)
    c_ = pcc.clamp_min(1e-12)

    def sig(dx, dy):
        return 0.5 * (a_ * dx * dx + c_ * dy * dy) + pb * dx * dy

    def edge_x(dx):  # fixed dx, the best dy in [ay0, ay1]
        return sig(dx, torch.clamp(-pb * dx / c_, ay0, ay1))

    def edge_y(dy):  # fixed dy, the best dx in [ax0, ax1]
        return sig(torch.clamp(-pb * dy / a_, ax0, ax1), dy)

    smin = torch.minimum(torch.minimum(edge_x(ax0), edge_x(ax1)),
                         torch.minimum(edge_y(ay0), edge_y(ay1)))
    inside = (ax0 <= 0.0) & (0.0 <= ax1) & (ay0 <= 0.0) & (0.0 <= ay1)
    smin = torch.where(inside, 0.0, smin)
    return smin <= pthr + 1e-3


def _piece_structure(cfg: RasterizeConfig, starts: torch.Tensor,
                     counts_orig: torch.Tensor, bbox_u):
    """KP pair-balanced reduction pieces cut at tile boundaries (JAX
    rasterize.py:771-802): (piece_bounds (KP + 1,), piece_starts
    (KP, N + 1)), both int32. An id's count below a tile boundary is closed
    form from its rectangle: the full rows above the boundary's row plus
    the boundary row's columns left of it. That counts exactly the slots
    the CSR holds, culled ones included, and Gaussians dropped for
    capacity count nothing."""
    kp = cfg.n_reduce_pieces
    t_pad = cfg.n_tiles_padded
    dev = starts.device
    x0u, x1u, y0u, y1u = (v.long() for v in bbox_u)
    targets = (torch.arange(1, kp, dtype=torch.int64, device=dev)
               * (cfg.pair_capacity // kp))
    tj = torch.searchsorted(starts, targets)
    tjf = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), tj,
                     torch.full((1,), t_pad, dtype=torch.int64, device=dev)])
    # a target past the last pair finds index t_pad + 1: an empty piece
    piece_bounds = starts[tjf.clamp_max(t_pad)]
    emitted = counts_orig > 0
    wu = (x1u - x0u).clamp_min(0)
    cls = []
    for j in range(kp + 1):
        rb = torch.div(tjf[j], cfg.tiles_x, rounding_mode="floor")
        cb = tjf[j] % cfg.tiles_x
        full = wu * (torch.minimum(y1u, rb) - y0u).clamp_min(0)
        part = torch.where((y0u <= rb) & (rb < y1u),
                           (torch.minimum(x1u, cb) - x0u).clamp_min(0), 0)
        cls.append(torch.where(emitted, full + part, 0))
    piece_counts = torch.stack([cls[j + 1] - cls[j] for j in range(kp)])
    piece_starts = torch.cat(
        [torch.zeros((kp, 1), dtype=torch.int64, device=dev),
         torch.cumsum(piece_counts, dim=1)], dim=1)
    return piece_bounds.to(torch.int32), piece_starts.to(torch.int32)


def bin_gaussians(
    cfg: RasterizeConfig,
    means2d: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    validf: torch.Tensor,
    conics: Optional[torch.Tensor] = None,
    opacities: Optional[torch.Tensor] = None,
    order: Optional[torch.Tensor] = None,
    fields_sorted: Optional[torch.Tensor] = None,
) -> _Binned:
    """Global depth sort + dense CSR tile pair list in one sort (see the
    JAX docstring, rasterize.py:286-313).

    Gaussians whose pair range does not fit `pair_capacity` drop whole:
    deepest first under the exact schemes, in array order under `depthq`,
    which has no depth pre-sort. `order` + `fields_sorted` (the
    depth-sorted payload table with radii_x, radii_y, validf in columns
    13..15) skip the internal gathers. `conics` and `opacities` feed
    `exact_cull`; without them, or from F32_EXACT_LIMIT Gaussians or pair
    slots on, culling is a no-op and the layout stays right. Counts the
    call, its pairs listed and its capacity (`bin.*`).
    """
    with profiling.span("raster.bin"):
        dev = means2d.device
        n = means2d.shape[0]
        c = cfg.pair_capacity
        k = cfg.chunk
        t_pad = cfg.n_tiles_padded
        depthq = cfg.sort_scheme == "depthq"
        valid = validf > 0.5
        rad_u = radii if radii.ndim == 2 else torch.stack([radii, radii], -1)

        if depthq:
            qbits = 32 - max(int(t_pad + 1).bit_length(), 1)
            if qbits < 14:
                raise ValueError(f"depthq needs >= 14 depth bits, got {qbits} "
                                 f"at {t_pad} padded tiles; use "
                                 "sort_scheme='auto'")
            if n >= F32_EXACT_LIMIT:
                raise ValueError(f"depthq takes fewer than {F32_EXACT_LIMIT} "
                                 f"Gaussians, got {n}; use sort_scheme='auto'")
            scheme = "depthq"
            order = torch.arange(n, dtype=torch.int64, device=dev)
            m2d_s = means2d
            rad_s = rad_u
            valid_s = valid
        else:
            scheme, key_bias = _resolve_scheme(cfg, n)
            if order is None:
                order = torch.argsort(torch.where(valid, depths, torch.inf),
                                      stable=True)
            if fields_sorted is not None:
                m2d_s = fields_sorted[:, 0:2]
                rad_s = fields_sorted[:, 13:15]
                valid_s = fields_sorted[:, 15] > 0.5
            else:
                m2d_s = means2d[order]
                rad_s = rad_u[order]
                valid_s = valid[order]

        x0, x1, y0, y1 = _tile_bbox(cfg, m2d_s, rad_s)
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

        # Per-pair fields [gauss, offset, packed bbox, row 4] as
        # piecewise-constant runs over the pair axis. Row 4 is the original id
        # under the exact schemes; under depthq row 0 is already the original
        # id and row 4 carries the quantized depth.
        pos = torch.arange(c, dtype=torch.int64, device=dev)
        live = pos < total
        pack_xyw = cfg.tiles_x < 128 and cfg.tiles_y < 128
        gid = torch.arange(n, dtype=torch.int32, device=dev)
        if depthq:
            qmax = (1 << qbits) - 1
            dmin = torch.where(valid, depths, torch.inf).amin()
            dmax = torch.where(valid, depths, -torch.inf).amax()
            dmin = torch.where(torch.isfinite(dmin), dmin, 0.0)
            dmax = torch.where(torch.isfinite(dmax), dmax, 0.0)
            span = torch.clamp_min(dmax - dmin, 1e-12)
            qdf = torch.clamp(torch.round((depths - dmin) / span * (qmax - 1)),
                              0.0, float(qmax - 1))
            # Clamped once more as an integer: above 24 depth bits (fewer than
            # 255 padded tiles) float32 rounds qmax - 1 up to 2^qbits, and the
            # deepest Gaussian's key would carry into the next tile's range
            # (the JAX package files it there; see ROADMAP.md section C).
            row4 = torch.nan_to_num(torch.where(valid, qdf, 0.0)).to(
                torch.int32).clamp_max(qmax - 1)
        else:
            row4 = order.int()
        if pack_xyw:
            xyw = (x0 * 128 + y0) * 256 + w.clamp_min(1)
            vals = torch.stack([gid, offsets.int(), xyw, row4])
        else:
            vals = torch.stack([gid, offsets.int(), w.clamp_min(1),
                                x0 * 4096 + y0, row4])
        nv = vals.shape[0]
        gauss_starts = torch.cat([offsets, total[None]]).to(torch.int32)
        expand = n < F32_EXACT_LIMIT
        cull = (cfg.exact_cull and expand and c < F32_EXACT_LIMIT
                and conics is not None and opacities is not None)
        if cull:
            # One combined float32 expansion: the integer rows (below 2^24
            # here, so exact in float32) and six geometry rows for the test.
            if depthq:
                con_s = conics
                op_s = torch.where(valid, opacities, 0.0)
            elif fields_sorted is not None:
                con_s = fields_sorted[:, 2:5]
                op_s = fields_sorted[:, 5]  # already masked by validity
            else:
                con_s = conics[order]
                op_s = torch.where(valid_s, opacities[order], 0.0)
            thr = torch.log(op_s.clamp_min(1e-12) * 255.0)
            allvals = torch.cat([
                vals.float(),
                torch.stack([m2d_s[:, 0], m2d_s[:, 1], con_s[:, 0],
                             con_s[:, 1], con_s[:, 2], thr])])
            accf = rc.expand_segments(allvals, gauss_starts, c,
                                      out_dtype=torch.float32)
            acc = accf[:nv].long()
            pair_flds = accf[nv:]
        elif expand:
            acc = rc.expand_segments(vals, gauss_starts, c).long()
        else:
            # Above the expansion's ceiling (JAX rasterize.py:522-533): the
            # differences between neighbouring Gaussians' rows, scattered at
            # each Gaussian's first pair slot, then a prefix sum along the pair
            # axis. Gaussians without pairs share a slot with their successor
            # (or, past the last pair, with each other), so the scatter adds;
            # slots at or past the capacity are dropped.
            diffs = torch.cat([vals[:, :1], vals[:, 1:] - vals[:, :-1]], dim=1)
            inside = profiling.host_read("bin_scatter", torch.nonzero,
                                         offsets < c)[:, 0]
            table = torch.zeros((nv, c), dtype=torch.int32, device=dev)
            table.index_add_(1, offsets[inside], diffs[:, inside])
            acc = rc.cumsum_lanes_i32(table).long()
        pair_gauss0 = acc[0]
        rank = pos - acc[1]
        if pack_xyw:
            wg = (acc[2] % 256).clamp_min(1)
            x0p = acc[2] // 32768
            y0p = (acc[2] // 256) % 128
            row4_pair = acc[3]
        else:
            wg = acc[2].clamp_min(1)
            x0p = acc[3] // 4096
            y0p = acc[3] % 4096
            row4_pair = acc[4]
        orig0 = pair_gauss0 if depthq else row4_pair
        tile_id = x0p + rank % wg + (y0p + rank // wg) * cfg.tiles_x
        tile_id = tile_id.clamp(0, t_pad)
        ov = torch.where(live, orig0, n)
        if cull:
            culled = live & ~_pairs_survive(cfg, tile_id, pair_flds)

        # One sort on the key, as int32 (the bias shifts a uint32 range down,
        # keeping the order), so the radix sort makes the passes of a 32-bit
        # key. A culled pair keeps its slot inside its tile's range (the
        # histogram counted the full rectangles) but takes the largest key of
        # its tile: it sorts to the range's tail, and the first such key per
        # tile, found by binary search, is the tile's shrunken count. Those
        # keys tie, so with culling every sort is stable.
        tiles = torch.arange(t_pad, dtype=torch.int64, device=dev)
        if depthq:
            # key = tile * 2^qb + quantized depth (uint32); the id rides as
            # payload. Dead lanes take qmax, above any real depth, and land
            # past the last tile. Equal keys (one tile, one quantized depth)
            # keep their pre-sort order, ascending id: the sort is stable, so
            # the layout is the same from run to run.
            bigq = qmax + 1
            sentinel = t_pad * bigq + qmax
            key = torch.where(live, tile_id * bigq + row4_pair, sentinel)
            if cull:
                key = torch.where(culled, tile_id * bigq + qmax, key)
            keys, perm = torch.sort((key - 2**31).to(torch.int32), stable=True)
            pair_gauss = ov[perm]
            pair_orig = pair_gauss
            bounds = tiles * bigq + qmax - 2**31
        elif scheme == "tilekey":
            # A stable sort on tile * 2 + cullbit alone. Before the sort the
            # pairs of one tile already ascend in Gaussian (= depth) order, so
            # stability gives exactly the packed layout, and the index rides
            # as payload instead of being decoded from the key: any N.
            key = torch.where(live, tile_id * 2, 2 * t_pad + 2)
            gv = torch.where(live, pair_gauss0, n)
            if cull:
                key = torch.where(culled, tile_id * 2 + 1, key)
                gv = torch.where(culled, n, gv)
            keys, perm = torch.sort(key.to(torch.int32), stable=True)
            pair_gauss = gv[perm]
            pair_orig = ov[perm]
            bounds = tiles * 2 + 1
        else:
            # tile * (N + 1) + gauss: unique over live, unculled pairs; a
            # culled pair takes its tile's own sentinel index N, which decodes
            # to the payload table's zero row.
            big = n + 1
            sentinel = t_pad * big + n
            key = torch.where(live, tile_id * big + pair_gauss0, sentinel)
            if cull:
                key = torch.where(culled, tile_id * big + n, key)
            keys, perm = torch.sort((key - key_bias).to(torch.int32),
                                    stable=cull)
            pair_orig = ov[perm]
            pair_gauss = (keys.long() + key_bias) % big
            bounds = tiles * big + n - key_bias
        if cull:
            surv_end = torch.searchsorted(keys, bounds.to(torch.int32))
            tile_counts = surv_end - starts[:-1]
        tail = torch.full((k,), n, dtype=torch.int64, device=dev)
        pair_gauss = torch.cat([pair_gauss, tail]).to(torch.int32)
        pair_orig = (pair_gauss if depthq
                     else torch.cat([pair_orig, tail]).to(torch.int32))

        orig_starts = piece_bounds = piece_starts = None
        if cfg.boundary_reduce:
            # Per-original-id pair counts: counts_g back in parameter order
            # (`order` is a permutation, so the scatter has no collisions).
            # The JAX package recomputes them from the unsorted rectangles
            # while nothing overflowed; the capacity drop follows the
            # depth-sorted prefix, so under overflow only this form is right,
            # and without overflow the two agree.
            counts_orig = (counts_g if depthq
                           else torch.zeros_like(counts_g).scatter_(
                               0, order.long(), counts_g))
            orig_starts = torch.cat([
                torch.zeros(1, dtype=torch.int64, device=dev),
                torch.cumsum(counts_orig, 0)]).to(torch.int32)
            if cfg.n_reduce_pieces > 1:
                piece_bounds, piece_starts = _piece_structure(
                    cfg, starts, counts_orig, _tile_bbox(cfg, means2d, rad_u))
        binned = _Binned(
            order=order,
            pair_gauss=pair_gauss,
            pair_orig=pair_orig,
            starts=starts.to(torch.int32),
            counts=tile_counts.to(torch.int32),
            gauss_starts=gauss_starts,
            total_pairs=total_raw.to(torch.int32),
            orig_starts=orig_starts,
            piece_bounds=piece_bounds,
            piece_starts=piece_starts,
        )
    profiling.count("bin.calls")
    profiling.count("bin.pairs_listed", binned.total_pairs)
    profiling.count("bin.pair_capacity", cfg.pair_capacity)
    return binned


def _tiles_to_image(cfg: RasterizeConfig, tiles: torch.Tensor
                    ) -> torch.Tensor:
    """(T_padded, P, F) tile-major buffer -> (H, W, F) cropped image."""
    ts = cfg.tile_size
    f = tiles.shape[-1]
    img = tiles[:cfg.n_tiles].reshape(cfg.tiles_y, cfg.tiles_x, ts, ts, f)
    img = img.permute(0, 2, 1, 3, 4).reshape(cfg.tiles_y * ts,
                                             cfg.tiles_x * ts, f)
    return img[:cfg.height, :cfg.width]


def _image_to_tiles(cfg: RasterizeConfig, img: torch.Tensor) -> torch.Tensor:
    """(H, W, F) -> zero-padded (T_padded, P, F) tile-major buffer."""
    ts = cfg.tile_size
    f = img.shape[-1]
    full = torch.zeros((cfg.tiles_y * ts, cfg.tiles_x * ts, f),
                       dtype=img.dtype, device=img.device)
    full[:cfg.height, :cfg.width] = img
    t = full.reshape(cfg.tiles_y, ts, cfg.tiles_x, ts, f)
    t = t.permute(0, 2, 1, 3, 4).reshape(cfg.n_tiles, ts * ts, f)
    pad_tiles = cfg.n_tiles_padded - cfg.n_tiles
    if pad_tiles:
        t = torch.cat([t, torch.zeros((pad_tiles, ts * ts, f), dtype=t.dtype,
                                      device=t.device)])
    return t


def _raster_fwd(cfg: RasterizeConfig, means2d, conics, opacities, features,
                depths, radii, validf):
    """Binning, payload and `forward_tiles` (JAX rasterize.py:986-1095).
    Under the exact schemes one depth-ordered (N, 16) gather feeds binning
    and the payload; under depthq the payload table is a plain concat in
    original order. Returns (image, alpha) and the residuals of the
    backward: (binned, payload, t_final, last)."""
    n = means2d.shape[0]
    f = features.shape[-1]
    if not 1 <= f <= rc.MAX_FEATS:
        raise ValueError(f"rasterize composites 1..{rc.MAX_FEATS} channels, "
                         f"got {f}")
    dev = means2d.device
    opac_masked = torch.where(validf > 0.5, opacities, 0.0)
    if cfg.sort_scheme == "depthq":
        fields_s = torch.cat([means2d, conics, opac_masked[:, None],
                              features], dim=-1)
        binned = bin_gaussians(cfg, means2d, depths, radii, validf,
                               conics=conics, opacities=opacities)
    else:
        order = torch.argsort(torch.where(validf > 0.5, depths, torch.inf),
                              stable=True)
        if f <= 7:
            fields = torch.cat(
                [means2d, conics, opac_masked[:, None], features,
                 torch.zeros((n, 13 - 6 - f), device=dev), radii,
                 validf[:, None]], dim=-1)
            fields_s = fields[order]
            binned = bin_gaussians(cfg, means2d, depths, radii, validf,
                                   conics=conics, opacities=opacities,
                                   order=order, fields_sorted=fields_s)
        else:  # 8 channels leave no room for the binning columns
            fields_s = torch.cat([means2d, conics, opac_masked[:, None],
                                  features], dim=-1)[order]
            binned = bin_gaussians(cfg, means2d, depths, radii, validf,
                                   conics=conics, opacities=opacities,
                                   order=order)

    pw = 6 + f
    pw_pad = -(-pw // 8) * 8
    with profiling.span("raster.payload"):
        table = torch.cat([fields_s[:, :pw],
                           torch.zeros((1, pw), device=dev)])
        rows = table[binned.pair_gauss.long()]  # (C + K, 6 + F)
        payload = torch.zeros((pw_pad, rows.shape[0]), device=dev)
        payload[:pw] = rows.T
    with profiling.span("raster.tiles"):
        out_t, tfin_t, last_t = rc.forward_tiles(
            payload, binned.starts, binned.counts, cfg.n_tiles_padded, f,
            cfg.tile_size, cfg.tiles_x, cfg.chunk)
    with profiling.span("render.finish"):
        image = _tiles_to_image(cfg, out_t.permute(0, 2, 1))
        alpha = _tiles_to_image(cfg, (1.0 - tfin_t).permute(0, 2, 1))
    return (image, alpha), (binned, payload, tfin_t, last_t)


def live_pair_slots(cfg: RasterizeConfig, binned: _Binned,
                    last_t: torch.Tensor) -> torch.Tensor:
    """Indices of the pair slots at or before their tile's deepest
    contributor, ascending. Every other slot holds an exact-zero gradient
    (`backward_tiles` never writes it). The length follows the data, so
    this reads one count back from the device (`sync.live_slots`)."""
    with profiling.span("raster.live_slots"):
        t_pad = cfg.n_tiles_padded
        p = cfg.tile_size * cfg.tile_size
        ml = last_t.reshape(t_pad, p).amax(dim=1).long()
        counts = binned.counts.long()
        lc = torch.minimum(ml + 1, counts)
        s = binned.starts[:-1].long()
        has = (lc > 0).long()
        mark = torch.zeros(cfg.pair_buffer + 1, dtype=torch.int64,
                           device=last_t.device)
        mark.index_add_(0, s, has)
        mark.index_add_(0, s + lc, -has)
        return profiling.host_read("live_slots", torch.nonzero,
                                   torch.cumsum(mark[:-1], 0) > 0)[:, 0]


def _reduce_bykey(cfg: RasterizeConfig, binned: _Binned, slab, last_t,
                  ru: int, n: int) -> torch.Tensor:
    """The default reduction (JAX `_reduce_bykey` :1273): the live pair
    slots (all of them at compact_frac >= 1) sorted by original id, each
    id's run found and summed by `reduce_segments_bykey`."""
    keys = binned.pair_orig
    vals = slab[:ru]
    if cfg.compact_frac < 1.0:
        slots = live_pair_slots(cfg, binned, last_t)
        profiling.count("bwd.live_slots", slots.shape[0])
        keys = keys[slots]
        vals = vals[:, slots]
    # int32 keys: a 32-bit radix sort, stable so that each id's lanes keep
    # one order from run to run; dead slots carry the sentinel N and land
    # at the end, where the reduction never looks.
    keys_s, perm = torch.sort(keys, stable=True)
    # Rows padded to a multiple of 4 words: the kernel then loads 16 bytes a
    # thread.
    length = keys_s.shape[0]
    sorted_slab = torch.empty((ru + 1, -(-length // 4) * 4),
                              dtype=torch.int32,
                              device=slab.device)[:, :length]
    sorted_slab[:ru] = vals[:, perm]
    sorted_slab[ru] = keys_s
    return rc.reduce_segments_bykey(sorted_slab, ru, n)


def _reduce_pieces(cfg: RasterizeConfig, binned: _Binned, slab, ru: int,
                   n: int) -> torch.Tensor:
    """The piecewise reduction (JAX `reduce_pieces` :1467): each piece of
    the slab is sorted by original id on its own and laid into one
    (KP, ru, longest piece) tensor; `reduce_segments_packed_multi` sums an
    id's run in every piece. The piece lengths are read back from the
    device (KP + 1 integers); nothing is padded to a static capacity, so no
    piece can overflow."""
    kp = cfg.n_reduce_pieces
    pb = profiling.host_read("piece_bounds", binned.piece_bounds.tolist)
    cp = max(max(pb[j + 1] - pb[j] for j in range(kp)), 1)
    packed = torch.zeros((kp, ru, cp), dtype=torch.int32,
                         device=slab.device)
    for j in range(kp):
        lo, hi = pb[j], pb[j + 1]
        if hi > lo:
            _, perm = torch.sort(binned.pair_orig[lo:hi], stable=True)
            packed[j, :, :hi - lo] = slab[:ru, lo:hi][:, perm]
    return rc.reduce_segments_packed_multi(packed, binned.piece_starts, n)


def _raster_bwd(cfg: RasterizeConfig, residuals, g_image, g_alpha, n: int):
    """Per-Gaussian gradients (JAX `_raster_bwd_pallas` :1388):
    `backward_tiles` writes the per-pair gradients, which are sorted by
    original Gaussian id and summed per id by the reduction the
    configuration names (see the module docstring), so the result is in
    original parameter order under every sort scheme. Every sort is stable:
    an id's lanes keep one order, and two runs give the same bits. Dead
    slots carry the sentinel id N and sort past every run. Returns
    (N, 8 + F): [dmx, dmy, da, db, dc, dop, df.., |dmx|, |dmy|]."""
    binned, payload, tfin_t, last_t = residuals
    profiling.count("bwd.pairs_listed", binned.total_pairs)
    f = g_image.shape[-1]
    g_out_t = _image_to_tiles(cfg, g_image).permute(0, 2, 1).contiguous()
    g_alpha_t = _image_to_tiles(cfg, g_alpha).permute(0, 2, 1).contiguous()
    pack = cfg.grad_reduce == "sortpack"
    slab = rc.backward_tiles(
        payload, binned.starts, binned.counts, g_out_t, g_alpha_t, tfin_t,
        last_t, cfg.n_tiles_padded, f, cfg.tile_size, cfg.tiles_x, cfg.chunk,
        pack_grads=pack)
    nlive = 6 + f
    with profiling.span("raster.reduce"):
        if not pack:
            # Exact float32: the rows in use, sorted by id, runs bounded by
            # orig_starts.
            rows = torch.cat([slab[:nlive], slab[rc.GW - 2:rc.GW]])
            _, perm = torch.sort(binned.pair_orig, stable=True)
            return rc.reduce_segments(rows[:, perm], binned.orig_starts,
                                      n).T
        ru = rc.packed_rows(f)
        if cfg.n_reduce_pieces > 1:
            per = _reduce_pieces(cfg, binned, slab, ru, n)
        elif cfg.compact_frac <= 0.0:
            # The boundary reduction (JAX `reduce_mono` :1454) over the
            # whole slab.
            _, perm = torch.sort(binned.pair_orig, stable=True)
            per = rc.reduce_segments_packed(slab[:ru][:, perm],
                                            binned.orig_starts, n)
        else:
            per = _reduce_bykey(cfg, binned, slab, last_t, ru, n)
        return torch.cat([per[:nlive], per[2 * ru:2 * ru + 2]]).T


class _RasterizeFn(torch.autograd.Function):
    """`rasterize` with its hand-written backward (the JAX package's
    `_rasterize_core` custom VJP). Gradients flow to means2d, conics,
    opacities and features; `absgrad_sink` receives (|dmx|, |dmy|) summed
    per Gaussian, the densification statistic; depths, radii and validf
    get none."""

    @staticmethod
    def forward(ctx, cfg, means2d, conics, opacities, features, absgrad_sink,
                depths, radii, validf):
        (image, alpha), residuals = _raster_fwd(
            cfg, means2d, conics, opacities, features, depths, radii, validf)
        ctx.cfg = cfg
        ctx.n = means2d.shape[0]
        ctx.residuals = residuals
        return image, alpha

    @staticmethod
    def backward(ctx, g_image, g_alpha):
        cfg = ctx.cfg
        f = g_image.shape[-1]
        with profiling.span("raster.backward"):
            out = _raster_bwd(cfg, ctx.residuals, g_image, g_alpha, ctx.n)
        return (None, out[:, 0:2], out[:, 2:5], out[:, 5], out[:, 6:6 + f],
                out[:, 6 + f:8 + f], None, None, None)


def rasterize(
    means2d: torch.Tensor,
    conics: torch.Tensor,
    depths: torch.Tensor,
    opacities: torch.Tensor,
    features: torch.Tensor,
    valid: torch.Tensor,
    cfg: RasterizeConfig,
    absgrad_sink: Optional[torch.Tensor] = None,
    radii: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-rasterize screen-space Gaussians.

    means2d (N, 2) pixel centers, conics (N, 3), depths (N,) camera z,
    opacities (N,) post-sigmoid, features (N, F) with F <= 8, valid (N,)
    bool or {0,1}, radii (N,) or (N, 2) screen extents (default: the
    3-sigma radius of the conic). `absgrad_sink`: optional (N, 2) zeros
    whose gradient is the absolute screen-space gradient. Returns
    (image (H, W, F), alpha (H, W, 1)); differentiable in means2d, conics,
    opacities and features.
    """
    validf = valid.to(torch.float32)
    if radii is None:
        with torch.no_grad():
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
    diff = (means2d, conics, opacities, features, absgrad_sink)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in diff):
        if cfg.grad_reduce not in ("sortpack", "segsum"):
            raise ValueError(f"unknown grad_reduce {cfg.grad_reduce!r}: "
                             "'sortpack' or 'segsum'")
        if absgrad_sink is None:
            absgrad_sink = torch.zeros_like(means2d)
        return _RasterizeFn.apply(cfg, means2d, conics, opacities, features,
                                  absgrad_sink, depths.detach(),
                                  radii.detach(), validf)
    with torch.no_grad():
        out, _ = _raster_fwd(cfg, means2d, conics, opacities, features,
                             depths, radii, validf)
    return out
