"""Kernel wrappers of the rasterizer (counterpart of
dnsplatter_tpu/ops/rasterize_pallas.py).

Each wrapper keeps the public contract of its Pallas function. A tensor on
the CPU goes to the plain PyTorch version beside it; a CUDA tensor launches
the hand-written kernel of `dnsplatter_torch/csrc` (see the note at the top
of each source) or raises. `LAUNCHES[<wrapper name>]` counts each
wrapper's kernel launches: it goes up by one where the wrapper launches
and nowhere else, and `LAUNCHES.clear()` sets every count to 0.

The plain versions accept tensors on any device, so a check on the card can
hold each kernel against them on the same inputs.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict, Tuple

import torch

from dnsplatter_torch.ops import kernel_build

ALPHA_THRESHOLD = 1.0 / 255.0
MAX_ALPHA = 0.999
TRANSMITTANCE_EPS = 1e-4
MAX_FEATS = 8
GW = 16  # rows of the unpacked (float32) gradient slab

LAUNCHES: Dict[str, int] = collections.Counter()

_VP = ctypes.c_void_p
_I = ctypes.c_int
# C entry of each kernel: (library, symbol, argument types)
_ENTRIES = {
    "expand_segments": ("expand_segments", "dns_expand_segments",
                        [_VP, _VP, _VP, _I, _I, _I, _VP]),
    "forward_tiles": ("forward_tiles", "dns_forward_tiles",
                      [_VP, ctypes.c_longlong, _VP, _VP, _I, _I, _I, _I,
                       _VP, _VP, _VP, _VP]),
    "backward_tiles": ("backward_tiles", "dns_backward_tiles",
                       [_VP, ctypes.c_longlong, _VP, _VP, _I, _I, _I, _I,
                        _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_longlong, _I,
                        _VP]),
    "reduce_segments_bykey": ("reduce_segments_bykey",
                              "dns_reduce_segments_bykey",
                              [_VP, ctypes.c_longlong, _I, _I, _I, _VP,
                               ctypes.c_longlong, _I, _VP]),
    "reduce_segments_bykey_resident": ("reduce_segments_bykey",
                                       "dns_reduce_segments_bykey_resident",
                                       [_I]),
    "reduce_segments_packed": ("reduce_segments_packed",
                               "dns_reduce_segments_packed",
                               [_VP, ctypes.c_longlong, _I, _VP, _I, _I, _VP,
                                ctypes.c_longlong, _VP]),
    "reduce_segments_packed_multi": ("reduce_segments_packed_multi",
                                     "dns_reduce_segments_packed_multi",
                                     [_VP, ctypes.c_longlong,
                                      ctypes.c_longlong, _I, _VP, _I, _I, _I,
                                      _VP, ctypes.c_longlong, _VP]),
    "reduce_segments": ("reduce_segments", "dns_reduce_segments",
                        [_VP, ctypes.c_longlong, _I, _VP, _I, _I, _VP,
                         ctypes.c_longlong, _VP]),
    "cumsum_lanes_i32": ("cumsum_lanes_i32", "dns_cumsum_lanes_i32",
                         [_VP, _VP, _VP, ctypes.c_longlong, _I,
                          ctypes.c_longlong, _VP]),
}
_FNS: Dict[str, ctypes._CFuncPtr] = {}


def _entry(name: str) -> ctypes._CFuncPtr:
    """The kernel's C entry, built, loaded and typed on first use."""
    fn = _FNS.get(name)
    if fn is None:
        lib, sym, argtypes = _ENTRIES[name]
        fn = getattr(kernel_build.load(lib), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def _route(t: torch.Tensor, what: str) -> bool:
    """True: launch the kernel; False: run the plain version. Raises for
    devices that are neither."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain path for {t.device}")


# ---------------------------------------------------------------------------
# expand_segments (rasterize_pallas.py:248 and :315)
# ---------------------------------------------------------------------------


def expand_segments_plain(vals: torch.Tensor, starts: torch.Tensor,
                          out_len: int,
                          out_dtype: torch.dtype = torch.int32
                          ) -> torch.Tensor:
    """out[:, p] = vals[:, g] for starts[g] <= p < starts[g+1]; zero for
    p >= starts[N] (and p < starts[0])."""
    r, n = vals.shape
    v = vals.to(out_dtype)
    if n == 0 or out_len == 0:
        return torch.zeros((r, out_len), dtype=out_dtype, device=vals.device)
    pos = torch.arange(out_len, dtype=starts.dtype, device=vals.device)
    g = torch.searchsorted(starts, pos, right=True) - 1
    live = (g >= 0) & (g < n)
    picked = v[:, g.clamp(0, n - 1)]
    return torch.where(live[None, :], picked, torch.zeros_like(picked))


def _expand_launch(vals: torch.Tensor, starts: torch.Tensor, out_len: int,
                   out_dtype: torch.dtype) -> torch.Tensor:
    if out_dtype not in (torch.int32, torch.float32):
        raise ValueError(f"expand_segments: out_dtype {out_dtype} not in "
                         "(int32, float32)")
    if vals.ndim != 2 or vals.dtype not in (torch.int32, torch.float32):
        raise ValueError("expand_segments: vals must be (R, N) int32 or "
                         f"float32, got {tuple(vals.shape)} {vals.dtype}")
    r, n = vals.shape
    if (starts.dtype != torch.int32 or starts.shape != (n + 1,)
            or starts.device != vals.device):
        raise ValueError("expand_segments: starts must be (N + 1,) int32 on "
                         "the values' device")
    # Values move as raw 32-bit words: convert once to the output type.
    v = vals.to(out_dtype).contiguous()
    s = starts.contiguous()
    out = torch.empty((r, out_len), dtype=out_dtype, device=vals.device)
    _check_rc(_entry("expand_segments")(
        v.data_ptr(), s.data_ptr(), out.data_ptr(), r, n, out_len,
        _stream()), "expand_segments")
    return out


def expand_segments(vals: torch.Tensor, starts: torch.Tensor, out_len: int,
                    out_dtype: torch.dtype = torch.int32,
                    resident_max: int = 1 << 18) -> torch.Tensor:
    """Piecewise-constant expansion (rasterize_pallas.py:248).

    vals (R, N) int32 or float32, starts (N + 1,) int32 ascending. Above
    `resident_max` segments the call goes to `expand_segments_stream`, as
    the Pallas entry does; on the card both launch the same kernel (one CTA
    per chunk of output positions, two searches a chunk). Exact: values are
    copied bit for bit (int32 at any magnitude).
    """
    if vals.shape[1] + 1 > resident_max:
        return expand_segments_stream(vals, starts, out_len, out_dtype)
    if not _route(vals, "expand_segments"):
        return expand_segments_plain(vals, starts, out_len, out_dtype)
    out = _expand_launch(vals, starts, out_len, out_dtype)
    LAUNCHES["expand_segments"] += 1
    return out


def expand_segments_stream(vals: torch.Tensor, starts: torch.Tensor,
                           out_len: int,
                           out_dtype: torch.dtype = torch.int32
                           ) -> torch.Tensor:
    """The large-N entry (rasterize_pallas.py:315 `_expand_segments_stream`):
    same function and kernel; counted on its own."""
    if not _route(vals, "expand_segments_stream"):
        return expand_segments_plain(vals, starts, out_len, out_dtype)
    out = _expand_launch(vals, starts, out_len, out_dtype)
    LAUNCHES["expand_segments_stream"] += 1
    return out


# ---------------------------------------------------------------------------
# forward_tiles (rasterize_pallas.py:527)
# ---------------------------------------------------------------------------


def forward_tiles_plain(payload, tile_starts, tile_counts, n_tiles: int,
                        n_feats: int, tile: int, tiles_x: int, chunk: int):
    """Plain PyTorch version of `forward_tiles` (any device).

    A chunk-synchronous sweep over every tile at once, (T, P, K) per step,
    with the Pallas kernel's arithmetic: K-lane windows aligned down to a
    chunk boundary (head lanes masked by jj < 0), the exclusive
    transmittance as exp of an exclusive log1p prefix sum, and the first
    terminating lane closing the pixel."""
    dev = payload.device
    k = chunk
    p = tile * tile
    f = n_feats
    starts = tile_starts[:n_tiles].long()
    cnt = tile_counts[:n_tiles].long()
    a0 = torch.div(starts, k, rounding_mode="floor") * k
    hoff = starts - a0
    nchunks = torch.where(cnt > 0, (hoff + cnt + k - 1) // k,
                          torch.zeros_like(cnt))
    max_chunks = int(nchunks.max()) if n_tiles else 0

    t_ids = torch.arange(n_tiles, device=dev)
    lid = torch.arange(p, device=dev)
    px = ((t_ids % tiles_x)[:, None] * tile + lid % tile).float() + 0.5
    py = ((t_ids // tiles_x)[:, None] * tile + lid // tile).float() + 0.5
    px, py = px[..., None], py[..., None]  # (T, P, 1)
    jrow = torch.arange(k, device=dev)

    t_run = torch.ones((n_tiles, p, 1), device=dev)
    out = torch.zeros((n_tiles, f, p), device=dev)
    done = torch.zeros((n_tiles, p, 1), dtype=torch.bool, device=dev)
    last = torch.full((n_tiles, p, 1), -1, dtype=torch.int64, device=dev)
    width = payload.shape[1]
    for ci in range(max_chunks):
        if bool(done.all()):
            break
        idx = (a0[:, None] + ci * k + jrow).clamp_max(width - 1)  # (T, K)
        pay = payload[:, idx]  # (PW, T, K)
        jj = ci * k + jrow[None, :] - hoff[:, None]  # (T, K) in-tile index
        in_tile = ((jj >= 0) & (jj < cnt[:, None]))[:, None, :]
        mx, my, ca, cb, cc, op = (pay[i][:, None, :] for i in range(6))
        dx = px - mx
        dy = py - my
        sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        alpha = torch.clamp_max(op * torch.exp(-sigma), MAX_ALPHA)
        hit = (sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD) & in_tile
        alpha_eff = torch.where(hit, alpha, 0.0)
        lg = torch.log1p(-alpha_eff)
        excl = torch.cat([torch.zeros_like(lg[..., :1]),
                          torch.cumsum(lg[..., :-1], dim=2)], dim=2)
        t_prev = t_run * torch.exp(excl)
        next_t = t_prev * (1.0 - alpha_eff)
        would_term = hit & (next_t <= TRANSMITTANCE_EPS)
        first_term = torch.where(would_term, jrow, k).amin(dim=2,
                                                           keepdim=True)
        accept = hit & ~done & (jrow < first_term)
        w = torch.where(accept, alpha * t_prev, 0.0)  # (T, P, K)
        for fi in range(f):
            out[:, fi, :] += (w * pay[6 + fi][:, None, :]).sum(dim=2)
        t_run = t_run * torch.exp(
            torch.where(accept, lg, 0.0).sum(dim=2, keepdim=True))
        done = done | would_term.any(dim=2, keepdim=True)
        last = torch.maximum(
            last, torch.where(accept, jj[:, None, :], -1).amax(
                dim=2, keepdim=True))
    return (out, t_run.reshape(n_tiles, 1, p),
            last.to(torch.int32).reshape(n_tiles, 1, p))


def forward_tiles(
    payload: torch.Tensor,
    tile_starts: torch.Tensor,
    tile_counts: torch.Tensor,
    n_tiles: int,
    n_feats: int,
    tile: int,
    tiles_x: int,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-tile front-to-back compositing (rasterize_pallas.py:527).

    payload (6+F padded, C + K) float32 field-major
    [mx, my, a, b, c, op, f0..]; tile_starts (>= T + 1,) and tile_counts
    (>= T,) int32 dense CSR. Returns (out (T, F, P), t_final (T, 1, P),
    last (T, 1, P) int32 deepest composited in-tile index or -1).
    `chunk` is the Pallas window width; the kernel does not need it.
    """
    if not _route(payload, "forward_tiles"):
        return forward_tiles_plain(payload, tile_starts, tile_counts,
                                   n_tiles, n_feats, tile, tiles_x, chunk)
    p = tile * tile
    if not 1 <= n_feats <= MAX_FEATS:
        raise ValueError(f"forward_tiles: 1 <= n_feats <= {MAX_FEATS}")
    if p > 1024:
        raise ValueError("forward_tiles: tile * tile must be <= 1024")
    if (payload.dtype != torch.float32 or payload.ndim != 2
            or payload.shape[0] < 6 + n_feats or payload.stride(1) != 1):
        raise ValueError("forward_tiles: payload must be a row-contiguous "
                         "(>= 6 + F, C) float32 tensor")
    for name, t, need in (("tile_starts", tile_starts, n_tiles + 1),
                          ("tile_counts", tile_counts, n_tiles)):
        if (t.dtype != torch.int32 or t.ndim != 1 or t.shape[0] < need
                or t.device != payload.device or not t.is_contiguous()):
            raise ValueError(f"forward_tiles: {name} must be a contiguous "
                             f"int32 vector of >= {need} on the payload's "
                             "device")
    dev = payload.device
    out = torch.empty((n_tiles, n_feats, p), dtype=torch.float32, device=dev)
    t_final = torch.empty((n_tiles, 1, p), dtype=torch.float32, device=dev)
    last = torch.empty((n_tiles, 1, p), dtype=torch.int32, device=dev)
    _check_rc(_entry("forward_tiles")(
        payload.data_ptr(), payload.stride(0), tile_starts.data_ptr(),
        tile_counts.data_ptr(), n_tiles, n_feats, tile, tiles_x,
        out.data_ptr(), t_final.data_ptr(), last.data_ptr(), _stream()),
        "forward_tiles")
    LAUNCHES["forward_tiles"] += 1
    return out, t_final, last


# ---------------------------------------------------------------------------
# bf16 pair packing (ops/rasterize.py:1251 `_pack_bf16_2`,
# rasterize_pallas.py:1060 `_rne_bf16_bits`)
# ---------------------------------------------------------------------------


def _rne_bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even float32 -> bf16 bit pattern in the low 16 bits
    of an int32 (sign-extended above; callers mask or shift). Integer
    arithmetic only, as in the kernels."""
    b = x.contiguous().view(torch.int32)
    return (b + 0x7FFF + ((b >> 16) & 1)) >> 16


def pack_bf16_2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two float32 tensors -> one int32 tensor holding
    (bf16(a) << 16) | bf16(b)."""
    return (_rne_bf16_bits(a) << 16) | (_rne_bf16_bits(b) & 0xFFFF)


def unpack_bf16_2(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two bf16 values of each int32 word, as float32 (high half,
    low half): `bits & 0xFFFF0000` and `bits << 16` read as float32."""
    w = w.contiguous()
    hi = (w & -65536).view(torch.float32)
    lo = (w << 16).view(torch.float32)
    return hi, lo


def packed_rows(n_feats: int) -> int:
    """int32 rows that hold the 6 + F per-pair gradient fields."""
    return (6 + n_feats + 1) // 2


# ---------------------------------------------------------------------------
# backward_tiles (rasterize_pallas.py:1289)
# ---------------------------------------------------------------------------


def backward_tiles_plain(payload, tile_starts, tile_counts, g_out, g_alpha,
                         t_final, last, n_tiles: int, n_feats: int,
                         tile: int, tiles_x: int, chunk: int,
                         pack_grads: bool = True,
                         tile_block: int = 256) -> torch.Tensor:
    """Plain PyTorch version of `backward_tiles` (any device).

    The Pallas kernel's arithmetic, back to front over K-lane windows
    aligned down to a chunk boundary: T at entry of pair k is the carried
    transmittance times exp of an inclusive suffix sum of -log1p(-alpha),
    q the strict suffix sum of w * fg plus its carry. Tiles are swept
    `tile_block` at a time, (TB, P, K) per step. Slots past a tile's
    deepest contributor (and lanes the tile does not own) are never
    written, so they keep the slab's integer zeros."""
    dev = payload.device
    k = chunk
    p = tile * tile
    f = n_feats
    nv = 6 + f
    width = payload.shape[1]
    if pack_grads:
        slab = torch.zeros((8, width), dtype=torch.int32, device=dev)
    else:
        slab = torch.zeros((GW, width), dtype=torch.float32, device=dev)
    lid = torch.arange(p, device=dev)
    jrow = torch.arange(k, device=dev)
    for t0 in range(0, n_tiles, tile_block):
        t1 = min(t0 + tile_block, n_tiles)
        nt = t1 - t0
        starts = tile_starts[t0:t1].long()
        cnt = tile_counts[t0:t1].long()
        last_b = last[t0:t1].reshape(nt, p, 1).long()
        ml = last_b.amax(dim=1)[:, 0]  # (TB,) deepest contributor or -1
        a0 = torch.div(starts, k, rounding_mode="floor") * k
        hoff = starts - a0
        nch = torch.where(ml < 0, torch.zeros_like(ml), (hoff + ml + k) // k)
        max_chunks = int(nch.max()) if nt else 0
        if max_chunks == 0:
            continue
        t_ids = torch.arange(t0, t1, device=dev)
        px = ((t_ids % tiles_x)[:, None] * tile + lid % tile).float() + 0.5
        py = ((t_ids // tiles_x)[:, None] * tile + lid // tile).float() + 0.5
        px, py = px[..., None], py[..., None]  # (TB, P, 1)
        go = g_out[t0:t1]  # (TB, F, P)
        ga = g_alpha[t0:t1].reshape(nt, p, 1)
        tf = t_final[t0:t1].reshape(nt, p, 1)
        t_back = tf.clone()
        sacc = torch.zeros_like(tf)
        for ci in range(max_chunks - 1, -1, -1):
            run = (ci < nch)[:, None]  # (TB, 1) tiles that replay this chunk
            idx = (a0[:, None] + ci * k + jrow).clamp_max(width - 1)
            pay = payload[:, idx]  # (PW, TB, K)
            jj = ci * k + jrow[None, :] - hoff[:, None]  # (TB, K)
            owned = (jj >= 0) & (jj < cnt[:, None]) & run
            mx, my, ca, cb, cc, op = (pay[i][:, None, :] for i in range(6))
            dx = px - mx
            dy = py - my
            sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
            ealpha = torch.exp(-sigma)
            alpha = torch.clamp_max(op * ealpha, MAX_ALPHA)
            hit = ((sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD)
                   & owned[:, None, :])
            accept = hit & (jj[:, None, :] <= last_b)
            alpha_eff = torch.where(accept, alpha, 0.0)
            one_m = 1.0 - alpha_eff
            lr = -torch.log1p(-alpha_eff)
            suf = torch.exp(torch.flip(
                torch.cumsum(torch.flip(lr, (2,)), dim=2), (2,)))
            t_entry = t_back * suf
            w = alpha_eff * t_entry  # (TB, P, K)
            feats = pay[6:6 + f]  # (F, TB, K)
            fg = torch.einsum("tfp,ftk->tpk", go, feats)
            wfg = w * fg
            q = torch.flip(torch.cumsum(torch.flip(wfg, (2,)), dim=2),
                           (2,)) - wfg + sacc
            rcp = 1.0 / one_m
            g_alpha_k = torch.where(
                accept, t_entry * fg - q * rcp + ga * tf * rcp, 0.0)
            not_capped = (alpha < MAX_ALPHA).float()
            g_sigma = -alpha * g_alpha_k * not_capped
            rows = [
                (-g_sigma * (ca * dx + cb * dy)).sum(dim=1),
                (-g_sigma * (cc * dy + cb * dx)).sum(dim=1),
                (g_sigma * 0.5 * dx * dx).sum(dim=1),
                (g_sigma * dx * dy).sum(dim=1),
                (g_sigma * 0.5 * dy * dy).sum(dim=1),
                (g_alpha_k * ealpha * not_capped).sum(dim=1),
            ]
            g_feat = torch.einsum("tfp,tpk->tfk", go, w)
            rows += [g_feat[:, i] for i in range(f)]  # each (TB, K)
            # Written: owned lanes up to the tile's deepest contributor.
            write = owned & (jj <= ml[:, None])
            cols = idx[write]
            if pack_grads:
                if len(rows) % 2:
                    rows.append(torch.zeros_like(rows[0]))
                for ri in range(len(rows) // 2):
                    word = pack_bf16_2(rows[2 * ri], rows[2 * ri + 1])
                    slab[ri, cols] = word[write]
            else:
                for ri in range(nv):
                    slab[ri, cols] = rows[ri][write]
                slab[GW - 2, cols] = rows[0][write].abs()
                slab[GW - 1, cols] = rows[1][write].abs()
            t_back = t_back * torch.exp(lr.sum(dim=2, keepdim=True))
            sacc = sacc + wfg.sum(dim=2, keepdim=True)
    return slab


def deepest_first(last: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """The tiles in the order `backward_tiles` starts them: deepest
    contributor first, (n_tiles,) int32. A tile's replay takes time in
    proportion to its depth, so the longest start first and the short ones
    fill the card's tail. Only the schedule changes: each tile's sums are
    the same bits in any order."""
    ml = last.reshape(n_tiles, -1).amax(dim=1)
    return torch.argsort(ml, descending=True, stable=True).to(torch.int32)


def backward_tiles(
    payload: torch.Tensor,
    tile_starts: torch.Tensor,
    tile_counts: torch.Tensor,
    g_out: torch.Tensor,
    g_alpha: torch.Tensor,
    t_final: torch.Tensor,
    last: torch.Tensor,
    n_tiles: int,
    n_feats: int,
    tile: int,
    tiles_x: int,
    chunk: int,
    pack_grads: bool = True,
) -> torch.Tensor:
    """Per-pair gradients of the compositing (rasterize_pallas.py:1289).

    Inputs as `forward_tiles`, plus the cotangents g_out (T, F, P) and
    g_alpha (T, 1, P) and the forward's t_final (T, 1, P) and last
    (T, 1, P) int32. Returns the per-pair slab over the payload's columns,
    fields [dmx, dmy, da, db, dc, dop, df0..], each summed over the tile's
    pixels: with `pack_grads` (8, C) int32 of bf16 pairs
    [mx,my | a,b | c,op | f0,f1 | ...] (an odd count pads with a zero
    field), else (16, C) float32 with |dmx|, |dmy| in rows 14-15. Slots
    past a tile's deepest contributor are integer zeros. The head chunk is
    already in place: there is no separate staged output, as each tile
    owns its slots outright. `chunk` is the Pallas window width; the
    kernel does not need it.
    """
    if not _route(payload, "backward_tiles"):
        return backward_tiles_plain(
            payload, tile_starts, tile_counts, g_out, g_alpha, t_final, last,
            n_tiles, n_feats, tile, tiles_x, chunk, pack_grads)
    p = tile * tile
    if not 1 <= n_feats <= MAX_FEATS:
        raise ValueError(f"backward_tiles: 1 <= n_feats <= {MAX_FEATS}")
    if p > 256 or p % 32:
        raise ValueError("backward_tiles: tile * tile must be a multiple of "
                         "32 and <= 256")
    if (payload.dtype != torch.float32 or payload.ndim != 2
            or payload.shape[0] < 6 + n_feats or payload.stride(1) != 1):
        raise ValueError("backward_tiles: payload must be a row-contiguous "
                         "(>= 6 + F, C) float32 tensor")
    dev = payload.device
    for name, t, need in (("tile_starts", tile_starts, n_tiles + 1),
                          ("tile_counts", tile_counts, n_tiles)):
        if (t.dtype != torch.int32 or t.ndim != 1 or t.shape[0] < need
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"backward_tiles: {name} must be a contiguous "
                             f"int32 vector of >= {need} on the payload's "
                             "device")
    for name, t, shape, dt in (
            ("g_out", g_out, (n_tiles, n_feats, p), torch.float32),
            ("g_alpha", g_alpha, (n_tiles, 1, p), torch.float32),
            ("t_final", t_final, (n_tiles, 1, p), torch.float32),
            ("last", last, (n_tiles, 1, p), torch.int32)):
        # the kernel reads each thread's four pixels as one 16-byte word
        if (t.dtype != dt or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"backward_tiles: {name} must be a contiguous, "
                             f"16-byte aligned {shape} {dt} tensor on the "
                             "payload's device")
    rows, dt = (8, torch.int32) if pack_grads else (GW, torch.float32)
    slab = torch.zeros((rows, payload.shape[1]), dtype=dt, device=dev)
    order = deepest_first(last, n_tiles)
    _check_rc(_entry("backward_tiles")(
        payload.data_ptr(), payload.stride(0), tile_starts.data_ptr(),
        tile_counts.data_ptr(), n_tiles, n_feats, tile, tiles_x,
        g_out.data_ptr(), g_alpha.data_ptr(), t_final.data_ptr(),
        last.data_ptr(), order.data_ptr(), slab.data_ptr(), slab.stride(0),
        1 if pack_grads else 0, _stream()), "backward_tiles")
    LAUNCHES["backward_tiles"] += 1
    return slab


# ---------------------------------------------------------------------------
# reduce_segments_bykey (rasterize_pallas.py:881)
# ---------------------------------------------------------------------------


def reduce_segments_bykey_plain(slab: torch.Tensor, ru: int, n: int
                                ) -> torch.Tensor:
    """Plain PyTorch version of `reduce_segments_bykey` (any device): decode
    the bf16 pairs, then one scatter-add over the keys inside [0, n)."""
    keys = slab[ru].long()
    ok = (keys >= 0) & (keys < n)
    rows = []
    for i in range(ru):
        rows += list(unpack_bf16_2(slab[i]))
    rows += [rows[0].abs(), rows[1].abs()]
    vals = torch.stack(rows)[:, ok]  # (2 ru + 2, live)
    out = torch.zeros((2 * ru + 2, n), dtype=torch.float32,
                      device=slab.device)
    return out.index_add_(1, keys[ok], vals)


def bykey_ids_per_cta(n: int, slots: int) -> int:
    """Ids one CTA of the `reduce_segments_bykey` kernel owns: 512 while a
    grid of 512-id blocks still fills every CTA slot of the card (`slots`:
    SMs x the kernel's resident CTAs a SM), else 256. Each CTA pays two
    searches and a pass over its output block whatever its lanes: many
    waves of small blocks pay that more often (1M ids: 512), while one
    under-filled wave of large blocks leaves SMs idle and walks more tiles
    a CTA (127k ids: 256)."""
    return 512 if -(-n // 512) >= slots else 256


_BYKEY_SLOTS: Dict[Tuple[int, int], int] = {}


def _bykey_slots(device: torch.device, ru: int) -> int:
    """SMs x resident CTAs a SM of the kernel's RU instance, per device."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = (index, ru)
    if key not in _BYKEY_SLOTS:
        with torch.cuda.device(index):
            resident = _entry("reduce_segments_bykey_resident")(ru)
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _BYKEY_SLOTS[key] = sms * resident
    return _BYKEY_SLOTS[key]


def reduce_segments_bykey(slab: torch.Tensor, ru: int, n: int
                          ) -> torch.Tensor:
    """Per-Gaussian sums over a key-sorted packed slab
    (rasterize_pallas.py:881).

    slab (> ru, L) int32: rows 0..ru-1 hold bf16 pairs, row `ru` the
    ascending keys (Gaussian ids). Returns (2 ru + 2, n) float32: the
    decoded field sums per id, then sum |field 0| and sum |field 1|. Keys
    outside [0, n) are never summed; an id without lanes gives exact
    zeros. The Pallas function's coarse block bounds, chunk padding and
    n_pad have no counterpart: each CTA of the kernel owns a block of ids
    (`bykey_ids_per_cta`), finds their lanes with two searches of the key
    row and sums them by a segmented scan in a fixed order. A row stride
    that is a multiple of 4 words lets it load 16 bytes a thread
    (`rasterize._reduce_bykey` pads it); any stride is right.
    """
    if not _route(slab, "reduce_segments_bykey"):
        return reduce_segments_bykey_plain(slab, ru, n)
    if not 1 <= ru <= 7:
        raise ValueError("reduce_segments_bykey: 1 <= ru <= 7")
    if (slab.dtype != torch.int32 or slab.ndim != 2 or slab.shape[0] <= ru
            or slab.stride(1) != 1):
        raise ValueError("reduce_segments_bykey: slab must be a "
                         "row-contiguous (> ru, L) int32 tensor")
    length = slab.shape[1]
    if length >= 2**31 or n >= 2**31:
        raise ValueError("reduce_segments_bykey: sizes must fit int32")
    out = torch.empty((2 * ru + 2, n), dtype=torch.float32,
                      device=slab.device)
    ids = bykey_ids_per_cta(n, _bykey_slots(slab.device, ru))
    _check_rc(_entry("reduce_segments_bykey")(
        slab.data_ptr(), slab.stride(0), length, ru, n, out.data_ptr(),
        out.stride(0), ids, _stream()), "reduce_segments_bykey")
    LAUNCHES["reduce_segments_bykey"] += 1
    return out


# ---------------------------------------------------------------------------
# Boundary reductions: reduce_segments_packed (rasterize_pallas.py:745),
# reduce_segments_packed_multi (:997), reduce_segments (:619)
# ---------------------------------------------------------------------------


def _segment_sum_plain(vals: torch.Tensor, starts: torch.Tensor, n: int,
                       out: torch.Tensor) -> torch.Tensor:
    """out[:, g] += sum(vals[:, starts[g]:starts[g+1]]) as one scatter-add
    over the lanes of [starts[0], starts[n])."""
    st = starts.long()
    lens = (st[1:n + 1] - st[:n]).clamp_min(0)
    ids = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64, device=vals.device), lens)
    lanes = torch.repeat_interleave(st[:n] - (torch.cumsum(lens, 0) - lens),
                                    lens)
    lanes = lanes + torch.arange(ids.shape[0], dtype=torch.int64,
                                 device=vals.device)
    return out.index_add_(1, ids, vals[:, lanes])


def _decode_packed(packed: torch.Tensor) -> torch.Tensor:
    """(PR, C) int32 of bf16 pairs -> (2 PR + 2, C) float32: the decoded
    fields, then |field 0| and |field 1|."""
    rows = []
    for i in range(packed.shape[0]):
        rows += list(unpack_bf16_2(packed[i]))
    rows += [rows[0].abs(), rows[1].abs()]
    return torch.stack(rows)


def _check_boundaries(what: str, starts: torch.Tensor, shape, like) -> None:
    if (starts.dtype != torch.int32 or tuple(starts.shape) != shape
            or starts.device != like.device or not starts.is_contiguous()):
        raise ValueError(f"{what}: boundaries must be a contiguous {shape} "
                         "int32 tensor on the slab's device")


def reduce_segments_packed_plain(packed: torch.Tensor, starts: torch.Tensor,
                                 n: int) -> torch.Tensor:
    """Plain PyTorch version of `reduce_segments_packed` (any device)."""
    out = torch.zeros((2 * packed.shape[0] + 2, n), dtype=torch.float32,
                      device=packed.device)
    return _segment_sum_plain(_decode_packed(packed), starts, n, out)


def reduce_segments_packed(packed: torch.Tensor, starts: torch.Tensor,
                           n: int) -> torch.Tensor:
    """Per-Gaussian sums over contiguous ranges of a bf16-packed slab
    (rasterize_pallas.py:745).

    packed (PR, C) int32 with 1 <= PR <= 7, two bf16 fields per word;
    starts (N + 1,) int32 ascending: Gaussian g owns lanes
    [starts[g], starts[g+1]). Returns (2 PR + 2, n) float32: the decoded
    field sums, then sum |field 0| and sum |field 1|; exact zeros for an
    empty range. Lanes at or past starts[n] are never read, so the Pallas
    function's 512-lane tail, coarse starts, `chunk`, `blk` and n_pad have
    no counterpart.
    """
    if not _route(packed, "reduce_segments_packed"):
        return reduce_segments_packed_plain(packed, starts, n)
    if (packed.dtype != torch.int32 or packed.ndim != 2
            or not 1 <= packed.shape[0] <= 7 or packed.stride(1) != 1):
        raise ValueError("reduce_segments_packed: packed must be a "
                         "row-contiguous (1..7, C) int32 tensor")
    _check_boundaries("reduce_segments_packed", starts, (n + 1,), packed)
    pr, length = packed.shape
    if length >= 2**31:
        raise ValueError("reduce_segments_packed: sizes must fit int32")
    out = torch.empty((2 * pr + 2, n), dtype=torch.float32,
                      device=packed.device)
    _check_rc(_entry("reduce_segments_packed")(
        packed.data_ptr(), packed.stride(0), length, starts.data_ptr(), pr,
        n, out.data_ptr(), out.stride(0), _stream()),
        "reduce_segments_packed")
    LAUNCHES["reduce_segments_packed"] += 1
    return out


def reduce_segments_packed_multi_plain(packed: torch.Tensor,
                                       piece_starts: torch.Tensor, n: int
                                       ) -> torch.Tensor:
    """Plain PyTorch version of `reduce_segments_packed_multi` (any
    device): piece 0's ranges first, then piece 1's, ..."""
    kp, pr, _ = packed.shape
    out = torch.zeros((2 * pr + 2, n), dtype=torch.float32,
                      device=packed.device)
    for j in range(kp):
        _segment_sum_plain(_decode_packed(packed[j]), piece_starts[j], n,
                           out)
    return out


def reduce_segments_packed_multi(packed: torch.Tensor,
                                 piece_starts: torch.Tensor, n: int
                                 ) -> torch.Tensor:
    """Per-Gaussian sums over KP independently sorted slab pieces
    (rasterize_pallas.py:997).

    packed (KP, PR, CP) int32 with 1 <= PR <= 7; piece_starts (KP, N + 1)
    int32, local to each piece: Gaussian g owns lanes
    [piece_starts[j, g], piece_starts[j, g+1]) of piece j. Returns
    (2 PR + 2, n) float32 as `reduce_segments_packed`. Lanes of piece j at
    or past piece_starts[j, n] are never read.
    """
    if not _route(packed, "reduce_segments_packed_multi"):
        return reduce_segments_packed_multi_plain(packed, piece_starts, n)
    if (packed.dtype != torch.int32 or packed.ndim != 3
            or not 1 <= packed.shape[1] <= 7 or packed.stride(2) != 1):
        raise ValueError("reduce_segments_packed_multi: packed must be a "
                         "lane-contiguous (KP, 1..7, CP) int32 tensor")
    kp, pr, cp = packed.shape
    _check_boundaries("reduce_segments_packed_multi", piece_starts,
                      (kp, n + 1), packed)
    if cp >= 2**31:
        raise ValueError("reduce_segments_packed_multi: sizes must fit "
                         "int32")
    out = torch.empty((2 * pr + 2, n), dtype=torch.float32,
                      device=packed.device)
    _check_rc(_entry("reduce_segments_packed_multi")(
        packed.data_ptr(), packed.stride(0), packed.stride(1), cp,
        piece_starts.data_ptr(), kp, pr, n, out.data_ptr(), out.stride(0),
        _stream()), "reduce_segments_packed_multi")
    LAUNCHES["reduce_segments_packed_multi"] += 1
    return out


def reduce_segments_plain(grads: torch.Tensor, starts: torch.Tensor, n: int
                          ) -> torch.Tensor:
    """Plain PyTorch version of `reduce_segments` (any device)."""
    out = torch.zeros((grads.shape[0], n), dtype=torch.float32,
                      device=grads.device)
    return _segment_sum_plain(grads, starts, n, out)


def reduce_segments(grads: torch.Tensor, starts: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """Per-Gaussian float32 sums over contiguous ranges
    (rasterize_pallas.py:619): out[:, g] = sum(grads[:, starts[g]:
    starts[g+1]]).

    grads (GW, C) float32 with 1 <= GW <= 16, starts (N + 1,) int32
    ascending. Returns (GW, n); exact zeros for an empty range. Each CTA
    of the kernel owns a block of 128 ids and sums their lanes by a
    segmented scan in one fixed order (not lane order), so the result is
    the same from run to run. A 16-byte aligned slab with a row stride
    that is a multiple of 4 words lets it load 16 bytes a thread; any
    stride is right.
    """
    if not _route(grads, "reduce_segments"):
        return reduce_segments_plain(grads, starts, n)
    if (grads.dtype != torch.float32 or grads.ndim != 2
            or not 1 <= grads.shape[0] <= GW or grads.stride(1) != 1):
        raise ValueError("reduce_segments: grads must be a row-contiguous "
                         f"(1..{GW}, C) float32 tensor")
    _check_boundaries("reduce_segments", starts, (n + 1,), grads)
    gw, length = grads.shape
    if length >= 2**31 - 2048:
        raise ValueError("reduce_segments: sizes must fit int32")
    out = torch.empty((gw, n), dtype=torch.float32, device=grads.device)
    _check_rc(_entry("reduce_segments")(
        grads.data_ptr(), grads.stride(0), length, starts.data_ptr(), gw, n,
        out.data_ptr(), out.stride(0), _stream()), "reduce_segments")
    LAUNCHES["reduce_segments"] += 1
    return out


# ---------------------------------------------------------------------------
# cumsum_lanes_i32 (rasterize_pallas.py:117)
# ---------------------------------------------------------------------------

# lanes per tile of csrc/cumsum_lanes_i32.cu (12 strips of 256 threads x 4)
CUMSUM_TILE = 12288


def cumsum_scratch_words(rows: int, c: int, aligned: bool,
                         tile: int = CUMSUM_TILE) -> int:
    """64-bit scratch words the `cumsum_lanes_i32` kernel needs: its tile
    counter, then one status word per tile of each row (`tile` lanes a
    tile). `aligned`: every row starts on a 16-byte boundary (the table
    16-byte aligned and c % 4 == 0); otherwise a row is tiled from the
    boundary below its start and needs up to 3 lanes more."""
    tiles = -(-(c + (0 if aligned else 3)) // tile)
    return 1 + rows * tiles


def cumsum_lanes_i32_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `cumsum_lanes_i32` (any device)."""
    return torch.cumsum(x, dim=1, dtype=torch.int32)


def cumsum_lanes_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum along the last axis of an (R, C) table
    (rasterize_pallas.py:117). Integer adds: exact at any magnitude,
    wrapping like int32 (the Pallas kernel, a float32 matrix product, is
    exact only below 2^24). One pass over 12,288-lane tiles with decoupled
    look-back; the scratch it needs is zeroed on the stream first."""
    if not _route(x, "cumsum_lanes_i32"):
        return cumsum_lanes_i32_plain(x)
    if x.dtype != torch.int32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError("cumsum_lanes_i32: x must be a contiguous (R, C) "
                         "int32 tensor")
    r, c = x.shape
    if r > 65535:
        raise ValueError("cumsum_lanes_i32: at most 65535 rows")
    out = torch.empty_like(x)
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0 \
        and c % 4 == 0
    words = cumsum_scratch_words(r, c, aligned)
    if words - 1 >= 2**31:
        raise ValueError("cumsum_lanes_i32: more than 2^31 tiles")
    scratch = torch.zeros(words, dtype=torch.int64, device=x.device)
    _check_rc(_entry("cumsum_lanes_i32")(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), words, r, c,
        _stream()), "cumsum_lanes_i32")
    LAUNCHES["cumsum_lanes_i32"] += 1
    return out
