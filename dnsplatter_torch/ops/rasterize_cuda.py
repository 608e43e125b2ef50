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
    _check_rc(_entry("expand_segments")(v.data_ptr(), s.data_ptr(), out.data_ptr(), r, n, out_len,
                 _stream()), "expand_segments")
    return out


def expand_segments(vals: torch.Tensor, starts: torch.Tensor, out_len: int,
                    out_dtype: torch.dtype = torch.int32,
                    resident_max: int = 1 << 18) -> torch.Tensor:
    """Piecewise-constant expansion (rasterize_pallas.py:248).

    vals (R, N) int32 or float32, starts (N + 1,) int32 ascending. Above
    `resident_max` segments the call goes to `expand_segments_stream`, as
    the Pallas entry does; on the card both launch the same kernel. Exact:
    values are copied bit for bit (int32 at any magnitude).
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
