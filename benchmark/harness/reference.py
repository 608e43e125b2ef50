"""The plain reference: DN-Splatter's render, loss and Adam step in plain
torch, written from the published equations (3D Gaussian splatting's EWA
projection and front-to-back compositing, splatfacto's loss and optimizer,
DN-Splatter's depth and normal terms) and from the configuration's stated
settings. It imports nothing of the program and takes nothing the program
made: the benchmark hands it the state it generated and the targets it
ray-cast.

Compositing follows the 3DGS CUDA rasterizer: alpha = min(0.999,
o * exp(-sigma)), skipped below 1/255 or for sigma < 0; a pixel ends when
the next transmittance would drop to 1e-4 or below, and the Gaussian that
trips it is not composited. A Gaussian reaches the tiles of its screen box
(the radius at which its alpha falls to 1/255, at most 3 sigma), and each
tile composites its Gaussians in the order of the configuration's
`sort_scheme` "depthq": camera depth quantized over the frame's depth
range, ties by index.

Tiles are composited in blocks as dense (tiles, pixels, pairs) tensors, so
the reference fits at the timed sizes. The backward runs the blocks again
under autograd with the loss's image gradient. With `lowp` the payload and
the compositing run in bfloat16: the control that has to fail the check.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
T_EPS = 1e-4
TILE = 16
FIELDS = ("means", "scales", "quats", "features_dc", "features_rest",
          "opacities", "normals")
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
# Elements of a (tiles, pixels, pairs) block.
BLOCK_ELEMS = 1 << 25


@dataclasses.dataclass(frozen=True)
class Cam:
    c2w: torch.Tensor  # (4, 4) OpenGL camera-to-world
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def tiles_x(self) -> int:
        return -(-self.width // TILE)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // TILE)


def viewmat(c2w: torch.Tensor) -> torch.Tensor:
    """OpenCV world-to-camera (4, 4) of an OpenGL c2w."""
    flip = torch.tensor([1.0, -1.0, -1.0], device=c2w.device)
    rot = c2w[:3, :3] * flip[None, :]
    out = torch.eye(4, device=c2w.device)
    out[:3, :3] = rot.T
    out[:3, 3] = -rot.T @ c2w[:3, 3]
    return out


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def sh_colors(coeffs: torch.Tensor, dirs: torch.Tensor, degree: int
              ) -> torch.Tensor:
    """(N, K, 3) coefficients at unit directions (N, 3): rgb + 0.5,
    clamped at 0 (degrees 0-3)."""
    x, y, z = dirs.unbind(-1)
    basis = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        basis += [SH_C2[0] * x * y, SH_C2[1] * y * z,
                  SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * x * z,
                  SH_C2[4] * (xx - yy)]
    if degree >= 3:
        basis += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
                  SH_C3[2] * y * (4 * zz - xx - yy),
                  SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                  SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                  SH_C3[6] * x * (xx - 3 * yy)]
    b = torch.stack(basis, -1)  # (N, nb)
    rgb = (b[..., None] * coeffs[:, :b.shape[-1]]).sum(1)
    return torch.clamp_min(rgb + 0.5, 0.0)


@dataclasses.dataclass
class Screen:
    """Per-Gaussian screen-space payload of one camera."""

    means2d: torch.Tensor  # (N, 2)
    conics: torch.Tensor  # (N, 3) a, b, c: sigma = .5(a dx2 + c dy2) + b dx dy
    opac: torch.Tensor  # (N,)
    feats: torch.Tensor  # (N, 7) rgb, camera normal, depth
    depth: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,) bool
    rxy: torch.Tensor  # (N, 2) screen box half-extents, pixels
    radius: torch.Tensor  # (N,) screen radius, pixels (0 where not valid)


def project(p: Dict[str, torch.Tensor], alive: torch.Tensor, cam: Cam,
            sh_degree: int, eps2d: float = 0.3, near: float = 0.01
            ) -> Screen:
    """EWA projection (the local affine approximation of the perspective
    map, clamped at 1.3x the field of view), the 2D low-pass `eps2d`, SH
    colours and the per-Gaussian normal (the flattest axis, facing the
    camera, in the OpenGL camera frame)."""
    vm = viewmat(cam.c2w)
    rot_wc, t_wc = vm[:3, :3], vm[:3, 3]
    means = p["means"]
    mc = means @ rot_wc.T + t_wc
    tz = mc[:, 2]
    tzs = torch.where(tz.abs() < 1e-8, torch.full_like(tz, 1e-8), tz)
    r = quat_to_rot(p["quats"])
    s = torch.exp(p["scales"])
    m = rot_wc[None] @ (r * s[:, None, :])  # W R S
    cov = m @ m.transpose(1, 2)
    limx = 1.3 * 0.5 * cam.width / cam.fx
    limy = 1.3 * 0.5 * cam.height / cam.fy
    tx = torch.clamp(mc[:, 0] / tzs, -limx, limx) * tzs
    ty = torch.clamp(mc[:, 1] / tzs, -limy, limy) * tzs
    zero = torch.zeros_like(tz)
    j = torch.stack([
        torch.stack([cam.fx / tzs, zero, -cam.fx * tx / (tzs * tzs)], -1),
        torch.stack([zero, cam.fy / tzs, -cam.fy * ty / (tzs * tzs)], -1),
    ], 1)  # (N, 2, 3)
    c2 = j @ cov @ j.transpose(1, 2)
    a = c2[:, 0, 0] + eps2d
    b = c2[:, 0, 1]
    c = c2[:, 1, 1] + eps2d
    det = a * c - b * b
    dets = torch.where(det <= 0.0, torch.full_like(det, 1e-12), det)
    conics = torch.stack([c / dets, -b / dets, a / dets], -1)
    opac = torch.sigmoid(p["opacities"])
    with torch.no_grad():
        mid = 0.5 * (a + c)
        vmax = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.01))
        sb = torch.clamp(torch.log(torch.clamp_min(255.0 * opac, 1e-12)),
                         0.0, 4.5)
        rad = torch.ceil(torch.sqrt(2 * sb * vmax.clamp_min(0)))
        rx = torch.ceil(torch.sqrt(2 * sb * a.clamp_min(0)))
        ry = torch.ceil(torch.sqrt(2 * sb * c.clamp_min(0)))
    m2 = torch.stack([cam.fx * mc[:, 0] / tzs + cam.cx,
                      cam.fy * mc[:, 1] / tzs + cam.cy], -1)
    with torch.no_grad():
        on = ((m2[:, 0] + rx > 0) & (m2[:, 0] - rx < cam.width)
              & (m2[:, 1] + ry > 0) & (m2[:, 1] - ry < cam.height))
        valid = ((tz > near) & (tz < 1e10) & (det > 0) & (rad > 0) & on
                 & (alive > 0.5))
    eye = cam.c2w[:3, 3]
    dirs = means - eye
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(
        1e-12)
    coeffs = torch.cat([p["features_dc"][:, None], p["features_rest"]], 1)
    rgb = sh_colors(coeffs, dirs, sh_degree)
    axis = torch.argmin(p["scales"], dim=-1)
    n = r[torch.arange(r.shape[0], device=r.device), :, axis]
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
    view = eye - means.detach()
    view = view / torch.linalg.norm(view, dim=-1, keepdim=True).clamp_min(
        1e-12)
    n = torch.where((n * view).sum(-1, keepdim=True) < 0, -n, n)
    n_cam = n @ cam.c2w[:3, :3]
    feats = torch.cat([rgb, n_cam, tz[:, None]], -1)
    rxy = torch.where(valid[:, None], torch.stack([rx, ry], -1), 0.0)
    return Screen(means2d=m2, conics=conics, opac=opac, feats=feats,
                  depth=tz, valid=valid, rxy=rxy,
                  radius=torch.where(valid, rad, 0.0))


@torch.no_grad()
def pair_counts(p: Dict[str, torch.Tensor], alive: torch.Tensor,
                cams: List[Cam], eps2d: float = 0.3, near: float = 0.01
                ) -> List[int]:
    """The number of (Gaussian, tile) pairs each camera lists: every valid
    Gaussian in every tile of its screen box, as `project` and `bin_tiles`
    find them, with the world covariance formed once for all cameras."""
    r = quat_to_rot(p["quats"]) * torch.exp(p["scales"])[:, None, :]
    cov = r @ r.transpose(1, 2)  # (N, 3, 3) world covariance
    opac = torch.sigmoid(p["opacities"])
    sb = torch.clamp(torch.log(torch.clamp_min(255.0 * opac, 1e-12)), 0.0,
                     4.5)
    out = []
    for cam in cams:
        vm = viewmat(cam.c2w)
        w = vm[:3, :3]
        mc = p["means"] @ w.T + vm[:3, 3]
        tz = mc[:, 2]
        tzs = torch.where(tz.abs() < 1e-8, torch.full_like(tz, 1e-8), tz)
        limx = 1.3 * 0.5 * cam.width / cam.fx
        limy = 1.3 * 0.5 * cam.height / cam.fy
        tx = torch.clamp(mc[:, 0] / tzs, -limx, limx) * tzs
        ty = torch.clamp(mc[:, 1] / tzs, -limy, limy) * tzs
        zero = torch.zeros_like(tz)
        j = torch.stack([
            torch.stack([cam.fx / tzs, zero, -cam.fx * tx / (tzs * tzs)], -1),
            torch.stack([zero, cam.fy / tzs, -cam.fy * ty / (tzs * tzs)], -1),
        ], 1) @ w  # (N, 2, 3)
        c2 = j @ cov @ j.transpose(1, 2)
        a = c2[:, 0, 0] + eps2d
        c = c2[:, 1, 1] + eps2d
        det = a * c - c2[:, 0, 1] ** 2
        mid = 0.5 * (a + c)
        vmax = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.01))
        rad = torch.ceil(torch.sqrt(2 * sb * vmax.clamp_min(0)))
        rx = torch.ceil(torch.sqrt(2 * sb * a.clamp_min(0)))
        ry = torch.ceil(torch.sqrt(2 * sb * c.clamp_min(0)))
        mx = cam.fx * mc[:, 0] / tzs + cam.cx
        my = cam.fy * mc[:, 1] / tzs + cam.cy
        valid = ((tz > near) & (tz < 1e10) & (det > 0) & (rad > 0)
                 & (mx + rx > 0) & (mx - rx < cam.width) & (my + ry > 0)
                 & (my - ry < cam.height) & (alive > 0.5))

        def tidx(v, hi, plus):
            f = torch.nan_to_num(torch.floor(v / TILE), nan=0.0)
            return (f.clamp(-2, hi + 2).long() + plus).clamp(0, hi)

        w_t = (tidx(mx + rx, cam.tiles_x, 1)
               - tidx(mx - rx, cam.tiles_x, 0)).clamp_min(0)
        h_t = (tidx(my + ry, cam.tiles_y, 1)
               - tidx(my - ry, cam.tiles_y, 0)).clamp_min(0)
        out.append(int(torch.where(valid, w_t * h_t, 0).sum()))
    return out


@dataclasses.dataclass
class Bins:
    """Tile pair lists: tile t's Gaussians are ids[starts[t]:starts[t+1]]
    in compositing order."""

    ids: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor


@torch.no_grad()
def bin_tiles(sc: Screen, cam: Cam, tile_block: int = 32) -> Bins:
    """Each valid Gaussian in every tile of its screen box, each tile's
    list in depthq order."""
    dev = sc.means2d.device
    tx, ty = cam.tiles_x, cam.tiles_y
    m, r = sc.means2d, sc.rxy

    def tidx(v, hi, plus):
        f = torch.nan_to_num(torch.floor(v / TILE), nan=0.0).clamp(-2, hi + 2)
        return (f.long() + plus).clamp(0, hi)

    x0 = tidx(m[:, 0] - r[:, 0], tx, 0)
    x1 = tidx(m[:, 0] + r[:, 0], tx, 1)
    y0 = tidx(m[:, 1] - r[:, 1], ty, 0)
    y1 = tidx(m[:, 1] + r[:, 1], ty, 1)
    w = (x1 - x0).clamp_min(0)
    h = (y1 - y0).clamp_min(0)
    cnt = torch.where(sc.valid, w * h, 0)
    gid = torch.repeat_interleave(torch.arange(cnt.shape[0], device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    k = torch.arange(gid.shape[0], device=dev) - first[gid]
    tile = (x0[gid] + k % w[gid]) + (y0[gid] + k // w[gid]) * tx
    # depthq: depth quantized over the valid depth range to the bits that
    # the tile index of the padded tile grid leaves in 32
    t_pad = -(-(tx * ty) // tile_block) * tile_block
    qbits = 32 - int(t_pad + 1).bit_length()
    qmax = (1 << qbits) - 1
    d = sc.depth.float()
    dmin = torch.where(sc.valid, d, torch.inf).amin()
    dmax = torch.where(sc.valid, d, -torch.inf).amax()
    span = torch.clamp_min(dmax - dmin, 1e-12)
    q = torch.clamp(torch.round((d - dmin) / span * (qmax - 1)), 0,
                    qmax - 1).long()
    key = (tile * (qmax + 1) + q[gid]) * (cnt.shape[0] + 1) + gid
    order = torch.argsort(key)
    ids = gid[order]
    counts = torch.bincount(tile, minlength=tx * ty)
    starts = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                        torch.cumsum(counts, 0)])
    return Bins(ids=ids, starts=starts, counts=counts)


def _blocks(counts: torch.Tensor) -> List[Tuple[torch.Tensor, int]]:
    """Tiles grouped by pair count (descending) into blocks of at most
    BLOCK_ELEMS (tile, pixel, pair) elements: [(tile ids, longest list)]."""
    order = torch.argsort(counts, descending=True)
    cnt = counts[order].tolist()
    out, i = [], 0
    per = TILE * TILE
    while i < len(cnt):
        longest = max(cnt[i], 1)
        nb = max(1, BLOCK_ELEMS // (per * longest))
        out.append((order[i:i + nb], longest))
        i += nb
    return out


def _composite(sc_m2, sc_con, sc_op, sc_feat, bins: Bins, tiles, longest,
               cam: Cam, lowp: bool, stats: bool, taps=None):
    """One block: (img (B, P, 7), alpha (B, P), work dict or None). With
    `taps` (a list), the block's gathered (tile, pair) means2d, which
    retains its gradient, is appended to it with the pairs' Gaussian ids
    and list mask."""
    dev = sc_m2.device
    j = torch.arange(longest, device=dev)
    cnt = bins.counts[tiles]
    inlist = j[None] < cnt[:, None]  # (B, L)
    pos = (bins.starts[tiles][:, None] + j[None]).clamp_max(
        max(bins.ids.shape[0] - 1, 0))
    gi = torch.where(inlist, bins.ids[pos] if bins.ids.numel() else
                     torch.zeros_like(pos), 0)
    m2, con = sc_m2[gi], sc_con[gi]  # (B, L, 2), (B, L, 3)
    op, feat = sc_op[gi], sc_feat[gi]
    if taps is not None:
        m2.retain_grad()
        taps.append((m2, gi, inlist))
    if lowp:
        m2, con, op, feat = (t.to(torch.bfloat16).float()
                             for t in (m2, con, op, feat))
    yy, xx = _tile_pixels(tiles, cam)
    pxf = xx.float() + 0.5  # (B, P) pixel centres
    pyf = yy.float() + 0.5
    dx = pxf[:, :, None] - m2[:, None, :, 0]  # (B, P, L)
    dy = pyf[:, :, None] - m2[:, None, :, 1]
    sig = (0.5 * (con[:, None, :, 0] * dx * dx + con[:, None, :, 2] * dy * dy)
           + con[:, None, :, 1] * dx * dy)
    alpha = torch.clamp_max(op[:, None, :] * torch.exp(-sig), ALPHA_MAX)
    inpix = ((pxf < cam.width) & (pyf < cam.height))[:, :, None]
    hit = (sig >= 0) & (alpha >= ALPHA_MIN) & inlist[:, None, :] & inpix
    a = torch.where(hit, alpha, torch.zeros_like(alpha))
    if lowp:
        a = a.to(torch.bfloat16)
    t_incl = torch.cumprod(1.0 - a, dim=-1)
    accept = hit & (t_incl > T_EPS)
    t_excl = torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]],
                       -1)
    wgt = torch.where(accept, a * t_excl, torch.zeros_like(a)).float()
    img = torch.einsum("bpl,blf->bpf", wgt, feat)
    keep = torch.where(accept, 1.0 - a, torch.ones_like(a))
    alpha_px = 1.0 - torch.prod(keep, dim=-1).float()
    work = None
    if stats:
        with torch.no_grad():
            term = hit & ~accept
            first_term = torch.where(term, j[None, None], longest).amin(-1)
            evaluated = torch.minimum(first_term + 1, cnt[:, None])
            evaluated = torch.where(inpix[..., 0], evaluated, 0)
            last = torch.where(accept, j[None, None], -1).amax(-1)
            work = {"fwd_visits": int(evaluated.sum()),
                    "fwd_needed": int(evaluated.amax(-1).sum()),
                    "accepted": int(accept.sum()),
                    "bwd_visits": int((last + 1).sum()),
                    "bwd_replayed": int((last.amax(-1) + 1).sum())}
    return img, alpha_px, work


def _tile_pixels(tiles: torch.Tensor, cam: Cam):
    """(rows, columns), each (B, 256), of the pixels of tiles `tiles`."""
    ty = torch.div(tiles, cam.tiles_x, rounding_mode="floor")
    tx = tiles % cam.tiles_x
    py, px = torch.meshgrid(torch.arange(TILE, device=tiles.device),
                            torch.arange(TILE, device=tiles.device),
                            indexing="ij")
    return (ty[:, None] * TILE + py.reshape(1, -1),
            tx[:, None] * TILE + px.reshape(1, -1))


def rasterize(sc: Screen, bins: Bins, cam: Cam, lowp: bool = False,
              stats: bool = False):
    """(img (H, W, 7), alpha (H, W, 1), work totals or None), no grad."""
    dev = sc.means2d.device
    th, tw = cam.tiles_y * TILE, cam.tiles_x * TILE
    img = torch.zeros(th, tw, 7, device=dev)
    alp = torch.zeros(th, tw, 1, device=dev)
    work = {} if stats else None
    with torch.no_grad():
        for tiles, longest in _blocks(bins.counts):
            i, a, w = _composite(sc.means2d, sc.conics, sc.opac, sc.feats,
                                 bins, tiles, longest, cam, lowp, stats)
            yy, xx = _tile_pixels(tiles, cam)
            img[yy, xx] = i
            alp[yy, xx, 0] = a
            if stats:
                for k, v in w.items():
                    work[k] = work.get(k, 0) + v
    return (img[:cam.height, :cam.width], alp[:cam.height, :cam.width],
            work)


def rasterize_backward(sc: Screen, bins: Bins, cam: Cam, g_img, g_alpha,
                       lowp: bool = False):
    """Gradients of sum(img * g_img) + sum(alpha * g_alpha) with respect to
    (means2d, conics, opac, feats), block by block, and the absolute
    screen-space gradient (N, 2) that densification reads: each (tile,
    Gaussian) pair's means2d gradient summed over the tile's pixels, its
    absolute value per axis summed over the Gaussian's tiles (the
    program's stated statistic, its JAX package's "absolute per-tile
    means2d gradient accumulation")."""
    leaves = [sc.means2d.detach().requires_grad_(True),
              sc.conics.detach().requires_grad_(True),
              sc.opac.detach().requires_grad_(True),
              sc.feats.detach().requires_grad_(True)]
    th, tw = cam.tiles_y * TILE, cam.tiles_x * TILE
    gi = torch.zeros(th, tw, 7, device=g_img.device)
    ga = torch.zeros(th, tw, 1, device=g_img.device)
    gi[:cam.height, :cam.width] = g_img
    ga[:cam.height, :cam.width] = g_alpha
    absgrad = torch.zeros_like(sc.means2d)
    for tiles, longest in _blocks(bins.counts):
        taps = []
        img, alpha, _ = _composite(*leaves, bins, tiles, longest, cam, lowp,
                                   False, taps)
        yy, xx = _tile_pixels(tiles, cam)
        s = (img * gi[yy, xx]).sum() + (alpha * ga[yy, xx, 0]).sum()
        s.backward()
        for m2, ids, inlist in taps:
            if m2.grad is not None:
                g = torch.where(inlist[..., None], m2.grad.abs(), 0.0)
                absgrad.index_add_(0, ids.reshape(-1), g.reshape(-1, 2))
    return [x.grad if x.grad is not None else torch.zeros_like(x)
            for x in leaves], absgrad


# -- image-space outputs and the DN-Splatter loss ---------------------------


def finish(img: torch.Tensor, alpha: torch.Tensor, bg: torch.Tensor
           ) -> Dict[str, torch.Tensor]:
    """rgb over the background (clipped to [0, 1]), expected depth (the
    largest accumulated depth where nothing is seen) and the unit normal
    mapped to [0, 1]."""
    rgb = img[..., :3] + (1.0 - alpha) * bg
    rgb = torch.minimum(torch.maximum(rgb, torch.zeros_like(rgb)),
                        torch.ones_like(rgb))
    acc = img[..., 6:7]
    depth = torch.where(alpha > 0, acc / torch.maximum(
        alpha, torch.full_like(alpha, 1e-10)), acc.max().detach())
    n = img[..., 3:6]
    n = n * torch.rsqrt((n * n).sum(-1, keepdim=True) + 1e-12)
    return {"rgb": rgb, "depth": depth, "normal": (n + 1.0) * 0.5}


def _mmean(x, mask):
    m = torch.broadcast_to(mask, x.shape).to(x.dtype)
    return (x * m).sum() / torch.clamp_min(m.sum(), 1e-10)


def _ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean SSIM, 11x11 Gaussian window (sigma 1.5), valid region, as sums
    of shifted slices in float32."""
    k = 11
    g = torch.exp(-((torch.arange(k, device=x.device) - 5.0) ** 2) / 4.5)
    g = g / g.sum()
    x, y = x.permute(2, 0, 1), y.permute(2, 0, 1)

    def blur(t):
        h, w = t.shape[-2] - k + 1, t.shape[-1] - k + 1
        rows = sum(g[i] * t[..., i:i + h, :] for i in range(k))
        return sum(g[i] * rows[..., i:i + w] for i in range(k))

    mx, my = blur(x), blur(y)
    z = torch.zeros((), device=x.device)
    vx = torch.maximum(blur(x * x) - mx * mx, z)
    vy = torch.maximum(blur(y * y) - my * my, z)
    cxy = blur(x * y) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return torch.mean((2 * mx * my + c1) * (2 * cxy + c2)
                      / ((mx * mx + my * my + c1) * (vx + vy + c2)))


def dn_loss(out: Dict[str, torch.Tensor], tgt: Dict[str, torch.Tensor],
            scales: torch.Tensor, alive: torch.Tensor, model: Dict
            ) -> torch.Tensor:
    """Splatfacto's photometric loss (1 - l) L1 + l (1 - SSIM), l =
    `ssim_lambda`; DN-Splatter's edge-aware log-L1 depth loss on pixels of
    sensor depth above `depth_tolerance`, times (1 + depth_lambda); the
    normal L1 against the prior plus its total variation; and the mean of
    each live Gaussian's smallest scale."""
    gt = tgt["image"]
    lam = model["ssim_lambda"]
    loss = ((1 - lam) * torch.mean(torch.abs(gt - out["rgb"]))
            + lam * (1 - _ssim(out["rgb"], gt)))
    if model["use_depth_loss"]:
        g = tgt["sensor_depth"]
        valid = g > model["depth_tolerance"]
        img = torch.clamp_min(gt, 10.0 / 255.0)
        wx = torch.exp(-torch.mean(torch.abs(img[:, :-1] - img[:, 1:]), -1,
                                   keepdim=True))
        wy = torch.exp(-torch.mean(torch.abs(img[:-1] - img[1:]), -1,
                                   keepdim=True))
        ll = torch.log1p(torch.abs(out["depth"] - g))
        dl = (_mmean(wx * ll[:, :-1], valid[:, :-1])
              + _mmean(wy * ll[:-1], valid[:-1]))
        loss = loss + dl * (1 + model["depth_lambda"])
    if model["use_normal_loss"]:
        pn = out["normal"]
        loss = loss + torch.mean(torch.abs(pn - tgt["normal"]))
        if model["use_normal_tv_loss"]:
            loss = loss + (torch.mean(torch.abs(pn[:, :-1] - pn[:, 1:]))
                           + torch.mean(torch.abs(pn[:-1] - pn[1:])))
    smin = torch.amin(torch.exp(scales), dim=-1)
    return loss + _mmean(smin, alive > 0.5)


# -- one training step ----------------------------------------------------


def render(p, alive, cam: Cam, bg, sh_degree: int, lowp: bool = False,
           stats: bool = False):
    """Forward only: (outputs dict, work totals or None)."""
    with torch.no_grad():
        sc = project(p, alive, cam, sh_degree)
        bins = bin_tiles(sc, cam)
        img, alp, work = rasterize(sc, bins, cam, lowp, stats)
    return finish(img, alp, bg), work, bins


def loss_and_grads(p: Dict[str, torch.Tensor], alive, cam: Cam, tgt, bg,
                   sh_degree: int, model: Dict, lowp: bool = False):
    """(loss, {field: gradient}, the frame's Screen, its absolute
    screen-space gradient (N, 2)) of one frame."""
    leaves = {f: p[f].detach().requires_grad_(True) for f in FIELDS}
    sc = project(leaves, alive, cam, sh_degree)
    bins = bin_tiles(sc, cam)
    with torch.no_grad():
        img, alp, _ = rasterize(sc, bins, cam, lowp)
    img = img.detach().requires_grad_(True)
    alp = alp.detach().requires_grad_(True)
    loss = dn_loss(finish(img, alp, bg), tgt, leaves["scales"], alive, model)
    g_img, g_alp, g_scales = torch.autograd.grad(
        loss, [img, alp, leaves["scales"]])
    gs, absgrad = rasterize_backward(sc, bins, cam, g_img, g_alp, lowp)
    torch.autograd.backward([sc.means2d, sc.conics, sc.opac, sc.feats], gs)
    grads = {f: (leaves[f].grad if leaves[f].grad is not None
                 else torch.zeros_like(leaves[f])) for f in FIELDS}
    grads["scales"] = grads["scales"] + g_scales
    return loss.detach(), grads, sc, absgrad


@dataclasses.dataclass
class Adam:
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    acc: Dict[str, torch.Tensor]
    count: Dict[str, int]


def adam_init(p) -> Adam:
    z = {f: torch.zeros_like(p[f]) for f in FIELDS}
    return Adam(mu=dict(z), nu={f: torch.zeros_like(p[f]) for f in FIELDS},
                acc={f: torch.zeros_like(p[f]) for f in FIELDS},
                count={f: 0 for f in FIELDS})


@torch.no_grad()
def adam_step(p, grads, st: Adam, step: int, optim: Dict):
    """Splatfacto's per-group Adam: the means' rate decays exponentially
    from lr_means to lr_means_final over max_steps; the colour groups sum
    their gradients over a window and update on every window-th step."""
    frac = min(max(step / optim["max_steps"], 0.0), 1.0)
    lrs = {f: optim[f"lr_{f}"] for f in FIELDS if f != "means"}
    lrs["means"] = optim["lr_means"] * (optim["lr_means_final"]
                                        / optim["lr_means"]) ** frac
    win = {f: optim.get(f"accum_{f}", 1) for f in FIELDS}
    b1, b2, eps = optim["b1"], optim["b2"], optim["eps"]
    new = {}
    for f in FIELDS:
        st.acc[f] = st.acc[f] + grads[f]
        if win[f] > 1 and (step + 1) % win[f] != 0:
            new[f] = p[f]
            continue
        st.count[f] += 1
        c = st.count[f]
        st.mu[f] = b1 * st.mu[f] + (1 - b1) * st.acc[f]
        st.nu[f] = b2 * st.nu[f] + (1 - b2) * st.acc[f] * st.acc[f]
        mhat = st.mu[f] / (1 - b1 ** c)
        vhat = st.nu[f] / (1 - b2 ** c)
        new[f] = p[f] - lrs[f] * mhat / (torch.sqrt(vhat) + eps)
        st.acc[f] = torch.zeros_like(st.acc[f])
    return new


# -- refinement (splatfacto's adaptive density control) --------------------


@dataclasses.dataclass
class Stats:
    """Densification statistics since the last event: the sum of each
    Gaussian's absolute screen-space gradient norm over the frames it was
    visible in, their number, and its largest screen radius over the
    frame's larger side."""

    grad_sum: torch.Tensor
    vis: torch.Tensor
    max_2d: torch.Tensor


def stats_init(n: int, device) -> Stats:
    return Stats(*(torch.zeros(n, device=device) for _ in range(3)))


@torch.no_grad()
def stats_add(st: Stats, sc: Screen, absgrad: torch.Tensor, max_size: float
              ) -> Stats:
    vis = sc.valid.float()
    return Stats(grad_sum=st.grad_sum + torch.linalg.norm(absgrad, dim=-1)
                 * vis, vis=st.vis + vis,
                 max_2d=torch.maximum(st.max_2d, sc.radius / max_size))


@dataclasses.dataclass
class Event:
    """What a refinement event did to the rows of the state: `removed`,
    the rows alive before it that died or whose content it rewrote;
    `added`, how many rows are alive after it that were dead or
    rewritten; `added_sum`, those rows' means and linear scales summed
    (6 float64)."""

    removed: torch.Tensor
    added: int
    added_sum: torch.Tensor


@torch.no_grad()
def refine(p, alive, st: Stats, step: int, max_size: float, frames: int,
           model: Dict) -> Event:
    """The refinement that follows step `step` (the number of steps
    taken), by splatfacto's schedule: past `warmup_length`, every
    `refine_every` steps, densify and cull while the step is short of
    `stop_split_at` and more than `frames + refine_every` past an opacity
    reset. A cull alone (after `stop_split_at`, where the configuration
    keeps culling) and the opacity reset (every `reset_alpha_every`
    events) fall on no checked step of the mixes, and are refused.

    Densify: a live Gaussian whose average screen gradient (over its
    visible frames, times half the frame's larger side) passes
    `densify_grad_thresh` is split in `n_split_samples` children at 1/1.6
    its scale where its largest scale passes `densify_size_thresh` (or,
    before `stop_screen_size_at`, its screen size `split_screen_size`), and
    duplicated otherwise. Cull: opacity under `cull_alpha_thresh`, and past
    the first reset a scale over `cull_scale_thresh` (or, before
    `stop_screen_size_at`, a screen size over `cull_screen_size`); split
    parents die. New rows fill the dead slots, duplicates first, then each
    parent's children, in index order, as far as the slots go. The
    children's places are random draws about the parent, so `added_sum`
    counts them at the parent's mean."""
    m = model
    live = alive > 0.5
    none = Event(removed=torch.zeros_like(live), added=0,
                 added_sum=torch.zeros(6, dtype=torch.float64,
                                       device=alive.device))
    if step <= m["warmup_length"] or step % m["refine_every"]:
        return none
    reset_every = m["reset_alpha_every"] * m["refine_every"]
    early = step < m["stop_split_at"]
    if ((not early and m["continue_cull_post_densification"])
            or (early and step % reset_every == m["refine_every"])):
        raise NotImplementedError(
            f"step {step}: the reference runs densify-and-cull events only, "
            "not a cull alone or an opacity reset")
    if not (early and step % reset_every > frames + m["refine_every"]):
        return none
    sizes3 = torch.exp(p["scales"])
    sizes = sizes3.amax(-1)
    screen = step < m["stop_screen_size_at"]
    avg = st.grad_sum / st.vis.clamp_min(1.0) * 0.5 * max_size
    high = (avg > m["densify_grad_thresh"]) & live
    splits = sizes > m["densify_size_thresh"]
    if screen:
        splits = splits | (st.max_2d > m["split_screen_size"])
    splits = splits & high
    dups = (sizes <= m["densify_size_thresh"]) & high
    culls = torch.sigmoid(p["opacities"]) < m["cull_alpha_thresh"]
    if step > reset_every:
        big = sizes > m["cull_scale_thresh"]
        if screen:
            big = big | (st.max_2d > m["cull_screen_size"])
        culls = culls | big
    removed = (culls & live) | splits
    n_free = int((~(live & ~removed)).sum())
    n_dups = int(dups.sum())
    dup_ok = dups & (torch.cumsum(dups.long(), 0) - 1 < n_free)
    added = int(dup_ok.sum())
    added_sum = torch.cat([p["means"], sizes3], -1).double()[dup_ok].sum(0)
    child = torch.cat([p["means"], sizes3 / 1.6], -1).double()
    rank = torch.cumsum(splits.long(), 0) - 1
    k = int(m["n_split_samples"])
    for s in range(k):
        ok = splits & (n_dups + rank * k + s < n_free)
        added += int(ok.sum())
        added_sum = added_sum + child[ok].sum(0)
    return Event(removed=removed, added=added, added_sum=added_sum)


def train_steps(p0, alive, cams: List[Cam], targets, bgs, step0: int,
                sh_degree: int, model: Dict, optim: Dict, frames: int,
                lowp: bool = False):
    """The reference's run of len(cams) steps from state p0 (Adam and the
    densification statistics at zero): (losses, the first step's gradients
    as Adam receives them, the parameters after the last step, the
    refinement event that follows it)."""
    p = {f: p0[f].clone() for f in FIELDS}
    st = adam_init(p)
    stats = stats_init(alive.shape[0], alive.device)
    losses, first = [], None
    am = alive > 0.5
    for k, (cam, tgt, bg) in enumerate(zip(cams, targets, bgs)):
        loss, g, sc, absgrad = loss_and_grads(p, alive, cam, tgt, bg,
                                              sh_degree, model, lowp)
        g = {f: g[f] * am.reshape((-1,) + (1,) * (g[f].ndim - 1))
             for f in FIELDS}
        if first is None:
            first = g
        p = adam_step(p, g, st, step0 + k, optim)
        stats = stats_add(stats, sc, absgrad,
                          float(max(cam.width, cam.height)))
        del sc, absgrad
        losses.append(float(loss))
    last = cams[-1]
    ev = refine(p, alive, stats, step0 + len(cams),
                float(max(last.width, last.height)), frames, model)
    return losses, first, p, ev
