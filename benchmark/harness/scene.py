"""The benchmark's synthetic indoor scene, made from `--seed` on the device.

A scene is a room (or a flat of rooms) of axis-aligned rectangles: floor,
ceiling, walls, partitions with door gaps and furniture boxes standing on
the floor, all sized by the configuration file. From it the benchmark makes,
in plain torch and independently of the program under test:

* the training targets of every frame of the camera path: an rgb image of
  the surfaces' procedural textures, and the exact z-depth and camera-frame
  normals by ray-casting the rectangles;
* a "trained" Gaussian state standing in for one: means area-sampled on the
  surfaces with isotropic noise, discs flat along the surface normal with a
  side scale from the expected 3-nearest-neighbour spacing, one opacity,
  SH DC from the texture and the higher SH bands drawn around zero.

The geometry and the camera poses follow from the configuration alone; the
seed draws the textures, the Gaussians and where on the loop serving
starts. So every seed asks for the same work, in another order.

World frame: +y up, the floor at y = 0. Cameras are OpenGL c2w matrices
(+x right, +y up, -z forward), rendering is OpenCV, pixel centres sit at
integer + 0.5 and depth is camera z: the conventions of the program's data.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

SH_C0 = 0.28209479177387814
GL_TO_CV = (1.0, -1.0, -1.0)


@dataclasses.dataclass(frozen=True)
class Rects:
    """S planar rectangles: corner `o`, edge vectors `u`, `v`, unit normal
    `n` (pointing to the side from which the surface is seen), all (S, 3)."""

    o: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    n: torch.Tensor

    @property
    def count(self) -> int:
        return self.o.shape[0]

    def areas(self) -> torch.Tensor:
        return torch.linalg.norm(torch.linalg.cross(self.u, self.v), dim=-1)


def _box_faces(x0, y0, z0, x1, y1, z1, inward: bool, skip_bottom: bool,
               skip_top: bool) -> List[Tuple]:
    """The faces of an axis-aligned box as (o, u, v, n) tuples; normals
    point out of the box, or into it for a room."""
    s = -1.0 if inward else 1.0
    dx, dy, dz = x1 - x0, y1 - y0, z1 - z0
    faces = [
        ((x0, y0, z0), (0, dy, 0), (0, 0, dz), (-s, 0, 0)),  # x = x0
        ((x1, y0, z0), (0, dy, 0), (0, 0, dz), (s, 0, 0)),  # x = x1
        ((x0, y0, z0), (dx, 0, 0), (0, dy, 0), (0, 0, -s)),  # z = z0
        ((x0, y0, z1), (dx, 0, 0), (0, dy, 0), (0, 0, s)),  # z = z1
    ]
    if not skip_bottom:
        faces.append(((x0, y0, z0), (dx, 0, 0), (0, 0, dz), (0, -s, 0)))
    if not skip_top:
        faces.append(((x0, y1, z0), (dx, 0, 0), (0, 0, dz), (0, s, 0)))
    return faces


def build_rects(room: Dict, device) -> Rects:
    """The scene's rectangles from the configuration's `room`: `size`
    [x, y(height), z], `boxes` [[x0, z0, x1, z1, height], ...] standing on
    the floor, and `partitions` [[x0, z0, x1, z1], ...] of full height."""
    lx, ly, lz = room["size"]
    faces = _box_faces(0.0, 0.0, 0.0, lx, ly, lz, inward=True,
                       skip_bottom=False, skip_top=False)
    for x0, z0, x1, z1, h in room.get("boxes", []):
        faces += _box_faces(x0, 0.0, z0, x1, min(h, ly), z1, inward=False,
                            skip_bottom=True, skip_top=h >= ly)
    for x0, z0, x1, z1 in room.get("partitions", []):
        faces += _box_faces(x0, 0.0, z0, x1, ly, z1, inward=False,
                            skip_bottom=True, skip_top=True)
    t = torch.tensor(faces, dtype=torch.float32, device=device)
    return Rects(o=t[:, 0], u=t[:, 1], v=t[:, 2], n=t[:, 3])


@dataclasses.dataclass(frozen=True)
class Textures:
    """Per-rectangle procedural texture: base colour (S, 3) and three
    sinusoid products per channel, frequencies (S, 3, 2) in rad/m,
    phases (S, 3, 2), amplitudes (S, 3)."""

    base: torch.Tensor
    freq: torch.Tensor
    phase: torch.Tensor
    amp: torch.Tensor


def draw_textures(count: int, gen: torch.Generator, device) -> Textures:
    def u(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    return Textures(base=0.15 + 0.7 * u(count, 3),
                    freq=1.5 + 10.0 * u(count, 3, 2),
                    phase=2.0 * math.pi * u(count, 3, 2),
                    amp=0.1 + 0.15 * u(count, 3))


def texture_rgb(tex: Textures, rects: Rects, rid: torch.Tensor,
                p: torch.Tensor) -> torch.Tensor:
    """(P, 3) colour of points `p` (P, 3) on rectangles `rid` (P,)."""
    rel = p - rects.o[rid]
    uu = rects.u[rid]
    vv = rects.v[rid]
    a = (rel * uu).sum(-1) / torch.linalg.norm(uu, dim=-1)
    b = (rel * vv).sum(-1) / torch.linalg.norm(vv, dim=-1)
    fr = tex.freq[rid]
    ph = tex.phase[rid]
    pattern = (torch.sin(fr[..., 0] * a[:, None] + ph[..., 0])
               * torch.sin(fr[..., 1] * b[:, None] + ph[..., 1]))
    rgb = tex.base[rid] * (1.0 + tex.amp[rid] * 2.0 * pattern)
    return rgb.clamp(0.02, 0.98)


# -- cameras -------------------------------------------------------------


def _look_at(eye: torch.Tensor, fwd: torch.Tensor) -> torch.Tensor:
    """OpenGL (4, 4) c2w at `eye` looking along `fwd`, world up +y."""
    fwd = fwd / torch.linalg.norm(fwd)
    up = torch.tensor([0.0, 1.0, 0.0], device=eye.device)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.norm(right)
    true_up = torch.linalg.cross(right, fwd)
    c2w = torch.eye(4, device=eye.device)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -fwd
    c2w[:3, 3] = eye
    return c2w


def path_pose(path: Dict, j: int, frames: int, device) -> torch.Tensor:
    """Pose `j` of `frames` on the handheld-like loop: an ellipse of
    `radii` around `center` (x, z), eye height within `height` [lo, hi],
    the view along the loop turned outward by a slowly swinging yaw and
    pitched a little down, so the camera looks across into the room."""
    th = 2.0 * math.pi * j / frames
    cx, cz = path["center"]
    rx, rz = path["radii"]
    lo, hi = path["height"]
    eye = torch.tensor([cx + rx * math.cos(th),
                        0.5 * (lo + hi) + 0.5 * (hi - lo) * math.sin(3 * th),
                        cz + rz * math.sin(th)], device=device)
    tx, tz = -rx * math.sin(th), rz * math.cos(th)
    yaw = 0.35 + 0.45 * math.sin(2.0 * th)
    c, s = math.cos(yaw), math.sin(yaw)
    fx, fz = c * tx + s * tz, -s * tx + c * tz
    norm = math.hypot(fx, fz)
    pitch = -0.15 + 0.1 * math.sin(5.0 * th)
    fwd = torch.tensor([math.cos(pitch) * fx / norm, math.sin(pitch),
                        math.cos(pitch) * fz / norm], device=device)
    return _look_at(eye, fwd)


def serving_order(frames: int, seed: int) -> List[int]:
    """The poses in the order this seed serves them: from a pose drawn
    from the seed, round the loop by a stride near frames / golden ratio^2
    that shares no factor with `frames`. Every seed serves the same poses,
    and any stretch of the order samples the whole loop evenly, so a
    window that ends inside an epoch sees the same mix of views whatever
    the seed."""
    target = frames * (3.0 - math.sqrt(5.0)) / 2.0
    stride = min((k for k in range(1, frames + 1)
                  if math.gcd(k, frames) == 1),
                 key=lambda k: (abs(k - target), k))
    gen = torch.Generator().manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    off = int(torch.randint(frames, (1,), generator=gen))
    return [(off + k * stride) % frames for k in range(frames)]


# -- ray casting ---------------------------------------------------------


def cast(rects: Rects, eye: torch.Tensor, dirs: torch.Tensor,
         group: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """First hit of rays eye + t * dirs (P, 3), t > 0: (t (P,), rect id
    (P,), -1 for none). The rectangles are axis-aligned: each lies in the
    plane x_k = o_k and spans o + [0, |u|] e_i + [0, |v|] e_j, so a hit
    needs one division and two range tests. `group` rectangles at a
    time."""
    p = dirs.shape[0]
    best_t = torch.full((p,), float("inf"), device=dirs.device)
    best_id = torch.full((p,), -1, dtype=torch.int64, device=dirs.device)
    k_ax = rects.n.abs().argmax(-1)
    i_ax = rects.u.abs().argmax(-1)
    j_ax = rects.v.abs().argmax(-1)
    lu = rects.u.abs().amax(-1)
    lv = rects.v.abs().amax(-1)
    ar = torch.arange(rects.count, device=dirs.device)
    ok_, oi, oj = rects.o[ar, k_ax], rects.o[ar, i_ax], rects.o[ar, j_ax]
    for g0 in range(0, rects.count, group):
        sl = slice(g0, min(g0 + group, rects.count))
        dk = dirs[:, k_ax[sl]]  # (P, G)
        t = (ok_[sl] - eye[k_ax[sl]])[None] / torch.where(
            dk.abs() > 1e-9, dk, torch.full_like(dk, 1e-9))
        a = eye[i_ax[sl]][None] + t * dirs[:, i_ax[sl]] - oi[sl][None]
        b = eye[j_ax[sl]][None] + t * dirs[:, j_ax[sl]] - oj[sl][None]
        inside = ((t > 1e-4) & (dk.abs() > 1e-9) & (a >= 0)
                  & (a <= lu[sl][None]) & (b >= 0) & (b <= lv[sl][None]))
        t = torch.where(inside, t, float("inf"))
        tg, ig = t.min(dim=1)
        better = tg < best_t
        best_t = torch.where(better, tg, best_t)
        best_id = torch.where(better, ig + g0, best_id)
    return best_t, best_id


def camera_rays(c2w: torch.Tensor, fx: float, fy: float, cx: float,
                cy: float, width: int, height: int) -> torch.Tensor:
    """(H*W, 3) world directions whose camera-frame z is 1 (OpenCV), so
    the ray parameter of a hit is its z-depth."""
    dev = c2w.device
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    d_cv = torch.stack([(xg - cx) / fx, (yg - cy) / fy,
                        torch.ones_like(xg)], -1).reshape(-1, 3)
    flip = torch.tensor(GL_TO_CV, device=dev)
    rot_cv = c2w[:3, :3] * flip[None, :]
    return d_cv @ rot_cv.T


def render_targets(rects: Rects, tex: Textures, c2w: torch.Tensor,
                   intr: Dict) -> Dict[str, torch.Tensor]:
    """The frame's targets: image (H, W, 3), sensor_depth (H, W, 1) and
    normal (H, W, 3), the camera-frame (OpenGL) unit normal facing the
    camera mapped to [0, 1]."""
    w, h = intr["width"], intr["height"]
    dirs = camera_rays(c2w, intr["fx"], intr["fy"], intr["cx"], intr["cy"],
                       w, h)
    eye = c2w[:3, 3]
    t, rid = cast(rects, eye, dirs)
    if bool((rid < 0).any()):
        raise ValueError("a camera ray leaves the scene: the path or the "
                         "room is mis-sized")
    p = eye[None] + t[:, None] * dirs
    rgb = texture_rgb(tex, rects, rid, p)
    n = rects.n[rid]
    n = torch.where(((n * dirs).sum(-1, keepdim=True) > 0), -n, n)
    n_cam = n @ c2w[:3, :3]  # R^T n, row-wise
    return {"image": rgb.reshape(h, w, 3),
            "sensor_depth": t.reshape(h, w, 1),
            "normal": ((n_cam + 1.0) * 0.5).reshape(h, w, 3)}


# -- the Gaussian state ----------------------------------------------------

# E[distance to the k-th nearest neighbour] of a planar Poisson process of
# density rho is Gamma(k + 1/2) / (Gamma(k) sqrt(pi rho)); the mean over
# k = 1..3 is this constant over sqrt(pi rho).
KNN3_CONST = (math.gamma(1.5) / math.gamma(1) + math.gamma(2.5) / math.gamma(2)
              + math.gamma(3.5) / math.gamma(3)) / 3.0


def _quat_from_rot(r: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotations -> (N, 4) wxyz quaternions (Shepperd)."""
    m00, m11, m22 = r[:, 0, 0], r[:, 1, 1], r[:, 2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack([
        torch.stack([1 + tr, r[:, 2, 1] - r[:, 1, 2], r[:, 0, 2] - r[:, 2, 0],
                     r[:, 1, 0] - r[:, 0, 1]], -1),
        torch.stack([r[:, 2, 1] - r[:, 1, 2], 1 + m00 - m11 - m22,
                     r[:, 0, 1] + r[:, 1, 0], r[:, 0, 2] + r[:, 2, 0]], -1),
        torch.stack([r[:, 0, 2] - r[:, 2, 0], r[:, 0, 1] + r[:, 1, 0],
                     1 - m00 + m11 - m22, r[:, 1, 2] + r[:, 2, 1]], -1),
        torch.stack([r[:, 1, 0] - r[:, 0, 1], r[:, 0, 2] + r[:, 2, 0],
                     r[:, 1, 2] + r[:, 2, 1], 1 - m00 - m11 + m22], -1),
    ], 1)  # (N, 4 candidates, 4)
    pick = torch.stack([tr, m00, m11, m22], -1).argmax(-1)
    q = cands[torch.arange(r.shape[0], device=r.device), pick]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def make_gaussians(cfg: Dict, rects: Rects, tex: Textures,
                   gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """The "trained" state at the configuration's capacity: a dict of the
    program's checkpoint fields (means, scales (log), quats (wxyz),
    features_dc, features_rest, opacities (logit), normals) and `alive`,
    float32 on the device. Dead slots carry the program's fills."""
    dev = rects.o.device
    n = int(cfg["num_gaussians"])
    cap = int(cfg["capacity"])
    areas = rects.areas()
    rid = torch.multinomial(areas, n, replacement=True, generator=gen)
    ab = torch.rand(n, 2, generator=gen, device=dev)
    surf = (rects.o[rid] + ab[:, :1] * rects.u[rid]
            + ab[:, 1:] * rects.v[rid])
    rgb = texture_rgb(tex, rects, rid, surf)
    means = surf + cfg["noise_m"] * torch.randn(n, 3, generator=gen,
                                                device=dev)
    rho = n / float(areas.sum())
    side = KNN3_CONST / math.sqrt(math.pi * rho)
    # the disc's third axis lies along the normal, the first two in the
    # plane at a random angle
    nrm = rects.n[rid]
    ref = torch.where(nrm[:, 1:2].abs() > 0.9,
                      torch.tensor([1.0, 0.0, 0.0], device=dev),
                      torch.tensor([0.0, 1.0, 0.0], device=dev))
    e1 = torch.linalg.cross(ref, nrm)
    e1 = e1 / torch.linalg.norm(e1, dim=-1, keepdim=True)
    e2 = torch.linalg.cross(nrm, e1)
    ang = 2.0 * math.pi * torch.rand(n, generator=gen, device=dev)
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a1 = c * e1 + s * e2
    a2 = -s * e1 + c * e2
    quats = _quat_from_rot(torch.stack([a1, a2, nrm], -1))
    log_side = math.log(side)
    scales = torch.tensor([log_side, log_side, log_side - math.log(10.0)],
                          device=dev).expand(n, 3)
    b = (int(cfg["sh_degree"]) + 1) ** 2
    rest = cfg["sh_rest_std"] * torch.randn(n, b - 1, 3, generator=gen,
                                            device=dev)
    op = float(cfg["opacity"])

    def pad(x, fill):
        out = torch.full((cap,) + tuple(x.shape[1:]), fill,
                         dtype=torch.float32, device=dev)
        out[:n] = x
        return out

    quats_p = pad(quats, 0.0)
    quats_p[n:, 0] = 1.0
    alive = torch.zeros(cap, device=dev)
    alive[:n] = 1.0
    return {
        "means": pad(means, 0.0),
        "scales": pad(scales, -10.0),
        "quats": quats_p,
        "features_dc": pad((rgb - 0.5) / SH_C0, 0.0),
        "features_rest": pad(rest, 0.0),
        "opacities": pad(torch.full((n,), math.log(op / (1.0 - op)),
                                    device=dev), -15.0),
        "normals": pad(nrm, 0.0),
        "alive": alive,
        "colors": rgb,
    }


@dataclasses.dataclass
class Scene:
    """Everything the seed makes: the intrinsics, the c2w of each served
    frame (in serving order), the frames' targets (or None where a mix
    needs none) and the Gaussian state."""

    intr: Dict
    c2ws: List[torch.Tensor]
    poses: List[int]
    targets: List[Dict[str, torch.Tensor]] | None
    state: Dict[str, torch.Tensor]
    rects: Rects
    textures: Textures


def intrinsics(cfg: Dict) -> Dict:
    w, h = int(cfg["width"]), int(cfg["height"])
    return {"width": w, "height": h, "fx": float(cfg["focal"]),
            "fy": float(cfg["focal"]), "cx": w / 2.0, "cy": h / 2.0}


def make_scene(cfg: Dict, seed: int, device, with_targets: bool) -> Scene:
    """The cell's scene for `seed` on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    rects = build_rects(cfg["room"], device)
    tex = draw_textures(rects.count, gen, device)
    frames = int(cfg["frames"])
    poses = serving_order(frames, int(seed))
    c2ws = [path_pose(cfg["path"], j, frames, device) for j in poses]
    intr = intrinsics(cfg)
    targets = None
    if with_targets:
        targets = [render_targets(rects, tex, c2w, intr) for c2w in c2ws]
    state = make_gaussians(cfg, rects, tex, gen)
    return Scene(intr=intr, c2ws=c2ws, poses=poses, targets=targets,
                 state=state, rects=rects, textures=tex)
