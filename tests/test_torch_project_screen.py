"""The screen-space entry `rasterize_cuda.project_screen` on the CPU.

A CPU tensor takes the plain version, `project_screen_plain`, which is the
per-Gaussian part of `render.screen_space` moved out of it: its outputs and
the gradients of means, quats, scales, opacities and colors must be
bit-equal to the code `screen_space` ran before the entry existed, and
`screen_space` must give what it gave then. The kernel pair is held against
the plain version on the card in `tests/test_torch_cuda.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dnsplatter_torch.data.synthetic import make_gt_gaussians, ring_cameras
from dnsplatter_torch.models.gaussians import GaussianParams
from dnsplatter_torch.ops import rasterize_cuda as rc
from dnsplatter_torch.ops import render
from dnsplatter_torch.ops.normals import (
    per_gaussian_normals,
    world_to_camera_normals,
)
from dnsplatter_torch.ops.projection import project_gaussians
from dnsplatter_torch.utils import profiling

torch.set_num_threads(1)

N, WIDTH, HEIGHT = 320, 96, 72
MODES = ("classic", "antialiased")
# rows given a special role (see `_inputs`)
CASES = ("random", "argmin_ties", "facing_flip", "culled", "dead_rows",
         "zero_quats")


def _inputs(case: str, seed: int = 0):
    """A camera, the five differentiable inputs (means, quats, log-scales,
    opacity logits, colors) and alive, with the case's rows planted in the
    first 40: all three log-scales equal or the lower two tied; normals
    perpendicular to the view direction (the flip's dot product exactly 0)
    and facing away; rows behind the camera and off the image; alive zeros;
    zero quaternions."""
    rng = np.random.default_rng(seed)
    gt, alive = make_gt_gaussians(rng, N, extent=1.2, device="cpu")
    cam = ring_cameras(1, width=WIDTH, img_height=HEIGHT, focal=80.0,
                       device="cpu")[0]
    means, quats = gt.means.clone(), gt.quats.clone()
    scales = gt.scales.clone()
    quats = quats * torch.as_tensor(rng.uniform(0.5, 2.0, (N, 1)),
                                    dtype=torch.float32)
    alive = alive.clone()
    pos = cam.c2w[:3, 3]
    if case == "argmin_ties":
        scales[:20] = scales[:20, :1]
        scales[20:40, 1] = scales[20:40, 0]
    elif case == "facing_flip":
        quats[:40] = torch.tensor([1.0, 0.0, 0.0, 0.0])
        scales[:40] = torch.tensor([-3.0, -3.0, -5.0])
        # the flattest axis is world z; seen along x: dots = 0
        means[:20] = pos + torch.tensor([0.5, 0.0, 0.0])
        # seen from -z: the normal faces away and flips
        means[20:40] = pos + torch.tensor([0.0, 0.0, 0.5])
    elif case == "culled":
        means[:20] = pos + 0.3 * (pos / torch.linalg.norm(pos))  # behind
        means[20:40] = torch.tensor([40.0, 0.0, 0.0])  # off the image
    elif case == "dead_rows":
        alive[:40] = 0.0
    elif case == "zero_quats":
        quats[:40] = 0.0
    colors = torch.rand(N, 3, generator=torch.Generator().manual_seed(seed))
    return cam, [means, quats, scales, gt.opacities.clone(), colors], alive


def _old_screen_rows(means, quats, scales, opacities, colors, alive, cam,
                     mode, near_plane=0.01, far_plane=1e10):
    """What `screen_space` computed after the colours before the entry
    existed, verbatim."""
    viewmat = cam.viewmat()
    opac_raw = torch.sigmoid(opacities)
    proj = project_gaussians(
        means, quats, torch.exp(scales), viewmat, cam.fx, cam.fy, cam.cx,
        cam.cy, cam.width, cam.height, near_plane=near_plane,
        far_plane=far_plane, opacities=opac_raw,
    )
    valid = proj.valid & (alive > 0.5)
    opac = opac_raw
    if mode == "antialiased":
        opac = opac * proj.compensations
    cam_pos = cam.position()
    n_world = per_gaussian_normals(scales, quats, means, cam_pos)
    n_cam = world_to_camera_normals(n_world, cam.c2w)
    feats = torch.cat([colors, n_cam, proj.depths[:, None]], dim=-1)
    return (proj.means2d, proj.conics, proj.depths, opac, feats, valid,
            proj.radii_xy, proj.radii)


def _incoming(outs, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(o.shape, generator=g) for o in outs[:5]]


def _assert_bit_equal(got, want, what):
    """Equal bits (float32 compared as int32 words: the sign of a zero and
    a NaN's payload count)."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want), f"{what}: {int((got != want).sum())} differ"


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", MODES)
def test_project_screen_plain_bit_equal_to_the_old_code(mode, case):
    cam, arrays, alive = _inputs(case)
    a = [t.clone().requires_grad_(True) for t in arrays]
    b = [t.clone().requires_grad_(True) for t in arrays]
    before = dict(rc.LAUNCHES)
    got = rc.project_screen(*a, alive, cam.viewmat(), cam.c2w, cam.fx,
                            cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                            mode)
    want = _old_screen_rows(*b, alive, cam, mode)
    assert dict(rc.LAUNCHES) == before  # nothing launched on the CPU
    names = ("means2d", "conics", "depths", "opacities", "features", "valid",
             "radii_xy", "radii")
    for name, x, y in zip(names, got, want):
        _assert_bit_equal(x.detach(), y.detach(), name)
    gin = _incoming(want, seed=len(case))
    ga = torch.autograd.grad(got[:5], a, gin, allow_unused=True)
    gb = torch.autograd.grad(want[:5], b, gin, allow_unused=True)
    for name, x, y in zip(("means", "quats", "scales", "opacities", "colors"),
                          ga, gb):
        assert x is not None and y is not None, name
        _assert_bit_equal(x, y, f"d_{name}")
    if case == "dead_rows":
        assert not bool(got[5][:40].any())
    if case == "culled":
        assert not bool(got[5][:40].any()) and bool(got[5][40:].any())
        assert torch.all(got[7][:40] == 0) and torch.all(got[6][:40] == 0)


@pytest.mark.parametrize("mode", MODES)
def test_project_screen_plain_camera_gradients_bit_equal(mode):
    """Pose optimisation: c2w takes a gradient through viewmat and the
    normals' frame change, as before."""
    cam, arrays, alive = _inputs("facing_flip", seed=2)

    def run(fn):
        c2w = cam.c2w.clone().requires_grad_(True)
        c = dataclasses.replace(cam, c2w=c2w)
        if fn is None:
            outs = _old_screen_rows(*arrays, alive, c, mode)
        else:
            outs = fn(*arrays, alive, c.viewmat(), c.c2w, c.fx, c.fy, c.cx,
                      c.cy, c.width, c.height, mode)
        # the opacities do not depend on the camera in "classic"
        pairs = [(o, w) for o, w in zip(outs[:5], _incoming(outs, 9))
                 if o.requires_grad]
        return torch.autograd.grad([o for o, _ in pairs], c2w,
                                   [w for _, w in pairs])[0]

    _assert_bit_equal(run(rc.project_screen), run(None), "d_c2w")


def _old_screen_space(params, alive, camera, sh_degree_to_use=3,
                      rasterize_mode="classic", near_plane=0.01,
                      far_plane=1e10, crop_box=None):
    """`render.screen_space` as it was before the entry existed, verbatim
    (the counters aside)."""
    viewmat = camera.viewmat()
    opac_raw = torch.sigmoid(params.opacities)
    proj = project_gaussians(
        params.means, params.quats, torch.exp(params.scales), viewmat,
        camera.fx, camera.fy, camera.cx, camera.cy, camera.width,
        camera.height, near_plane=near_plane, far_plane=far_plane,
        opacities=opac_raw,
    )
    valid = proj.valid & (alive > 0.5)
    if crop_box is not None:
        lo, hi = crop_box
        inside = torch.all(
            (params.means >= lo[None]) & (params.means <= hi[None]), dim=-1)
        valid = valid & inside
    opac = opac_raw
    if rasterize_mode == "antialiased":
        opac = opac * proj.compensations
    cam_pos = camera.position()
    colors = rc.sh_colors(sh_degree_to_use, params.features_dc,
                          params.features_rest,
                          params.means - cam_pos[None, :])
    n_world = per_gaussian_normals(params.scales, params.quats, params.means,
                                   cam_pos)
    n_cam = world_to_camera_normals(n_world, camera.c2w)
    feats = torch.cat([colors, n_cam, proj.depths[:, None]], dim=-1)
    return render.ScreenSpace(
        means2d=proj.means2d, conics=proj.conics, depths=proj.depths,
        opacities=opac, features=feats, valid=valid, radii_xy=proj.radii_xy,
        radii=proj.radii)


@pytest.mark.parametrize("crop", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_screen_space_unchanged_on_cpu(mode, crop):
    cam, arrays, alive = _inputs("argmin_ties", seed=4)
    means, quats, scales, opac, _ = arrays
    g = torch.Generator().manual_seed(5)
    params = GaussianParams(
        means=means, scales=scales, quats=quats,
        features_dc=torch.randn(N, 3, generator=g),
        features_rest=0.3 * torch.randn(N, 15, 3, generator=g),
        opacities=opac, normals=torch.zeros(N, 3))
    crop_box = (torch.tensor([-1.0, -1.0, -1.0]),
                torch.tensor([0.8, 1.0, 0.9])) if crop else None

    def run(fn):
        leaves = GaussianParams(**{
            f: getattr(params, f).clone().requires_grad_(True)
            for f in params.__dataclass_fields__})
        ss = fn(leaves, alive, cam, 3, mode, crop_box=crop_box)
        diff = [ss.means2d, ss.conics, ss.opacities, ss.features]
        names = ("means", "quats", "scales", "opacities", "features_dc",
                 "features_rest")
        grads = torch.autograd.grad(diff, [getattr(leaves, f) for f in names],
                                    _incoming(diff + [ss.depths], 6)[:4])
        return ss, grads

    with profiling.recording():
        got, got_grads = run(render.screen_space)
    counters = profiling.record()["counters"]
    want, want_grads = run(_old_screen_space)
    for f in dataclasses.fields(render.ScreenSpace):
        _assert_bit_equal(getattr(got, f.name).detach(),
                          getattr(want, f.name).detach(), f.name)
    for x, y in zip(got_grads, want_grads):
        _assert_bit_equal(x, y, "gradient")
    assert counters["project.rows"] == N
    assert counters["project.visible"] == int(want.valid.sum())
    assert not any(k.startswith("launch.") for k in counters)


def _check_args(**change):
    """Valid arguments of `_project_check` on the CPU, with `change`."""
    cam, arrays, alive = _inputs("random")
    args = dict(zip(("means", "quats", "scales", "opacities", "colors"),
                    arrays))
    args.update(alive=alive, viewmat=cam.viewmat(), c2w=cam.c2w,
                intrinsics=(cam.fx, cam.fy, cam.cx, cam.cy),
                width=WIDTH, height=HEIGHT)
    args.update(change)
    return args


_BAD = {
    "float64 means": lambda a: {"means": a["means"].double()},
    "float16 colors": lambda a: {"colors": a["colors"].half()},
    "int alive": lambda a: {"alive": a["alive"].int()},
    "quats (N, 3)": lambda a: {"quats": a["quats"][:, :3]},
    "scales one row short": lambda a: {"scales": a["scales"][:-1]},
    "opacities (N, 1)": lambda a: {"opacities": a["opacities"][:, None]},
    "colors (N, 4)": lambda a: {"colors": torch.zeros(N, 4)},
    "viewmat (3, 4)": lambda a: {"viewmat": a["viewmat"][:3]},
    "c2w on another device": lambda a: {"c2w": a["c2w"].to("meta")},
    "fx (1,)": lambda a: {"intrinsics": (a["intrinsics"][0][None],)
                          + a["intrinsics"][1:]},
    "fx a float": lambda a: {"intrinsics": (700.0,) + a["intrinsics"][1:]},
    "fx needs a gradient": lambda a: {"intrinsics": (
        a["intrinsics"][0].clone().requires_grad_(True),)
        + a["intrinsics"][1:]},
    "width 0": lambda a: {"width": 0},
}


@pytest.mark.parametrize("what", sorted(_BAD))
def test_project_screen_check_refuses(what):
    args = _check_args()
    args = _check_args(**_BAD[what](args))
    with pytest.raises(ValueError, match="project_screen"):
        rc._project_check(**args)


def test_project_screen_check_accepts_the_render_inputs():
    rc._project_check(**_check_args())


def test_project_screen_refuses_a_device_without_a_path():
    t = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="project_screen"):
        rc.project_screen(t, torch.zeros(4, 4, device="meta"), t,
                          torch.zeros(4, device="meta"), t,
                          torch.ones(4, device="meta"),
                          torch.eye(4, device="meta"),
                          torch.eye(4, device="meta"),
                          *(torch.ones((), device="meta"),) * 4, 8, 8)
