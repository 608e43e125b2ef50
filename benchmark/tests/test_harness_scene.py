"""The scene's targets are exact: ray-cast depth and normals of a room
whose geometry is known in closed form."""

from __future__ import annotations

import math

import torch

from harness import scene as S

ROOM = {"size": [6.0, 3.0, 4.0],
        "boxes": [[2.5, 0.5, 3.5, 1.0, 1.0]], "partitions": []}
INTR = {"width": 32, "height": 24, "fx": 20.0, "fy": 20.0, "cx": 16.0,
        "cy": 12.0}


def _targets(eye, fwd):
    rects = S.build_rects(ROOM, "cpu")
    gen = torch.Generator().manual_seed(0)
    tex = S.draw_textures(rects.count, gen, "cpu")
    c2w = S._look_at(torch.tensor(eye), torch.tensor(fwd))
    return S.render_targets(rects, tex, c2w, INTR)


def test_depth_and_normal_of_a_wall_seen_head_on():
    # from (3, 1.5, 2.5) looking along +z, the wall z = 4 is 1.5 m away
    t = _targets([3.0, 1.5, 2.5], [0.0, 0.0, 1.0])
    d = t["sensor_depth"][..., 0]
    assert torch.allclose(d, torch.full_like(d, 1.5), atol=1e-5)
    # the wall faces the camera: its camera-frame (OpenGL) normal is +z
    n = 2.0 * t["normal"] - 1.0
    assert torch.allclose(n, torch.tensor([0.0, 0.0, 1.0]).expand_as(n),
                          atol=1e-5)
    assert float(t["image"].min()) >= 0.0 and float(t["image"].max()) <= 1.0


def test_depth_of_the_floor_and_of_a_box():
    # looking straight down from 1.5 m: the floor is 1.5 m away in z
    t = _targets([4.5, 1.5, 2.5], [0.0, -1.0, 1e-4])
    assert torch.allclose(t["sensor_depth"], torch.full_like(
        t["sensor_depth"], 1.5), atol=1e-3)
    # straight down over the box (top at 1.0 m): the centre ray meets it
    # 0.5 m below the eye
    t = _targets([3.0, 1.5, 0.75], [0.0, -1.0, 1e-4])
    assert abs(float(t["sensor_depth"][12, 16, 0]) - 0.5) < 1e-3


def test_oblique_ray_depth_is_camera_z():
    # a pixel off the axis meets the wall z = 4 at camera z 1.5 all the same
    t = _targets([3.0, 1.5, 2.5], [0.0, 0.0, 1.0])
    assert abs(float(t["sensor_depth"][0, 0, 0]) - 1.5) < 1e-5


def test_gaussians_lie_on_the_surfaces_as_flat_discs():
    cfg = {"num_gaussians": 2000, "capacity": 4096, "noise_m": 0.0,
           "sh_degree": 3, "sh_rest_std": 0.05, "opacity": 0.9}
    rects = S.build_rects(ROOM, "cpu")
    gen = torch.Generator().manual_seed(1)
    tex = S.draw_textures(rects.count, gen, "cpu")
    st = S.make_gaussians(cfg, rects, tex, gen)
    m = st["means"][:2000]
    lx, ly, lz = ROOM["size"]
    inside = ((m >= -1e-5) & (m <= torch.tensor([lx, ly, lz]) + 1e-5))
    assert bool(inside.all())
    # each mean lies on one of the axis-aligned planes
    on_plane = torch.zeros(2000, dtype=torch.bool)
    for v in (0.0, lx, 2.5, 3.5):
        on_plane |= (m[:, 0] - v).abs() < 1e-4
    for v in (0.0, ly, 1.0):
        on_plane |= (m[:, 1] - v).abs() < 1e-4
    for v in (0.0, lz, 0.5, 1.0):
        on_plane |= (m[:, 2] - v).abs() < 1e-4
    assert bool(on_plane.all())
    # the disc's flattest axis (the third) is the surface normal
    q = st["quats"][:2000]
    from harness.reference import quat_to_rot

    axis3 = quat_to_rot(q)[:, :, 2]
    assert torch.allclose(axis3, st["normals"][:2000], atol=1e-5)
    s = st["scales"][:2000]
    assert bool((s[:, 2] < s[:, 0]).all())
    assert abs(float(torch.sigmoid(st["opacities"][0])) - 0.9) < 1e-6
    assert float(st["alive"].sum()) == 2000.0
    assert float(st["opacities"][2000:].max()) == -15.0


def test_every_seed_serves_the_same_poses():
    a = S.serving_order(300, 1)
    b = S.serving_order(300, 2**33 + 5)
    assert sorted(a) == sorted(b) == list(range(300))
    assert a != b


def test_knn_constant():
    # mean of E[r_k], k = 1..3, for a planar Poisson process, times
    # sqrt(pi rho): (1/2 + 3/4 + 15/16) Gamma-ratio form
    want = (math.sqrt(math.pi) / 2 + 3 * math.sqrt(math.pi) / 4
            + 15 * math.sqrt(math.pi) / 16) / 3
    assert abs(S.KNN3_CONST - want) < 1e-12
