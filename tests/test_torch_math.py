"""dnsplatter_torch math ops against the JAX package on the same inputs.

Tolerance: rtol 1e-5, atol 1e-6 — both sides compute in float32 with the
same formulas; only operation order and transcendental implementations
differ, which moves results by a few ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnsplatter_torch.ops import camera as tcam
from dnsplatter_torch.ops import normals as tnrm
from dnsplatter_torch.ops import projection as tproj
from dnsplatter_torch.ops import quat as tq
from dnsplatter_torch.ops import sh as tsh
from dnsplatter_tpu.ops import camera as jcam
from dnsplatter_tpu.ops import normals as jnrm
from dnsplatter_tpu.ops import projection as jproj
from dnsplatter_tpu.ops import quat as jq
from dnsplatter_tpu.ops import sh as jsh

RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def T(a):
    return torch.as_tensor(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q[0] = 0.0  # zero quaternion: normalization epsilon path
    return q


def test_quat_ops():
    rng = np.random.default_rng(0)
    q = _quats(rng, 64)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    close(tq.quat_normalize(T(q)), jq.quat_normalize(J(q)))
    close(tq.quat_to_rotmat(T(q)), jq.quat_to_rotmat(J(q)))
    close(tq.quat_rotate(T(q), T(v)), jq.quat_rotate(J(q), J(v)))


def test_random_quats_are_unit_and_seeded():
    a = tq.random_quats(np.random.default_rng(3), 100, device="cpu")
    b = tq.random_quats(np.random.default_rng(3), 100, device="cpu")
    assert torch.equal(a, b)
    close(torch.linalg.norm(a, dim=-1), np.ones(100))
    # Shoemake's formula on the same draws as the JAX function's math
    u, v, w = np.random.default_rng(3).uniform(size=(3, 100)).astype(
        np.float32)
    want = np.stack([np.sqrt(1 - u) * np.sin(2 * np.pi * v),
                     np.sqrt(1 - u) * np.cos(2 * np.pi * v),
                     np.sqrt(u) * np.sin(2 * np.pi * w),
                     np.sqrt(u) * np.cos(2 * np.pi * w)], -1)
    close(a, want, rtol=1e-5, atol=1e-6)


def _cameras():
    eyes = [(3.0, 0.8, 0.0), (-1.0, 2.0, 2.5), (0.3, -1.2, -2.0)]
    return [(eye, (0.1, 0.0, -0.2)) for eye in eyes]


def test_camera_and_pixels():
    for eye, target in _cameras():
        c2w_t = tcam.look_at(eye, target, device="cpu")
        c2w_j = jcam.look_at(eye, target)
        close(c2w_t, c2w_j)
        ct = tcam.Camera.create(70.0, 65.0, 31.0, 25.0, c2w_t, 64, 48)
        cj = jcam.Camera.create(70.0, 65.0, 31.0, 25.0, c2w_j, 64, 48)
        close(ct.viewmat(), cj.viewmat())
        close(ct.position(), cj.position())
        close(ct.K, cj.K)
    close(tcam.pixel_coords(7, 5, device="cpu"), jcam.pixel_coords(7, 5))
    rng = np.random.default_rng(1)
    depth = rng.uniform(0.5, 4.0, (9, 11, 1)).astype(np.float32)
    c2w = np.asarray(jcam.look_at((1.0, 2.0, 3.0), (0.0, 0.0, 0.0)))
    for m in (None, c2w):
        close(tcam.backproject_depth(T(depth), 20.0, 21.0, 5.5, 4.5,
                                     None if m is None else T(m)),
              jcam.backproject_depth(J(depth), 20.0, 21.0, 5.5, 4.5,
                                     None if m is None else J(m)))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh(degree):
    rng = np.random.default_rng(degree)
    dirs = rng.normal(size=(128, 3)).astype(np.float32)
    coeffs = rng.normal(size=(128, 16, 3)).astype(np.float32)
    unit = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    close(tsh.sh_basis(degree, T(unit)), jsh.sh_basis(degree, J(unit)))
    close(tsh.eval_sh(degree, T(coeffs), T(dirs)),
          jsh.eval_sh(degree, J(coeffs), J(dirs)))
    rgb = rng.uniform(size=(10, 3)).astype(np.float32)
    close(tsh.rgb_to_sh(T(rgb)), jsh.rgb_to_sh(J(rgb)))
    close(tsh.sh_to_rgb(T(rgb)), jsh.sh_to_rgb(J(rgb)))
    assert tsh.num_sh_bases(degree) == jsh.num_sh_bases(degree)


@pytest.mark.parametrize("with_opacity", [False, True])
def test_project_gaussians(with_opacity):
    rng = np.random.default_rng(5)
    n = 400
    means = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    quats = _quats(rng, n)
    scales = np.exp(rng.uniform(-4.0, -0.5, (n, 3))).astype(np.float32)
    opac = rng.uniform(0.001, 0.99, n).astype(np.float32)
    c2w = np.asarray(jcam.look_at((0.5, 0.7, 2.5), (0.0, 0.0, 0.0)))
    cj = jcam.Camera.create(60.0, 62.0, 32.0, 24.0, c2w, 64, 48)
    ct = tcam.Camera.create(60.0, 62.0, 32.0, 24.0, c2w, 64, 48,
                            device="cpu")
    pj = jproj.project_gaussians(J(means), J(quats), J(scales), cj.viewmat(),
                                 cj.fx, cj.fy, cj.cx, cj.cy, 64, 48,
                                 opacities=J(opac) if with_opacity else None)
    pt = tproj.project_gaussians(T(means), T(quats), T(scales), ct.viewmat(),
                                 ct.fx, ct.fy, ct.cx, ct.cy, 64, 48,
                                 opacities=T(opac) if with_opacity else None)
    valid = np.asarray(pj.valid)
    assert 50 < valid.sum() < n  # both culled and kept Gaussians
    np.testing.assert_array_equal(pt.valid.numpy(), valid)
    # classic and antialiased: the compensation is what antialiasing adds
    for name in ("means2d", "depths", "conics", "compensations"):
        close(getattr(pt, name)[valid], np.asarray(getattr(pj, name))[valid],
              err_msg=name)
    # integer-valued radii: ceil() may flip only where the argument sits
    # within float rounding of an integer
    for name in ("radii", "radii_xy"):
        d = np.abs(getattr(pt, name).numpy() - np.asarray(getattr(pj, name)))
        assert (d <= 1.0).all() and (d > 0).mean() < 0.01, name


def test_normals():
    rng = np.random.default_rng(7)
    n = 200
    scales = rng.normal(size=(n, 3)).astype(np.float32)
    scales[:5, 1] = scales[:5, 0]  # argmin ties go to the lower index
    quats = _quats(rng, n)
    means = rng.normal(size=(n, 3)).astype(np.float32)
    cam_pos = np.array([0.5, 2.0, 3.0], np.float32)
    nt = tnrm.per_gaussian_normals(T(scales), T(quats), T(means), T(cam_pos))
    nj = jnrm.per_gaussian_normals(J(scales), J(quats), J(means), J(cam_pos))
    close(nt, nj)
    c2w = np.asarray(jcam.look_at((1.0, 2.0, 3.0), (0.0, 0.0, 0.0)))
    close(tnrm.world_to_camera_normals(nt, T(c2w)),
          jnrm.world_to_camera_normals(nj, J(c2w)))
    yy, xx = np.mgrid[0:12, 0:16].astype(np.float32)
    depth = (2.0 + 0.05 * xx + 0.02 * yy ** 1.5)[..., None]
    close(tnrm.normal_from_depth_image(T(depth), 15.0, 15.0, 8.0, 6.0),
          jnrm.normal_from_depth_image(J(depth), 15.0, 15.0, 8.0, 6.0))
    close(tnrm.surface_normal_output(T(depth), 15.0, 15.0, 8.0, 6.0),
          jnrm.surface_normal_output(J(depth), 15.0, 15.0, 8.0, 6.0))


# -- gradients against jax.grad (training runs autograd through these) ------

GRAD_RTOL = 1e-4  # of each gradient's largest magnitude


def _grads_both(jfn, tfn, inputs, seed=0):
    """Gradients of sum(w * f(*inputs)) wrt every input, w fixed random
    weights, from jax.grad and from torch.autograd."""
    import jax

    rng = np.random.default_rng(seed)
    out = np.asarray(jfn(*map(J, inputs)))
    w = rng.normal(size=out.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * J(w)),
                  argnums=tuple(range(len(inputs))))(*map(J, inputs))
    leaves = [T(a).clone().requires_grad_(True) for a in inputs]
    tg = torch.autograd.grad((tfn(*leaves) * T(w)).sum(), leaves,
                             allow_unused=True)
    tg = [np.zeros_like(a) if g is None else g.numpy()
          for g, a in zip(tg, inputs)]
    return [np.asarray(g) for g in jg], tg


def _assert_grads(jg, tg, names):
    for name, gj, gt in zip(names, jg, tg):
        assert np.isfinite(gt).all(), name
        scale = max(np.abs(gj).max(), 1e-12)
        np.testing.assert_allclose(gt / scale, gj / scale, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL, err_msg=name)


def _math_grad_cases():
    rng = np.random.default_rng(11)
    n = 64
    q = _quats(rng, n)  # row 0 is the zero quaternion
    v = rng.normal(size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    coeffs = rng.normal(size=(n, 16, 3)).astype(np.float32)
    scales_log = rng.normal(size=(n, 3)).astype(np.float32)
    cam_pos = np.array([0.5, 2.0, 3.0], np.float32)
    c2w = np.asarray(jcam.look_at((1.0, 2.0, 3.0), (0.0, 0.0, 0.0)))
    return {
        "quat_normalize": (jq.quat_normalize, tq.quat_normalize, (q,)),
        "quat_to_rotmat": (jq.quat_to_rotmat, tq.quat_to_rotmat, (q,)),
        "quat_rotate": (jq.quat_rotate, tq.quat_rotate, (q, v)),
        "eval_sh_3": (lambda c, d: jsh.eval_sh(3, c, d),
                      lambda c, d: tsh.eval_sh(3, c, d), (coeffs, dirs)),
        "eval_sh_1": (lambda c, d: jsh.eval_sh(1, c, d),
                      lambda c, d: tsh.eval_sh(1, c, d), (coeffs, dirs)),
        "per_gaussian_normals": (
            lambda s, qq, m: jnrm.per_gaussian_normals(s, qq, m, J(cam_pos)),
            lambda s, qq, m: tnrm.per_gaussian_normals(s, qq, m, T(cam_pos)),
            (scales_log, q, v)),
        "world_to_camera_normals": (
            lambda nn: jnrm.world_to_camera_normals(nn, J(c2w)),
            lambda nn: tnrm.world_to_camera_normals(nn, T(c2w)), (v,)),
    }


@pytest.mark.parametrize("name", sorted(_math_grad_cases()))
def test_math_op_gradients_match_jax(name):
    jfn, tfn, inputs = _math_grad_cases()[name]
    _assert_grads(*_grads_both(jfn, tfn, inputs), [f"{name}[{i}]" for i in
                                                   range(len(inputs))])


@pytest.mark.parametrize("field", ["means2d", "conics", "depths",
                                   "compensations"])
def test_project_gaussians_gradients_match_jax(field):
    """Gradients wrt means, quaternions (one of them zero) and scales
    through each differentiable output; Gaussians behind the camera or
    off screen take part (their outputs are defined, if unused)."""
    rng = np.random.default_rng(5)
    n = 200
    means = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    quats = _quats(rng, n)
    scales = np.exp(rng.uniform(-4.0, -0.5, (n, 3))).astype(np.float32)
    opac = rng.uniform(0.001, 0.99, n).astype(np.float32)
    c2w = np.asarray(jcam.look_at((0.5, 0.7, 2.5), (0.0, 0.0, 0.0)))
    cj = jcam.Camera.create(60.0, 62.0, 32.0, 24.0, c2w, 64, 48)
    ct = tcam.Camera.create(60.0, 62.0, 32.0, 24.0, c2w, 64, 48,
                            device="cpu")
    valid = np.asarray(jproj.project_gaussians(
        J(means), J(quats), J(scales), cj.viewmat(), cj.fx, cj.fy, cj.cx,
        cj.cy, 64, 48, opacities=J(opac)).valid)

    def mask(x, m):
        return x * (m if x.ndim == 1 else m[:, None])

    def jfn(m, q, s):
        p = jproj.project_gaussians(m, q, s, cj.viewmat(), cj.fx, cj.fy,
                                    cj.cx, cj.cy, 64, 48, opacities=J(opac))
        return mask(getattr(p, field), J(valid.astype(np.float32)))

    def tfn(m, q, s):
        p = tproj.project_gaussians(m, q, s, ct.viewmat(), ct.fx, ct.fy,
                                    ct.cx, ct.cy, 64, 48, opacities=T(opac))
        return mask(getattr(p, field), T(valid.astype(np.float32)))

    jg, tg = _grads_both(jfn, tfn, (means, quats, scales))
    _assert_grads(jg, tg, ["means", "quats", "scales"])
    assert np.abs(jg[0]).max() > 0


def test_rotation_helpers_match_jax():
    rng = np.random.default_rng(13)
    a = rng.normal(size=(50, 3)).astype(np.float32)
    b = rng.normal(size=(50, 3)).astype(np.float32)
    b[0] = -a[0]  # antiparallel
    b[1] = a[1]  # parallel
    rt = tq.rotate_vector_to_vector(T(a), T(b))
    close(rt, jq.rotate_vector_to_vector(J(a), J(b)), atol=2e-6)
    unit = b / np.linalg.norm(b, axis=-1, keepdims=True)
    got = torch.einsum("nij,nj->ni", rt, T(a / np.linalg.norm(
        a, axis=-1, keepdims=True)))
    close(got, unit, atol=1e-5)
    mats = np.asarray(jq.quat_to_rotmat(J(_quats(rng, 50)[1:])))
    close(tq.rotmat_to_quat(T(mats)), jq.rotmat_to_quat(J(mats)), atol=2e-6)
