"""The SH colour entry `rasterize_cuda.sh_colors` on the CPU.

A CPU tensor takes the plain version, which is `eval_sh` on the
concatenated coefficients: values and gradients must be bit-equal to it,
and `screen_space` must give the features and gradients it gave when it
called `eval_sh` itself. The kernel pair is held against the plain version
on the card in `tests/test_torch_cuda.py`.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from dnsplatter_torch.data.synthetic import ring_cameras
from dnsplatter_torch.models.gaussians import init_from_points
from dnsplatter_torch.ops import rasterize_cuda as rc
from dnsplatter_torch.ops import render
from dnsplatter_torch.ops.sh import eval_sh

torch.set_num_threads(1)


def _inputs(n, k, seed, strided=False):
    g = torch.Generator().manual_seed(seed)
    dc = torch.randn(n, 3, generator=g)
    rest = 0.5 * torch.randn(n, k - 1, 3, generator=g)
    dirs = 3.0 * torch.randn(n, 3, generator=g)
    dc[0] = -50.0  # a colour below the clamp
    dirs[1] = 0.0
    dirs[2] = torch.tensor([1e-13, -2e-13, 3e-14])
    if strided:
        dc = torch.stack([dc, dc], 1)[:, 0]
        rest = rest.transpose(0, 1).contiguous().transpose(0, 1)
        dirs = dirs.t().contiguous().t()
        assert not (dc.is_contiguous() or rest.is_contiguous()
                    or dirs.is_contiguous())
    return dc, rest, dirs


def _grads(out, leaves):
    w = torch.linspace(-1.0, 2.0, out.numel()).reshape(out.shape)
    return torch.autograd.grad((out * w).sum(), leaves, allow_unused=True)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("degree,k", [(0, 16), (1, 16), (2, 16), (3, 16),
                                      (1, 4), (3, 25)])
def test_sh_colors_cpu_bit_equal_to_eval_sh(degree, k, strided):
    dc, rest, dirs = _inputs(97, k, seed=degree + k, strided=strided)
    a = [t.clone().requires_grad_(True) for t in (dc, rest, dirs)]
    b = [t.clone().requires_grad_(True) for t in (dc, rest, dirs)]
    before = dict(rc.LAUNCHES)
    got = rc.sh_colors(degree, *a)
    want = eval_sh(degree, torch.cat([b[0][:, None], b[1]], 1), b[2])
    assert torch.equal(got, want)
    for ga, gb in zip(_grads(got, a), _grads(want, b)):
        assert (ga is None) == (gb is None)
        assert ga is None or torch.equal(ga, gb)
    assert dict(rc.LAUNCHES) == before  # nothing launched on the CPU


def test_sh_colors_refuses_a_device_without_a_path():
    dc = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="sh_colors"):
        rc.sh_colors(3, dc, torch.zeros(4, 15, 3, device="meta"),
                     torch.zeros(4, 3, device="meta"))


def test_screen_space_features_and_gradients_unchanged_on_cpu():
    """`screen_space` against itself with the colours computed as before the
    entry existed: `eval_sh` on features_dc and features_rest concatenated
    into one (N, K, 3) tensor, at `means - cam_pos`."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    params, alive, _ = init_from_points(rng, pts, sh_degree=3, capacity=320,
                                        device="cpu")
    g = torch.Generator().manual_seed(4)
    params = type(params)(**{
        f: getattr(params, f) + 0.3 * torch.randn(
            getattr(params, f).shape, generator=g)
        if f in ("features_dc", "features_rest") else getattr(params, f)
        for f in params.__dataclass_fields__})
    cam = ring_cameras(1, width=64, img_height=48, focal=60.0,
                       device="cpu")[0]

    def old_colors(degree, dc, rest, dirs):
        return eval_sh(degree, torch.cat([dc[:, None, :], rest], dim=1),
                       dirs)

    def run(degree):
        leaves = type(params)(**{
            f: getattr(params, f).clone().requires_grad_(True)
            for f in params.__dataclass_fields__})
        ss = render.screen_space(leaves, alive, cam, degree)
        names = ("features_dc", "features_rest", "means")
        grads = _grads(ss.features, [getattr(leaves, f) for f in names])
        return ss.features, grads

    for degree in (0, 1, 3):
        got, got_grads = run(degree)
        with mock.patch.object(render, "sh_colors", old_colors):
            want, want_grads = run(degree)
        assert torch.equal(got, want)
        for ga, gb in zip(got_grads, want_grads):
            assert torch.equal(ga, gb)
