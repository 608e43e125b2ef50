"""The SSIM term `models/losses.ssim` on the CPU.

A CPU tensor takes the plain version, `ssim_plain`, the code `ssim` ran
before the kernel pair existed: its value and gradients must be bit-equal
to that code. The backward the kernel implements (per-pixel partials A, B
and C in the blurred moments, blurred back with the transposed window) is
stated here in plain torch and held against autograd of `ssim_plain`,
through exact ties of the variance clamp. The kernel pair itself is held
against the plain version on the card in `tests/test_torch_cuda.py`.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dnsplatter_torch.models import losses as L
from dnsplatter_torch.ops import rasterize_cuda as rc

torch.set_num_threads(1)

SHAPES = ((23, 31), (17, 45), (41, 29))


def _old_ssim(img1, img2, kernel_size=11, sigma=1.5, data_range=1.0):
    """`losses.ssim` before the kernel pair existed, verbatim."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    win = L._gaussian_window(kernel_size, sigma, device=img1.device)
    x = img1.permute(2, 0, 1)
    y = img2.permute(2, 0, 1)
    mu_x = L._blur(x, win)
    mu_y = L._blur(y, win)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    zero = L._const(x, 0.0)
    sigma_x = torch.maximum(L._blur(x * x, win) - mu_xx, zero)
    sigma_y = torch.maximum(L._blur(y * y, win) - mu_yy, zero)
    sigma_xy = L._blur(x * y, win) - mu_xy
    num = (2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2)
    return torch.mean(num / den)


def _images(h, w, c, seed, flat=False):
    """An image pair in [0, 1], img2 near img1; with `flat`, overlapping
    patches of 0.5 in img1 and 0.25 in img2, wide enough that whole windows
    see one value: with windows of 3, 7 and 11 taps the variances tie the
    clamp at exactly 0 there, where x is not 0, so the tie's half gradient
    reaches dx."""
    rng = np.random.default_rng(seed)
    x = rng.random((h, w, c), dtype=np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal((h, w, c)), 0, 1)
    x, y = torch.as_tensor(x), torch.as_tensor(y.astype(np.float32))
    if flat:
        x[2:h - 3, 3:w // 2 + 8] = 0.5
        y[4:h - 1, 1:w // 2] = 0.25
    return x, y


def _backward_statement(img1, img2, kernel_size=11, sigma=1.5,
                        data_range=1.0):
    """d mean(SSIM) / d img1 as csrc/ssim.cu computes it: the partials of
    each pixel's SSIM in mu_x (A), E[x^2] (B) and E[xy] (C), then
    (blur^T A + 2 x blur^T B + y blur^T C) / M, blur^T the blur of the
    zero-padded map with the window reversed. Plain torch, no autograd."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    k = kernel_size
    win = L._gaussian_window(k, sigma)
    x = img1.permute(2, 0, 1)
    y = img2.permute(2, 0, 1)
    mx, my = L._blur(x, win), L._blur(y, win)
    mxx, myy, mxy = mx * mx, my * my, mx * my
    rx = L._blur(x * x, win) - mxx
    ry = L._blur(y * y, win) - myy
    cxy = L._blur(x * y, win) - mxy
    n1, n2 = 2.0 * mxy + c1, 2.0 * cxy + c2
    d1 = mxx + myy + c1
    d2 = torch.clamp_min(rx, 0.0) + torch.clamp_min(ry, 0.0) + c2
    den = d1 * d2
    s = n1 * n2 / den
    g_num, g_den = 1.0 / den, -(s / den)
    g_n1, g_n2 = g_num * n2, g_num * n1
    g_d1, g_d2 = g_den * d2, g_den * d1
    share = torch.where(rx < 0, 0.0, torch.where(rx == 0, 0.5, 1.0))
    c = 2.0 * g_n2
    b = share * g_d2
    a = 2.0 * (g_d1 - b) * mx + (2.0 * g_n1 - c) * my

    def blur_t(m):
        return L._blur(F.pad(m, (k - 1, k - 1, k - 1, k - 1)), win.flip(0))

    dx = (blur_t(a) + 2.0 * x * blur_t(b) + y * blur_t(c)) / s.numel()
    return dx.permute(1, 2, 0), int((rx == 0).sum())


@pytest.mark.parametrize("kernel_size", [3, 7, 11])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("h,w", SHAPES)
def test_ssim_plain_bit_equal_to_the_old_code(h, w, channels, kernel_size):
    """Value and both gradients, bit for bit."""
    x, y = _images(h, w, channels, seed=h + w + channels + kernel_size)
    a = [t.clone().requires_grad_(True) for t in (x, y)]
    b = [t.clone().requires_grad_(True) for t in (x, y)]
    got = L.ssim_plain(*a, kernel_size=kernel_size)
    want = _old_ssim(*b, kernel_size=kernel_size)
    assert torch.equal(got, want)
    for ga, gb in zip(torch.autograd.grad(got, a),
                      torch.autograd.grad(want, b)):
        assert torch.equal(ga, gb)


@pytest.mark.parametrize("kernel_size", [7, 11])
def test_cpu_images_take_the_plain_path(kernel_size):
    """`ssim` and the main loss on CPU tensors run `ssim_plain` (same
    bits, same gradient) and launch nothing; the kernel's own wrapper
    refuses CPU tensors."""
    x, y = _images(29, 37, 3, seed=kernel_size)
    a = x.clone().requires_grad_(True)
    b = x.clone().requires_grad_(True)
    before = dict(rc.LAUNCHES)
    assert not rc._route(x, "ssim")
    got = L.ssim(a, y, kernel_size=kernel_size)
    want = _old_ssim(b, y, kernel_size=kernel_size)
    assert torch.equal(got, want)
    assert torch.equal(torch.autograd.grad(got, a)[0],
                       torch.autograd.grad(want, b)[0])
    got = L.rgb_main_loss(a, y, 0.2)
    want = 0.8 * torch.mean(torch.abs(y - b)) + 0.2 * (1.0 - _old_ssim(b, y))
    assert torch.equal(got, want)
    win = L._gaussian_window(kernel_size, 1.5)
    with pytest.raises(ValueError, match="ssim"):
        rc.ssim(x, y, win, 1e-4, 9e-4)
    assert dict(rc.LAUNCHES) == before


@pytest.mark.parametrize("kernel_size,channels,h,w,flat", [
    (11, 3, 37, 45, False), (11, 3, 37, 45, True), (11, 1, 23, 17, False),
    (7, 1, 23, 27, True), (7, 3, 19, 26, False), (3, 3, 12, 15, True),
    (11, 3, 11, 11, False)])
def test_backward_statement_matches_autograd(kernel_size, channels, h, w,
                                             flat):
    """The kernel's backward, stated in torch, against autograd of
    `ssim_plain` within 1e-5 of the gradient's largest magnitude; with
    `flat`, some variances tie the clamp at 0 and pass half the
    gradient."""
    x, y = _images(h, w, channels, seed=7 * h + w, flat=flat)
    xl = x.clone().requires_grad_(True)
    want = torch.autograd.grad(L.ssim_plain(xl, y, kernel_size), xl)[0]
    got, ties = _backward_statement(x, y, kernel_size)
    assert (ties > 0) == flat
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


def _check_cases():
    x, y = _images(40, 48, 3, seed=1)
    five = torch.rand(40, 48, 5, generator=torch.Generator().manual_seed(5))
    return {
        "kernel 13": (x, y, 13, "taps"),
        "float64": (x.double(), y.double(), 11, "float32"),
        "small": (x[:9], y[:9], 11, "taps"),
        "channels": (five, five.flip(0), 11, "channels"),
        "shapes": (x, y[:, :47], 11, "one shape"),
        "img2 grad": (x, y.clone().requires_grad_(True), 11, "img2"),
    }


@pytest.mark.parametrize("what", list(_check_cases()))
def test_kernel_check_names_what_it_refuses(what):
    """The kernel wrapper's one gate, `_ssim_check`, raises for each input
    the kernel cannot take, naming it, and passes the images the loss
    gives it."""
    a, b, k, says = _check_cases()[what]
    with pytest.raises(ValueError, match=says):
        rc._ssim_check(a, b, L._gaussian_window(k, 1.5))
    x, y = _images(40, 48, 3, seed=1)
    rc._ssim_check(x, y, L._gaussian_window(11, 1.5))
