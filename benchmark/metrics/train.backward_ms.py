"""Device time of the kernels inside `torch.autograd.grad` (the loss's
backward, the rasterizer's backward glue, backward_tiles and the
reduction to per-Gaussian gradients) per step."""


def read(ctx):
    s = ctx["trace"]["span_device_s"].get("autograd_grad")
    if s is None:
        return None
    return 1e3 * s / ctx["units"]
