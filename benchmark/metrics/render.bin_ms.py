"""Device time of the kernels inside `bin_gaussians` per frame."""


def read(ctx):
    s = ctx["trace"]["span_device_s"].get("bin_gaussians")
    if s is None:
        return None
    return 1e3 * s / ctx["units"]
