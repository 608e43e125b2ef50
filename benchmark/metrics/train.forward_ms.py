"""Device time of the kernels inside `get_outputs` (projection, SH,
binning, payload, forward_tiles, finishing) per step."""


def read(ctx):
    s = ctx["trace"]["span_device_s"].get("get_outputs")
    if s is None:
        return None
    return 1e3 * s / ctx["units"]
