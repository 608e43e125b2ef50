"""The share of the profiled stretch's wall time in which no operation
ran on the device, in %: one minus the union of the device intervals over
the stretch's host-clock time. The frame's host pre-pass and the copy of
the map to the host leave the device idle. None without a profiled
stretch."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
