"""The share of the profiled stretch's wall time in which no operation
ran on the device, in %: one minus the union of the device intervals
over the stretch's host-clock time. The profiler's host overhead
lengthens the stretch, so this reads above the untraced window's idle
share wherever the host sets the pace of a frame."""


def read(ctx):
    return 100.0 * (1.0 - ctx["trace"]["busy_s"] / ctx["trace"]["window_s"])
