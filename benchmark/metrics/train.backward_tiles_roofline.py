"""backward_tiles' least time for the reference's count of its work over
its device time, in % (work.py)."""

from harness import work as W


def read(ctx):
    s = ctx["trace"]["span_device_s"].get("backward_tiles")
    if not s or not ctx["work"]:
        return None
    least = W.least_s(W.backward_tiles(ctx["work"], ctx["n_tiles"]))
    return 100.0 * least * ctx["units"] / s
