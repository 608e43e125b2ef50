"""The frame's float32 operations (work.py) over the untraced window's
time per frame times the 67 TFLOP/s float32 peak, in %."""

from harness import work as W


def read(ctx):
    if not ctx["work"]:
        return None
    ops = W.frame_ops(ctx["work"], ctx["n_gauss"])
    return 100.0 * ops / (ctx["untraced_unit_s"] * W.FP32_OPS_PER_S)
