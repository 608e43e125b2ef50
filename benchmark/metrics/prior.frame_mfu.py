"""The frame's float32 operations (the reference's count,
`references/dsine_b5.flops` of the frame's size) over the untraced
window's time per frame times the 67 TFLOP/s float32 peak, in %. The
frame runs no kernel of the port's own, so this is its roofline share."""

from harness import work as W


def read(ctx):
    if not ctx.get("flops"):
        return None
    return 100.0 * ctx["flops"] / (ctx["untraced_unit_s"]
                                   * W.FP32_OPS_PER_S)
