"""CUDA kernels launched per frame in the profiled stretch. None without
one."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    return tr["kernels"] / ctx["units"]
