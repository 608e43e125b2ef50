"""CUDA kernels launched per frame in the profiled stretch."""


def read(ctx):
    return ctx["trace"]["kernels"] / ctx["units"]
