"""CUDA kernels launched per step in the profiled stretch."""


def read(ctx):
    return ctx["trace"]["kernels"] / ctx["units"]
