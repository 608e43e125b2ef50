"""Host time of the copy of rgb, depth and normals to the host per frame,
after the frame's work has finished."""


def read(ctx):
    return 1e3 * ctx["readback_s"] / ctx["units"]
