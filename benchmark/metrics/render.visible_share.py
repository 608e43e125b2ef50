"""Gaussians inside the frustum, alive and in the crop box over the
capacity rows that projection, SH and normals compute on, summed over the
frames of the profiled stretch, in %: the program's counters
`project.visible` and `project.rows` (`utils/profiling.record()`). None
where the program records no counters."""


def read(ctx):
    from dnsplatter_torch.utils import profiling

    record = getattr(profiling, "record", None)
    if record is None:
        return None
    c = record()["counters"]
    if not c.get("project.rows"):
        return None
    return 100.0 * c.get("project.visible", 0) / c["project.rows"]
