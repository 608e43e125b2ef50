"""Host time of the program's span `prior.prepare` (the frame's pad,
ImageNet normalisation and upload) per frame of the profiled stretch
(`utils/profiling.record()`): while it runs the device has nothing queued.
None where the program records no such span."""


def read(ctx):
    from dnsplatter_torch.utils import profiling

    record = getattr(profiling, "record", None)
    if record is None:
        return None
    s = record()["spans"].get("prior.prepare")
    if not s:
        return None
    return s["host_ms"] / ctx["units"]
