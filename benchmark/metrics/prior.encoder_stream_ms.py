"""Stream time of the program's span `prior.encoder` (DSINE's B5) per
frame of the profiled stretch (`utils/profiling.record()`). None where the
program records no such span."""


def read(ctx):
    from dnsplatter_torch.utils import profiling

    record = getattr(profiling, "record", None)
    if record is None:
        return None
    s = record()["spans"].get("prior.encoder")
    if not s or s["stream_ms"] is None:
        return None
    return s["stream_ms"] / ctx["units"]
