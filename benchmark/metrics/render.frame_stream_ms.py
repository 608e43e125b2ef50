"""Stream time of the program's span `model.outputs` per frame of the
profiled stretch: the served frame's `get_outputs`, from the CUDA event
recorded on the current stream as the span opens to the one recorded as it
closes (`utils/profiling.record()`). Against the device time of the
kernels launched inside the stage, the excess is the time the device
waited for the stage's host work. None where the program records no such
span."""


def read(ctx):
    from dnsplatter_torch.utils import profiling

    record = getattr(profiling, "record", None)
    if record is None:
        return None
    s = record()["spans"].get("model.outputs")
    if not s or s["stream_ms"] is None:
        return None
    return s["stream_ms"] / ctx["units"]
