"""Blocking device-to-host reads per step of the profiled stretch: the sum
of the program's `sync.<site>` counters (`utils/profiling.record()`; the
live pair slots' count each step, the loss and the alive count at the end
of each `Trainer.train` call). None where the program records no spans."""


def read(ctx):
    from dnsplatter_torch.utils import profiling

    record = getattr(profiling, "record", None)
    if record is None:
        return None
    rec = record()
    if not rec["spans"]:
        return None
    reads = sum(v for k, v in rec["counters"].items()
                if k.startswith("sync."))
    return reads / ctx["units"]
