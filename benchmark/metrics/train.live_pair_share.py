"""Pair slots the backward's reduction by key read (up to each tile's
deepest contributor) over the pairs the binnings listed, summed over the
profiled stretch's steps, in %: the program's counters `bwd.live_slots`
and `bwd.pairs_listed` (`utils/profiling.record()`). None where the
program records no counters."""


def read(ctx):
    from dnsplatter_torch.utils import profiling

    record = getattr(profiling, "record", None)
    if record is None:
        return None
    c = record()["counters"]
    if not c.get("bwd.pairs_listed") or "bwd.live_slots" not in c:
        return None
    return 100.0 * c["bwd.live_slots"] / c["bwd.pairs_listed"]
