"""Pairs listed over the pair capacity the binnings were sized at, summed
over the binnings of the profiled stretch (the steps' and any eval image's),
in %: the program's counters `bin.pairs_listed` and `bin.pair_capacity`
(`utils/profiling.record()`). The sorts, gathers and slabs of the
rasterizer scale with the capacity, the useful work with the pairs listed.
None where the program records no counters."""


def read(ctx):
    from dnsplatter_torch.utils import profiling

    record = getattr(profiling, "record", None)
    if record is None:
        return None
    c = record()["counters"]
    if not c.get("bin.pair_capacity"):
        return None
    return 100.0 * c.get("bin.pairs_listed", 0) / c["bin.pair_capacity"]
