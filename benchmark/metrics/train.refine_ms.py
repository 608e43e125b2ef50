"""Host time of the Trainer's refinement events and eval images per step
of the window (spans bracketed by synchronisations where they work)."""


def read(ctx):
    return 1e3 * ctx["refine_s"] / ctx["window_units"]
