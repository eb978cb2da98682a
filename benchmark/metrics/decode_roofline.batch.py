"""The least time of the window's mean decode step (the weights read once,
each live row's K and V to its depth, the new K and V written; or its
FLOPs at the bf16 peak) over the measured round, in %."""

from benchmark import readers


def read(ctx):
    return readers.decode_roofline_pct(ctx)
