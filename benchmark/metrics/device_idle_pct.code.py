"""Share of the traced slice in which no operation ran on the device, in %."""

from benchmark import readers


def read(ctx):
    return readers.idle_pct(ctx)
