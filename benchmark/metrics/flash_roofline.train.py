"""The traced flash kernels' (K1 forward, K2 dQ, K3 dK/dV) bound from the
cell's shapes over their device time, in %."""

from benchmark import readers


def read(ctx):
    return readers.flash_roofline_pct(ctx)
