"""Model FLOPs of every served token and finished prompt in the window,
over the window, against the card's bf16 peak, in %."""

from benchmark import readers


def read(ctx):
    return readers.serve_mfu_pct(ctx)
