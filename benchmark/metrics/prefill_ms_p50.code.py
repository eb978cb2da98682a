"""Median of the engine's prefill time (its request stamp ``prefill_s``,
summed over a prompt's chunks) over the requests due in the window (ms)."""

from benchmark import readers


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    p = [r["obs"]["prefill_s"] * 1e3 for r in readers.due_in_window(ctx)
         if "prefill_s" in r["obs"]]
    return readers.percentile(p, 50)
