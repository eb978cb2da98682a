"""Decode slots filled over decode slots offered in the window: the engine
counters' deltas, (generated tokens - prefills, whose first tokens no
decode step produced) / (decode steps x max_batch), in %."""

from benchmark import readers


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    steps = readers.stat_delta(ctx, "batches")
    if not steps:
        return None
    decoded = (readers.stat_delta(ctx, "generated_tokens")
               - readers.stat_delta(ctx, "prefills"))
    return 100 * decoded / (steps * ctx["max_batch"])
