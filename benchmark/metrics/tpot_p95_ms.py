"""95th percentile of every inter-token gap of every request, both ends
inside the window, at the consumer (ms)."""

from benchmark import readers


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    return readers.percentile(readers.gaps_ms(ctx), 95)
