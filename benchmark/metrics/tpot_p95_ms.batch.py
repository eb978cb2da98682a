"""95th percentile of every inter-token gap of every request, both ends
inside the window, at the consumer (ms). In the closed loop it falls on a
plain decode round or on one that also runs a prefill chunk, as the seed's
order puts fewer or more admissions in the window: a per-layer reading of
how admission stalls decoding, not a bound."""

from benchmark import readers


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    return readers.percentile(readers.gaps_ms(ctx), 95)
