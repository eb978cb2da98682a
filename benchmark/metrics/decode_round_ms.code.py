"""Window ms over the decode steps the engine counted in it: one engine
round (a decode step, with any prefill chunk or admission between)."""

from benchmark import readers


def read(ctx):
    return readers.decode_round_ms(ctx)
