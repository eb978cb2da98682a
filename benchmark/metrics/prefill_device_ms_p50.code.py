"""Median device span of the window's prefill calls (the phase
``engine.prefill``: one chunk, or a whole prompt that fits one), in ms."""

from benchmark import spans


def read(ctx):
    return spans.median_device_ms(ctx, "engine.prefill")
