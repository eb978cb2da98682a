"""Mean device span of the window's decode steps (the phase
``engine.decode``: the step's kernels and any card idle between them, up
to the read-back of its sampled tokens), in ms."""

from benchmark import spans


def read(ctx):
    return spans.mean_device_ms(ctx, "engine.decode")
