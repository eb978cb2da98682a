"""Device ms of the phase ``train.backward`` per train step in the window
(the step's forward, backward and optimizer phases tile it on the
stream)."""

from benchmark import spans


def read(ctx):
    return spans.per_step_ms(ctx, "train.backward")
