"""Mean over the window's engine rounds of the round's host time less the
device spans of its admit, prefill and decode phases and less its wait
for work: the card idle while the engine had work, in ms."""

from benchmark import spans


def read(ctx):
    return spans.round_idle_ms(ctx)
