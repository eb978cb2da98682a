"""Model FLOPs per trained token (``flops.train_flops_per_token``: the
LM head counted, attention's causal half, no recompute) x tokens/s over
the bf16 peak, in %."""

from benchmark import readers


def read(ctx):
    return readers.train_mfu_pct(ctx)
