"""Ops of the Llama train step: norms, rope, attention, cross entropy, and
the CUDA kernels under ``ops.cuda``."""
