"""Ops of the Llama train step: norms, rope, attention, cross entropy, the
MoE FFN, and the CUDA kernels under ``ops.cuda``."""
