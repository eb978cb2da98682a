"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for an NVIDIA H100.

This slice covers the Llama train step: ops (rms_norm, rope, attention,
cross entropy), the flash-attention kernels written in CUDA C++ for sm_90a
(``ops/cuda``), the training half of the Llama model (``models/llama``),
weight conversion from the JAX package's parameter tree
(``models/convert``), and a single-device train step with AdamW
(``parallel/spmd``). Entry points run on the CUDA card unless given
``device="cpu"``. The package never imports jax.
"""

from ray_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
