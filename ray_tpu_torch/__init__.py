"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for an NVIDIA H100.

Ported so far: ops (rms_norm, rope, attention, cross entropy), the
flash-attention kernels written in CUDA C++ for sm_90a (``ops/cuda``), the
Llama model with its KV-cache decode, LoRA adapters and the MoE FFN
(``models/llama``, ``models/lora``, ``ops/moe``), the MLP (``models/mlp``),
weight conversion from the JAX package's parameter tree
(``models/convert``), a single-device train step with AdamW and frozen keys
(``parallel/spmd``), and the continuously batched LLM engine with adapter
serving behind the multiplex LRU (``serve/llm``, ``serve/multiplex``).
Entry points run on the CUDA card unless given ``device="cpu"``. The
package never imports jax.
"""

from ray_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
