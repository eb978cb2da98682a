"""Hand-written CUDA kernels (sources in ``ray_tpu_torch/csrc/``), their
build and loader, and their plain PyTorch versions."""
