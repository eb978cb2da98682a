"""Benchmarks and profiling scripts of ray_tpu_torch, each run as
``python -m ray_tpu_torch.tools.<name>``: the twins of the JAX package's
``tools/`` scripts and of ``bench.py``'s train leg. Each runs on the CUDA
card unless given ``--device cpu``, prints one JSON line, and writes a file
only where ``--out`` names one."""
