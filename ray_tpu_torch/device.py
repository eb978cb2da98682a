"""Where the port's entry points run: on the card unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the CUDA card. Raises when CUDA is absent rather than
    carrying on on the CPU; pass ``device="cpu"`` to run there on purpose."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return torch.device("cuda")
