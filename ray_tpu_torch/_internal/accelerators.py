"""GPU accelerator manager: card autodetect + resource modeling (the GPU
twin of the TPU build's slice detector, ``detect_tpu_slice``).

Ref analog: python/ray/_private/accelerators/nvidia_gpu.py (count from
CUDA_VISIBLE_DEVICES, else the driver). A node with NVIDIA cards
advertises:

  GPU       = cards this node's processes may use
  gpu-type  = node label with the part's name, e.g. "NVIDIA H100 80GB HBM3"

Counting never imports torch: the node manager and the driver's init stay
light, and asking CUDA would create a context in a process that may never
run a kernel.

Each GPU lease is pinned to cards of its own (core/node_manager.py): the
worker serving it sets CUDA_VISIBLE_DEVICES to them, so its process sees
them as cuda:0, cuda:1, ... ``_lease_gpu_ids`` reads them (the role of
Ray's ``ray.get_gpu_ids()``, which the reference has no counterpart of, so
it stays private).
"""

from __future__ import annotations

import os
import re
import subprocess
from dataclasses import dataclass
from typing import Callable, Optional

_PROC_GPUS = "/proc/driver/nvidia/gpus"
_SMI_TIMEOUT_S = 10.0


@dataclass
class GpuInfo:
    count: int                 # cards visible to this node's processes
    name: str = ""             # the part, as the driver names it

    def resources(self) -> dict:
        """Schedulable resources this host should advertise."""
        return {"GPU": float(self.count)}

    def labels(self) -> dict:
        lab = {"gpu-count": str(self.count)}
        if self.name:
            lab["gpu-type"] = self.name
        return lab


def _smi_cards() -> list[str]:
    """Card names from `nvidia-smi -L` ("GPU 0: <name> (UUID: ...)")."""
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=_SMI_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired):
        return []
    if out.returncode != 0:
        return []
    return re.findall(r"^GPU \d+: (.+?) \(UUID", out.stdout, re.M)


def _proc_cards(root: str = _PROC_GPUS) -> list[str]:
    """Card names from the driver's /proc tree, one directory per card
    (by PCI bus id, the order CUDA_DEVICE_ORDER=PCI_BUS_ID gives)."""
    try:
        buses = sorted(os.listdir(root))
    except OSError:
        return []
    names = []
    for bus in buses:
        name = ""
        try:
            with open(os.path.join(root, bus, "information")) as f:
                for line in f:
                    key, _, value = line.partition(":")
                    if key.strip() == "Model":
                        name = value.strip()
        except OSError:
            pass
        names.append(name)
    return names


def probe_cards() -> list[str]:
    """Card names from nvidia-smi, else the driver's /proc tree; [] on a
    host without NVIDIA cards."""
    return _smi_cards() or _proc_cards()


def _visible(entries: str, n_cards: int) -> list[int | None]:
    """CUDA_VISIBLE_DEVICES as CUDA reads it: the listed cards up to the
    first entry that names none (an index past the host's cards, or a
    negative one). An index maps to its card; a UUID to None."""
    out: list[int | None] = []
    for entry in entries.split(","):
        entry = entry.strip()
        if entry.isdigit() and int(entry) < n_cards:
            out.append(int(entry))
        elif entry.startswith(("GPU-", "MIG-")):
            out.append(None)
        else:
            break
    return out


def detect_gpus(env: Optional[dict] = None,
                probe: Callable[[], list[str]] = probe_cards
                ) -> Optional[GpuInfo]:
    """The cards this host's processes may use, or None if it has none.
    ``env`` and ``probe`` stand in for os.environ and the driver probe
    (tests inject both)."""
    env = os.environ if env is None else env
    cards = probe()
    if not cards:
        return None
    visible = env.get("CUDA_VISIBLE_DEVICES")
    if visible is None:
        return GpuInfo(count=len(cards), name=cards[0])
    picked = _visible(visible, len(cards))
    if not picked:
        return None
    first = picked[0]
    return GpuInfo(count=len(picked),
                   name=cards[first if first is not None else 0])


def _lease_gpu_ids() -> tuple[str, ...]:
    """The cards of the GPU lease this worker runs now (an actor's for its
    life, a task's while it runs), as CUDA_VISIBLE_DEVICES names them; ()
    outside a worker or for a lease without a GPU."""
    from ray_tpu_torch.core.object_ref import get_core_worker

    try:
        cw = get_core_worker()
    except Exception:
        return ()
    return tuple(getattr(cw, "leased_gpu_ids", ()) or ())


def _in_lease_without_gpu() -> bool:
    """Whether this process is a runtime worker whose lease holds no GPU:
    it still sees every card of the node, and none of them is its own."""
    from ray_tpu_torch.core.object_ref import get_core_worker

    cw = get_core_worker()
    return getattr(cw, "mode", None) == "worker" and not _lease_gpu_ids()
