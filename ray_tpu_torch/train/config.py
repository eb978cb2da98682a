"""Train/AIR-style configuration types (ref analogs: air/config.py
`ScalingConfig/RunConfig/FailureConfig`, train/v2 controller configs).

The port of ray_tpu/train/config.py. ``ScalingConfig.use_gpu`` (the
reference's ``use_tpu``) leases each worker one ``"GPU"`` and defaults to
True: a worker's ``get_device()`` is then the card, and a run on the CPU
asks for it with ``use_gpu=False``. The **mesh axes** are laid over the
workers, one rank each (``get_mesh()``): each GPU worker's lease pins its
own card, and the ranks join one NCCL group.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional


@dataclasses.dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = True
    resources_per_worker: Optional[dict] = None
    placement_strategy: str = "PACK"
    # Mesh axes over the workers (one device each), e.g.
    # {"data": -1, "fsdp": 2, "tensor": 2}. None = pure DP over them.
    mesh: Optional[dict[str, int]] = None
    # Slice topology hint for slice-aware placement (the reference's
    # "v5p-16"; ref analog: TPU-v4-16-head resources,
    # _private/accelerators/tpu.py:197)
    topology: Optional[str] = None
    # Corpus ingest (train/ingest.py IngestSpec): one declarative spec
    # shipped to every worker; each derives its own deterministic shard
    # slice from (rank, num_workers) and exposes the iterator via
    # session.get_ingest(). Lives here because the shard assignment IS a
    # function of the scaling (world size), like mesh axes.
    ingest: Optional[Any] = None

    def worker_resources(self) -> dict:
        if self.resources_per_worker is not None:
            res = dict(self.resources_per_worker)
        else:
            res = {"CPU": 1.0}
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = 1.0
        return res

    def bundles(self) -> list[dict]:
        return [self.worker_resources() for _ in range(self.num_workers)]


@dataclasses.dataclass
class FailureConfig:
    """max_failures: worker-group restarts tolerated; -1 = unlimited
    (ref: train/v2/_internal/execution/failure_handling/failure_policy.py:14)."""
    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)

    def resolved_storage_path(self) -> str:
        return os.path.expanduser(
            self.storage_path or "~/ray_tpu_torch_results")


@dataclasses.dataclass
class Result:
    """Terminal state of a run (ref analog: air/result.py)."""
    metrics: Optional[dict] = None
    checkpoint: Optional[Any] = None
    error: Optional[BaseException] = None
    path: Optional[str] = None
    metrics_dataframe: Optional[Any] = None

    @property
    def best_checkpoints(self) -> list:
        return getattr(self, "_best_checkpoints", [])
