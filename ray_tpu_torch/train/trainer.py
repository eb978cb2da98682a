"""TorchTrainer — the data-parallel trainer (ref analogs:
train/base_trainer.py:111/567 `BaseTrainer.fit`,
train/data_parallel_trainer.py:25, train/torch/torch_trainer.py;
architecture follows train v2: the controller runs in the driver, NOT
wrapped in a Tune trial). The port of ray_tpu/train/trainer.py, whose
`JaxTrainer` this replaces.

Each worker is one GPU lease; the user loop asks the session for its
device (`train.get_context().get_device()`) and builds a train step on it
(ray_tpu_torch.parallel.spmd). Host-plane rendezvous rides the collective
group the WorkerGroup sets up over GCS KV. The torch-backend process
group across cards (train/torch/config.py:66) is ROADMAP.md item 6.
"""

from __future__ import annotations

from typing import Callable, Optional

from ray_tpu_torch.train.config import Result, RunConfig, ScalingConfig
from ray_tpu_torch.train.controller import TrainController


class TorchTrainer:
    def __init__(self, train_loop_per_worker: Callable, *,
                 train_loop_config: Optional[dict] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 scaling_policy=None):
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.scaling_policy = scaling_policy

    def fit(self) -> Result:
        controller = TrainController(
            self.train_loop_per_worker, self.train_loop_config,
            self.scaling_config, self.run_config,
            scaling_policy=self.scaling_policy)
        return controller.run()


# Alias matching the reference's naming for the DP trainer family.
DataParallelTrainer = TorchTrainer
