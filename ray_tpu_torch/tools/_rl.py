"""What the RL benches share: the learner's lease from the tool's device,
and a cluster for the run."""

from __future__ import annotations

import contextlib
import os

# a small host boots many torch-importing runner processes one after
# another: the runtime's default timeouts would call them dead mid-boot
TIMEOUTS = {"RAYT_WORKER_STARTUP_TIMEOUT_S": "900",
            "RAYT_LEASE_TIMEOUT_S": "600",
            "RAYT_RPC_REQUEST_TIMEOUT_S": "300",
            "RAYT_NODE_DEATH_TIMEOUT_S": "300",
            "RAYT_ACTOR_SCHEDULING_DEADLINE_S": "1800",
            "RAYT_ACTOR_CREATION_PUSH_TIMEOUT_S": "1200"}


def learner_gpus(device) -> int:
    """``num_gpus_per_learner``: the learner leases the card unless the
    tool runs on the CPU."""
    return 1 if device.type == "cuda" else 0


@contextlib.contextmanager
def cluster(num_cpus: int):
    """A local cluster of `num_cpus` CPUs (and the GPUs it finds), shut
    down on the way out."""
    for key, value in TIMEOUTS.items():
        os.environ.setdefault(key, value)
    import ray_tpu_torch as rt

    rt.init(num_cpus=num_cpus)
    try:
        yield rt
    finally:
        rt.shutdown()
