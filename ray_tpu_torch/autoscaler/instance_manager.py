"""Event-sourced instance lifecycle (autoscaler v2 core).

Ref analogs: autoscaler/v2/instance_manager/instance_manager.py:29
(`InstanceManager`), reconciler.py (the event-sourced state machine),
instance_storage/schema — each managed SLICE instance moves through an
explicit lifecycle, every transition is an appended event, and the
reconciler converges three views every tick:

    desired (unmet demand from the GCS)   ->  QUEUED
    QUEUED                                 ->  REQUESTED  (provider call)
    provider shows the slice               ->  ALLOCATED
    all hosts registered in the GCS        ->  RUNNING
    idle past timeout / stop requested     ->  STOPPING   (terminate)
    provider no longer shows the slice     ->  TERMINATED
    provider slice vanished while RUNNING  ->  FAILED     (demand re-queues)

The event log (per instance + a bounded global ring) is the debugging
surface `rayt status`-style tooling reads; transitions are validated so
an out-of-order provider/GCS observation can't corrupt state.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Optional

from ray_tpu_torch._internal.logging_utils import setup_logger

logger = setup_logger("instance_manager")


class InstanceStatus:
    QUEUED = "QUEUED"               # demand decided, not yet requested
    REQUESTED = "REQUESTED"         # provider.create_slice in flight
    ALLOCATED = "ALLOCATED"         # provider reports the slice
    RUNNING = "RUNNING"             # every host registered in the GCS
    STOPPING = "STOPPING"           # terminate requested
    TERMINATED = "TERMINATED"       # provider no longer reports it
    FAILED = "FAILED"               # vanished/errored outside our control


_TRANSITIONS = {
    InstanceStatus.QUEUED: {InstanceStatus.REQUESTED,
                            InstanceStatus.FAILED},
    InstanceStatus.REQUESTED: {InstanceStatus.ALLOCATED,
                               InstanceStatus.FAILED},
    InstanceStatus.ALLOCATED: {InstanceStatus.RUNNING,
                               InstanceStatus.STOPPING,
                               InstanceStatus.FAILED},
    InstanceStatus.RUNNING: {InstanceStatus.STOPPING,
                             InstanceStatus.FAILED},
    InstanceStatus.STOPPING: {InstanceStatus.TERMINATED,
                              InstanceStatus.FAILED},
    InstanceStatus.TERMINATED: set(),
    InstanceStatus.FAILED: set(),
}


@dataclasses.dataclass
class Instance:
    instance_id: str
    node_type: str
    status: str = InstanceStatus.QUEUED
    slice_id: Optional[str] = None       # provider handle once allocated
    node_ids: list = dataclasses.field(default_factory=list)
    created_at: float = dataclasses.field(default_factory=time.time)
    updated_at: float = dataclasses.field(default_factory=time.time)
    events: list = dataclasses.field(default_factory=list)

    def terminal(self) -> bool:
        return self.status in (InstanceStatus.TERMINATED,
                               InstanceStatus.FAILED)


class InstanceManager:
    """Owns the instance table; the ONLY way state changes is a validated
    transition event (ref: instance_manager.py update/transition)."""

    def __init__(self, max_event_log: int = 1000):
        self._instances: dict[str, Instance] = {}
        self._seq = itertools.count(1)
        self.event_log: deque = deque(maxlen=max_event_log)

    # ------------------------------------------------------------- queries
    def instances(self, *statuses: str) -> list[Instance]:
        out = [i for i in self._instances.values()
               if not statuses or i.status in statuses]
        # numeric creation order ("inst-2" before "inst-10"): pruning and
        # status views depend on it
        return sorted(out, key=lambda i: int(i.instance_id.rsplit(
            "-", 1)[1]))

    def get(self, instance_id: str) -> Optional[Instance]:
        return self._instances.get(instance_id)

    def by_slice(self, slice_id: str) -> Optional[Instance]:
        return next((i for i in self._instances.values()
                     if i.slice_id == slice_id), None)

    # ----------------------------------------------------------- mutations
    def create(self, node_type: str) -> Instance:
        inst = Instance(instance_id=f"inst-{next(self._seq)}",
                        node_type=node_type)
        self._instances[inst.instance_id] = inst
        self._record(inst, None, InstanceStatus.QUEUED, "demand")
        return inst

    def transition(self, instance_id: str, new_status: str,
                   reason: str = "", **updates) -> bool:
        inst = self._instances.get(instance_id)
        if inst is None:
            return False
        if new_status not in _TRANSITIONS.get(inst.status, set()):
            logger.warning("invalid transition %s: %s -> %s (%s)",
                           instance_id, inst.status, new_status, reason)
            return False
        old = inst.status
        inst.status = new_status
        inst.updated_at = time.time()
        for k, v in updates.items():
            setattr(inst, k, v)
        self._record(inst, old, new_status, reason)
        return True

    def prune_terminal(self, keep_last: int = 100):
        """Drop old terminal instances beyond keep_last (the event ring
        keeps their history)."""
        done = [i for i in self.instances() if i.terminal()]
        for inst in done[:-keep_last] if keep_last else done:
            self._instances.pop(inst.instance_id, None)

    def _record(self, inst: Instance, old, new, reason: str):
        event = {"ts": time.time(), "instance_id": inst.instance_id,
                 "node_type": inst.node_type, "from": old, "to": new,
                 "reason": reason, "slice_id": inst.slice_id}
        inst.events.append(event)
        self.event_log.append(event)
        logger.info("instance %s: %s -> %s (%s)", inst.instance_id,
                    old, new, reason)

    def summary(self) -> dict:
        counts: dict[str, int] = {}
        for i in self._instances.values():
            counts[i.status] = counts.get(i.status, 0) + 1
        return counts
