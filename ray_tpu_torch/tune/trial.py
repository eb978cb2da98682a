"""Trial bookkeeping (ref analog: python/ray/tune/experiment/trial.py)."""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional


class TrialStatus(str, enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    TERMINATED = "TERMINATED"
    ERROR = "ERROR"


@dataclasses.dataclass
class Trial:
    trial_id: str
    config: dict
    status: TrialStatus = TrialStatus.PENDING
    last_result: Optional[dict] = None
    results: list = dataclasses.field(default_factory=list)
    checkpoint_dir: Optional[str] = None
    error: Optional[str] = None
    num_failures: int = 0
    # runtime handles (not persisted)
    actor: Any = dataclasses.field(default=None, repr=False)
    run_ref: Any = dataclasses.field(default=None, repr=False)
    run_refs: Any = dataclasses.field(default=None, repr=False)
    iteration: int = 0

    def metric(self, name: str) -> Optional[float]:
        if self.last_result and name in self.last_result:
            return float(self.last_result[name])
        return None

    def snapshot(self) -> dict:
        return {
            "trial_id": self.trial_id, "config": self.config,
            "status": self.status.value, "last_result": self.last_result,
            "checkpoint_dir": self.checkpoint_dir, "error": self.error,
            "iteration": self.iteration,
        }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "Trial":
        t = cls(trial_id=snap["trial_id"], config=snap["config"])
        t.status = TrialStatus(snap["status"])
        t.last_result = snap.get("last_result")
        t.checkpoint_dir = snap.get("checkpoint_dir")
        t.error = snap.get("error")
        t.iteration = snap.get("iteration", 0)
        return t
