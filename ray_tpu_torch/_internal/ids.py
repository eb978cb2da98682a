"""Unique identifiers for jobs, tasks, actors, objects, nodes, workers.

Mirrors the semantics of the reference's ID scheme (ref: src/ray/common/id.h
and src/ray/design_docs/id_specification.md) with a simplified, uniform
layout: every ID is raw bytes with a typed wrapper. ObjectIDs embed the
TaskID that produced them plus a return-index, so ownership and lineage can
be derived from the ID itself.

Layout (bytes):
  JobID    = 4 random bytes
  ActorID  = 8 random bytes  + JobID            (12)
  TaskID   = 8 random bytes  + ActorID-or-zeros (20)
  ObjectID = TaskID + 4-byte big-endian index   (24)
  NodeID   = 16 random bytes
  WorkerID = 16 random bytes
  PlacementGroupID = 12 random bytes
"""

from __future__ import annotations

import os
import random

# ID randomness: unique, NOT cryptographic (matches the reference — ids
# only need collision-resistance). os.urandom is a getrandom(2) syscall
# per id, which dominated TaskID minting on the submit hot path
# (~90us/id on the CI host); a process-local PRNG seeded from urandom
# keeps 64-bit+ uniqueness at ~1us/id. Fork-safety: reseed on first use
# in a child (getpid check) so forked workers never replay the parent's
# stream and collide with its ids.
_rng: random.Random | None = None
_rng_pid = 0


def _rand_bytes(n: int) -> bytes:
    global _rng, _rng_pid
    pid = os.getpid()
    if _rng is None or _rng_pid != pid:
        _rng = random.Random(os.urandom(16) + pid.to_bytes(4, "little"))
        _rng_pid = pid
    return _rng.randbytes(n)


JOB_ID_LEN = 4
ACTOR_ID_LEN = 12
TASK_ID_LEN = 20
OBJECT_ID_LEN = 24
NODE_ID_LEN = 16
WORKER_ID_LEN = 16
PLACEMENT_GROUP_ID_LEN = 12


class BaseID:
    LEN = 16
    __slots__ = ("_bytes", "_hex", "_h")

    def __init__(self, b: bytes):
        if not isinstance(b, bytes) or len(b) != self.LEN:
            raise ValueError(
                f"{type(self).__name__} requires {self.LEN} bytes, got {b!r}")
        self._bytes = b

    @classmethod
    def random(cls) -> "BaseID":
        return cls(_rand_bytes(cls.LEN))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(b"\x00" * cls.LEN)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.LEN

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        # cached: ids are hex()'d on every lifecycle event / metrics tag
        # of every task — a lazy slot beats re-encoding each time
        try:
            return self._hex
        except AttributeError:
            h = self._hex = self._bytes.hex()
            return h

    @classmethod
    def from_hex(cls, h: str) -> "BaseID":
        return cls(bytes.fromhex(h))

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._bytes == self._bytes

    def __hash__(self) -> int:
        # cached: ids key every hot dict (pending tasks, object meta,
        # reference counts); the tuple build per lookup adds up
        try:
            return self._h
        except AttributeError:
            h = self._h = hash((type(self).__name__, self._bytes))
            return h

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._bytes.hex()[:16]})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    LEN = JOB_ID_LEN


class NodeID(BaseID):
    LEN = NODE_ID_LEN


class WorkerID(BaseID):
    LEN = WORKER_ID_LEN


class PlacementGroupID(BaseID):
    LEN = PLACEMENT_GROUP_ID_LEN


class ActorID(BaseID):
    LEN = ACTOR_ID_LEN

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(_rand_bytes(8) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[8:])


class TaskID(BaseID):
    LEN = TASK_ID_LEN

    @classmethod
    def for_normal_task(cls, job_id: JobID) -> "TaskID":
        return cls(_rand_bytes(8) + b"\x00" * 8 + job_id.binary())

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(_rand_bytes(8) + actor_id.binary())

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[8:])

    def has_actor(self) -> bool:
        return self._bytes[8:16] != b"\x00" * 8

    def job_id(self) -> JobID:
        return JobID(self._bytes[16:])


class ObjectID(BaseID):
    LEN = OBJECT_ID_LEN

    @classmethod
    def for_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "big"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # Puts use the high bit of the index to avoid colliding with returns.
        return cls(task_id.binary() + (0x80000000 | put_index).to_bytes(4, "big"))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:TASK_ID_LEN])

    def index(self) -> int:
        return int.from_bytes(self._bytes[TASK_ID_LEN:], "big")

    def job_id(self) -> JobID:
        return self.task_id().job_id()
