"""Distributed reference counting (owner-side GC).

Ref analog: src/ray/core_worker/reference_count.h:66. Simplified borrowing
protocol for round 1:

* The owner of an object tracks: local Python refs, registered borrowers
  (processes that deserialized the ref), and task-argument pins (refs held
  by in-flight tasks the owner submitted).
* A borrower registers itself on deserialize and sends a release when its
  local count drops to zero.
* Refs serialized through opaque channels (inside a put object / return
  value) conservatively pin the object until job teardown ("escaped") —
  correct, may leak; the full borrower-chain accounting is future work.

When every count reaches zero the owner frees: memory-store entry dropped,
shm segment unlinked via the node manager.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Callable

from ray_tpu_torch._internal.ids import ObjectID

if TYPE_CHECKING:
    from ray_tpu_torch.core.object_ref import ObjectRef


class _Record:
    __slots__ = ("local", "borrowers", "task_pins", "escaped", "owned")

    def __init__(self, owned: bool):
        self.local = 0
        self.borrowers: set[str] = set()
        self.task_pins = 0
        self.escaped = 0
        self.owned = owned

    def total(self) -> int:
        return self.local + len(self.borrowers) + self.task_pins + self.escaped


class ReferenceCounter:
    def __init__(self, is_owner: Callable[[ObjectID], bool],
                 free_fn: Callable[[ObjectID], None],
                 notify_owner_fn: Callable[[ObjectID, object, str], None],
                 release_local_fn: Callable[[ObjectID], None] | None = None):
        """free_fn: called when an owned object's count hits 0.
        notify_owner_fn(oid, owner, kind): send add/remove-borrower to a
        remote owner (fire-and-forget).
        release_local_fn(oid): called when the last LOCAL ref to a
        borrowed object drops — unpins this process's zero-copy shm
        mappings (owned objects go through free_fn, which unpins too)."""
        self._lock = threading.RLock()
        self._records: dict[ObjectID, _Record] = {}
        # monotonically bumped by every count mutation: lets the object
        # -state reporter skip snapshot rebuilds on idle flush ticks
        self._version = 0
        self._is_owner = is_owner
        self._free = free_fn
        self._notify_owner = notify_owner_fn
        self._release_local = release_local_fn
        # Serialization context flag: when >0, refs being pickled are task
        # args (pinned via task_pins, not escaped).
        self._tls = threading.local()

    def _record(self, oid: ObjectID) -> _Record:
        rec = self._records.get(oid)
        if rec is None:
            rec = _Record(owned=self._is_owner(oid))
            self._records[oid] = rec
        return rec

    def has_record(self, oid: ObjectID) -> bool:
        """True while someone in this process holds a counted ref to oid
        (the zero-copy get path pins the shm mapping for that long)."""
        with self._lock:
            return oid in self._records

    # ---- local refs -------------------------------------------------
    def add_local_ref(self, ref: "ObjectRef"):
        with self._lock:
            self._record(ref.id).local += 1
            self._version += 1

    def remove_local_ref(self, ref: "ObjectRef"):
        to_free = None
        notify = None
        with self._lock:
            rec = self._records.get(ref.id)
            if rec is None:
                return
            rec.local = max(0, rec.local - 1)
            self._version += 1
            if rec.total() == 0:
                if rec.owned:
                    to_free = ref.id
                    del self._records[ref.id]
                else:
                    notify = (ref.id, ref.owner, "remove_borrower")
                    del self._records[ref.id]
        if to_free is not None:
            self._free(to_free)
        if notify is not None:
            if self._release_local is not None:
                self._release_local(notify[0])
            self._notify_owner(*notify)

    # ---- serialization events ---------------------------------------
    def begin_task_arg_serialization(self):
        self._tls.task_arg = getattr(self._tls, "task_arg", 0) + 1

    def end_task_arg_serialization(self):
        self._tls.task_arg = max(0, getattr(self._tls, "task_arg", 0) - 1)

    def on_ref_serialized(self, ref: "ObjectRef"):
        with self._lock:
            rec = self._record(ref.id)
            self._version += 1
            if getattr(self._tls, "task_arg", 0) > 0:
                pass  # pinned via add_task_pin by the submitter
            else:
                rec.escaped += 1

    def on_ref_deserialized(self, ref: "ObjectRef"):
        """Running in the receiving process: register as borrower."""
        with self._lock:
            rec = self._record(ref.id)
            rec.local += 1
            self._version += 1
        if not self._is_owner(ref.id) and ref.owner is not None:
            self._notify_owner(ref.id, ref.owner, "add_borrower")

    # ---- owner-side borrower registry --------------------------------
    def add_borrower(self, oid: ObjectID, borrower_key: str):
        with self._lock:
            rec = self._records.get(oid)
            if rec is None:
                # stale notify: the owner already freed the object (every
                # live owned object has a record — the owner's own refs
                # hold it). Creating one here would resurrect a zombie
                # record with borrowers={key} that nothing ever drops:
                # total() stays 1 forever, has_record() pins the shm
                # mapping for the process lifetime, and the snapshot
                # shows a borrower for an object that no longer exists.
                return
            rec.borrowers.add(borrower_key)
            self._version += 1

    def _drop_zero_record(self, oid: ObjectID, rec: _Record):
        """Remove a record whose count hit zero via a non-local-ref path
        (task pin / borrower). Must be called under the lock; returns the
        oid to free (owned) or None. Non-owned records are deleted too —
        a stale borrowed record would keep has_record() True forever and
        leak the zero-copy get pin tied to it."""
        del self._records[oid]
        return oid if rec.owned else None

    def remove_borrower(self, oid: ObjectID, borrower_key: str):
        to_free = None
        removed = False
        with self._lock:
            rec = self._records.get(oid)
            if rec is None:
                return
            rec.borrowers.discard(borrower_key)
            self._version += 1
            if rec.total() == 0:
                to_free = self._drop_zero_record(oid, rec)
                removed = True
        if to_free is not None:
            self._free(to_free)
        elif removed and self._release_local is not None:
            self._release_local(oid)

    # ---- task-argument pins ------------------------------------------
    def add_task_pin(self, oid: ObjectID):
        with self._lock:
            self._record(oid).task_pins += 1
            self._version += 1

    def remove_task_pin(self, oid: ObjectID):
        to_free = None
        removed = False
        with self._lock:
            rec = self._records.get(oid)
            if rec is None:
                return
            rec.task_pins = max(0, rec.task_pins - 1)
            self._version += 1
            if rec.total() == 0:
                to_free = self._drop_zero_record(oid, rec)
                removed = True
        if to_free is not None:
            self._free(to_free)
        elif removed and self._release_local is not None:
            self._release_local(oid)

    @property
    def version(self) -> int:
        """Mutation counter (racy read is fine: a missed bump is
        caught on the next flush tick)."""
        return self._version

    def stats(self) -> dict:
        with self._lock:
            return {
                "num_tracked": len(self._records),
                "num_owned": sum(1 for r in self._records.values() if r.owned),
                "num_escaped": sum(r.escaped for r in self._records.values()),
            }

    def debug_snapshot(self) -> dict[ObjectID, dict]:
        """Consistent point-in-time per-oid breakdown, taken in one lock
        hold so counts across objects are mutually coherent (a ref
        moving between objects can never show up twice or not at all).
        Feeds the object-state reports behind `rayt memory` /
        `state_api.list_objects` (ref analog: `ray memory` rendering
        reference_count.h's per-object local/submitted/borrower split)."""
        with self._lock:
            return {
                oid: {
                    "local": rec.local,
                    "borrowers": len(rec.borrowers),
                    "task_pins": rec.task_pins,
                    "escaped": rec.escaped,
                    "owned": rec.owned,
                    "total": rec.total(),
                }
                for oid, rec in self._records.items()
            }
