"""Function table: ship task/actor code once, not once per submit.

Ref analog: the reference's function manager exports each remote
function/class to GCS KV exactly once per job and workers import it by
id (python/ray/_private/function_manager.py:58). Here the id rides the
TaskSpec and the blob travels at most once per worker connection
(piggybacked on the first push), with GCS KV as the durable miss path —
a spillback/retry landing on a fresh worker whose owner-connection never
saw the blob still recovers.

Owner side (:class:`FunctionTable`):
 * ``dumps_code`` runs ONCE per (function, job) — the dominant
   per-submit cost before this table (~30us of cloudpickle per task).
 * function_id = job hex + blake2b(blob): content-addressed, so a
   redefined function (new bytecode/closure) gets a new id while a
   re-decorated identical function reuses the cached entry.
 * every blob is published to GCS KV (``fn_table`` namespace) once, in
   the background for tasks and synchronously for actor creation (the
   spec reaches the executing worker via GCS, never over an owner
   connection that could piggyback the blob).

Worker side (:class:`FunctionCache`):
 * loaded code cached by id in an LRU (``fn_cache_size`` entries) with
   job-scoped eviction (``evict_job``) so one job's churn cannot pin
   another job's code out of the cache forever.
 * blobs arriving piggybacked on a push are staged by the RPC handler
   (before the executor hop) so later same-connection pushes that omit
   the blob always find either the staged bytes or the loaded entry.
 * a miss (LRU eviction, fresh worker after spillback/retry) fetches the
   blob from GCS KV with a short retry — the owner's background publish
   is racy only within the first few milliseconds of a job.
"""

from __future__ import annotations

import hashlib
import threading
import weakref
from collections import OrderedDict

import cloudpickle

# GCS KV namespace holding code blobs keyed by function_id
KV_NAMESPACE = "fn_table"


class FunctionTable:
    """Owner-side registry: function object -> (function_id, blob)."""

    def __init__(self):
        # weak-keyed so a dropped user function doesn't pin its blob here
        # (the worker LRU + GCS KV own the rest of the lifetime)
        self._by_fn: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._blobs: dict[str, bytes] = {}
        self._kv_pushed: set[str] = set()
        self._lock = threading.Lock()
        self.dumps_count = 0  # regression hook: serializations performed

    def register(self, fn, job_id) -> tuple[str, bytes]:
        """Return (function_id, blob) for `fn`, serializing at most once
        per (function, job)."""
        jh = job_id.hex()
        try:
            cached = self._by_fn.get(fn)
        except TypeError:  # unhashable/unweakrefable callable
            cached = None
        if cached is not None and cached[0] == jh:
            return cached[1], cached[2]
        from ray_tpu_torch._internal.serialization import dumps_code

        blob = dumps_code(fn)
        self.dumps_count += 1
        fid = jh + ":" + hashlib.blake2b(blob, digest_size=16).hexdigest()
        with self._lock:
            self._blobs[fid] = blob
        try:
            self._by_fn[fn] = (jh, fid, blob)
        except TypeError:
            pass
        return fid, blob

    def blob_for(self, fid: str) -> bytes | None:
        with self._lock:
            return self._blobs.get(fid)

    def needs_kv_push(self, fid: str) -> bool:
        """True exactly once per id — the caller owns the actual put."""
        with self._lock:
            if fid in self._kv_pushed:
                return False
            self._kv_pushed.add(fid)
            return True

    def kv_push_failed(self, fid: str):
        """A background publish died: let a later submit retry it."""
        with self._lock:
            self._kv_pushed.discard(fid)


class FunctionCache:
    """Worker-side loaded-code cache: function_id -> callable/class."""

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        self._loaded: OrderedDict[str, tuple[str, object]] = OrderedDict()
        self._staged: dict[str, bytes] = {}  # blobs awaiting first load
        self._lock = threading.Lock()
        self.misses = 0  # KV fetches (regression hook)

    def stage_blob(self, fid: str, blob: bytes):
        """Record a piggybacked blob before the executor hop (cheap, on
        the RPC loop) so a later push omitting the blob can't race the
        first one's load."""
        with self._lock:
            if fid not in self._loaded:
                self._staged[fid] = blob

    def resolve(self, fid: str, job_hex: str, fetch_blob):
        """Return the loaded function/class for `fid`. ``fetch_blob`` is
        the KV miss path: called (off the RPC loop) only when neither the
        LRU nor the staged blobs have the id."""
        with self._lock:
            hit = self._loaded.get(fid)
            if hit is not None:
                self._loaded.move_to_end(fid)
                return hit[1]
            blob = self._staged.pop(fid, None)
        if blob is None:
            self.misses += 1
            blob = fetch_blob(fid)
            if blob is None:
                raise RuntimeError(
                    f"function blob {fid!r} not in the GCS function "
                    "table (owner gone before publishing?)")
        fn = cloudpickle.loads(blob)
        with self._lock:
            self._loaded[fid] = (job_hex, fn)
            self._loaded.move_to_end(fid)
            while len(self._loaded) > self.capacity:
                self._loaded.popitem(last=False)
        return fn

    def evict_job(self, job_hex: str):
        """Drop every entry a finished job loaded (driver disconnect /
        job teardown): pooled workers outlive jobs."""
        with self._lock:
            for fid in [f for f, (jh, _) in self._loaded.items()
                        if jh == job_hex]:
                del self._loaded[fid]
            for fid in [f for f in self._staged if f.startswith(job_hex + ":")]:
                del self._staged[fid]

    def __len__(self):
        with self._lock:
            return len(self._loaded)
