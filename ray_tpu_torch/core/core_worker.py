"""CoreWorker — the per-process runtime (driver and workers alike).

Ref analog: src/ray/core_worker/core_worker.h:166 plus its transport stack
(normal_task_submitter.h:108, actor_task_submitter.h:75, scheduling
queues), task_manager.h:212 (retries), memory_store.h:42.

Threading model: user code runs on its own threads and calls the sync API,
which hops onto a dedicated asyncio IO loop (EventLoopThread — the analog
of the C++ io_service threads). Task execution happens on executor
threads; async actors get their own asyncio loop.
"""

from __future__ import annotations

import asyncio
import collections
import os
import socket
import sys
import threading
import time
import traceback
import weakref
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any

import cloudpickle

from ray_tpu_torch._internal.config import get_config
from ray_tpu_torch._internal.ids import (ActorID, JobID, NodeID, ObjectID, TaskID,
                                         WorkerID)
from ray_tpu_torch._internal.logging_utils import setup_logger
from ray_tpu_torch._internal.rpc import (Connection, ConnectionLost, RemoteError,
                                         RpcError, RpcServer, EventLoopThread,
                                         connect)
from ray_tpu_torch._internal.serialization import (
    chunks_to_bytes, deserialize, serialize, serialize_to_bytes,
    serialized_size)
from ray_tpu_torch.core.common import (ActorDiedError, ActorState, Address,
                                       GetTimeoutError,
                                       NodeAffinitySchedulingStrategy,
                                       NodeLabelSchedulingStrategy,
                                       ObjectLostError, ObjectMeta,
                                       PlacementGroupSchedulingStrategy,
                                       TaskCancelledError, TaskError, TaskSpec,
                                       WorkerCrashedError, WorkerInfo,
                                       parse_lease_token)
from ray_tpu_torch.core.gcs import CH_ACTOR, CH_NODE, CH_OBJECTS, GcsClient
from ray_tpu_torch.core.object_ref import ObjectRef, set_core_worker
from ray_tpu_torch.core.device_objects import (DeviceObjectStore,
                                               deserialize_array, gpu_lease,
                                               is_device_value)
from ray_tpu_torch.core.object_store import MemoryStore, make_shm_store
from ray_tpu_torch.core.reference_counter import ReferenceCounter

logger = setup_logger("core_worker")

_TASK_PUSH_TIMEOUT = 7 * 24 * 3600.0

# Hot-path modules resolved ONCE at import: the submit path used to pay a
# try/except import of builtin_metrics and an otel import per task
# submission. Telemetry stays optional — a stripped build leaves _bm None
# and every use is guarded.
from ray_tpu_torch._internal import otel as _otel

try:
    from ray_tpu_torch.util import builtin_metrics as _bm
except Exception:  # pragma: no cover - stripped/minimal builds
    _bm = None


def _trace_carrier():
    """Active OTel span context for TaskSpec.trace_ctx (None when
    tracing is off — the common, zero-overhead case)."""
    if not _otel.tracing_enabled():
        return None
    return _otel.current_context_carrier()


# package root (sep-terminated: a sibling dir like .../ray_tpu_ext must
# NOT match), for skipping our own frames during callsite capture
_PKG_PREFIX = os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))) + os.sep

# keep per-callsite cardinality + report size bounded: last two path
# segments, hard char cap
_CALLSITE_CAP = 160

# re-send a flagged leak's held-duration once it aged this much past the
# last sent value, so `rayt list objects --leaked` shows a real age, not
# the flag-time ~grace seconds frozen forever
_LEAK_AGE_RESEND_S = 5.0


def _capture_callsite() -> str:
    """First stack frame outside the ray_tpu_torch package as ``file:line``,
    truncated to the last two path segments (ref analog: `ray memory`'s
    call-site column, RAY_record_ref_creation_sites). Cost is a few
    sys._getframe hops — cheap enough for the rt.put hot path; gated by
    object_state_enabled at the call sites."""
    try:
        f = sys._getframe(2)
    except ValueError:  # pragma: no cover - shallow stack
        return ""
    depth = 0
    while f is not None and depth < 32:
        fn = f.f_code.co_filename
        if not fn.startswith(_PKG_PREFIX):
            parts = fn.replace("\\", "/").rsplit("/", 2)
            short = "/".join(parts[-2:]) if len(parts) > 1 else fn
            return f"{short}:{f.f_lineno}"[:_CALLSITE_CAP]
        f = f.f_back
        depth += 1
    return ""


def _dumps_code_now(fn) -> bytes:
    """Uncached code pickle — only for specs that bypass the function
    table (runtime_env tasks, whose code loads under the materialized
    env on every execution)."""
    from ray_tpu_torch._internal.serialization import dumps_code

    return dumps_code(fn)


@dataclass
class RefArg:
    """Marker for an ObjectRef positioned as a top-level task argument."""
    object_id: ObjectID
    owner: WorkerInfo | None


@dataclass
class _PendingTask:
    spec: TaskSpec
    retries_left: int
    pinned: list[ObjectID] = field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    running_on: Any = None     # WorkerInfo while pushed to a worker
    t_sched: float | None = None  # submit time until the first grant


@dataclass
class _LeasePool:
    """Per-scheduling-key lease pipeline state (ref analog: the
    per-SchedulingKey entry in normal_task_submitter.h:108): tasks
    parked for a worker, idle leased workers kept warm, and the number
    of leases expected from in-flight (batched) requests against the
    cluster. ``queue`` holds ready-to-push (spec, pt, strategy) entries;
    it is a deque because BOTH the IO loop (on lease grant) and direct
    reader threads (chaining the next task onto a just-freed lease,
    with no loop round-trip) claim from it — a pop IS the claim, and
    deque ops are atomic under the GIL. Cancelled entries are skipped
    at claim time (pt.done is set by the cancel path). ``fetches``
    counts in-flight RPCs: batched pools keep at most two outstanding
    (one possibly queued at a saturated node manager, one sized to the
    tasks that arrived since), so a burst of N submits costs
    O(N / batch) round-trips, not N."""
    idle: list = field(default_factory=list)       # [(winfo, token, nm_addr)]
    queue: collections.deque = field(default_factory=collections.deque)
    inflight: int = 0                              # leases in-flight
    fetches: int = 0                               # RPCs in-flight
    # guards idle: claimed by submitting user threads AND the loop (the
    # idle-expiry sweep must not race a concurrent claim)
    idle_lock: threading.Lock = field(default_factory=threading.Lock)
    # one armed fetch-check ring per pool: a submit burst parks tasks
    # without waking the loop per task; the single armed request's
    # _maybe_fetch_leases sees every entry parked before it ran
    fetch_armed: bool = False


class _ExecutionContext(threading.local):
    task_id: TaskID | None = None
    job_id: JobID | None = None     # owning job of the executing task


# sentinel returned by the direct-path actor dispatch: "exec mutex is
# held, run the body inline on the calling connection thread"
_INLINE = object()


def _push_strategy(spec: TaskSpec):
    """Scheduling strategy as the lease pools see it (PG strategies were
    already rewritten into bundle-reserved demand at submit)."""
    strat = spec.scheduling_strategy
    if isinstance(strat, PlacementGroupSchedulingStrategy):
        return None
    return strat


class _LeaseChain:
    """Shared in-flight accounting for one leased worker running a
    pipeline of direct pushes. The lease is disposed of exactly once —
    by whichever completion/error callback decrements ``inflight`` to
    zero with nothing left to chain; ``disposed`` is set under the same
    lock hold so a racing fill (e.g. the dispatching thread between its
    send and its pipeline top-up) can never push onto a lease already
    queued for return."""

    __slots__ = ("inflight", "disposed", "lock")

    # tasks kept in flight per lease under burst pressure: the worker's
    # next request is already in its socket buffer when it finishes the
    # current one, so neither side blocks (nor pays a wake) between
    # tasks of a wave
    DEPTH = 2

    def __init__(self):
        self.inflight = 0
        self.disposed = False
        self.lock = threading.Lock()

    def acquire_one(self) -> bool:
        """Claim a pipeline slot; False once the chain is disposed (the
        caller must not push on this lease)."""
        with self.lock:
            if self.disposed:
                return False
            self.inflight += 1
            return True

    def release_one(self) -> bool:
        """Decrement; True (exactly once per chain) when this drop hit
        zero — the caller owns lease disposal."""
        with self.lock:
            self.inflight -= 1
            if self.inflight == 0 and not self.disposed:
                self.disposed = True
                return True
            return False

    def try_dispose(self) -> bool:
        """Dispose if idle: True (exactly once per chain) when nothing
        is in flight and no one disposed yet."""
        with self.lock:
            if self.inflight == 0 and not self.disposed:
                self.disposed = True
                return True
            return False


# pipeline past one in-flight push only when at least this many tasks
# are parked: below it, a stolen second task could have run in parallel
# on a lease grant that is still in flight (see _fill_chain)
_PIPELINE_MIN_QUEUE = 32


class _SeqGate:
    """Per-caller actor-task ordering gate, usable from BOTH the asyncio
    handler (loop thread, non-blocking try_enter + rare 1ms poll) and
    direct-call connection threads (blocking enter). Dispatch runs UNDER
    the gate lock so the executor queue order equals seq order — with
    preemptible threads, advancing the gate and submitting must be one
    atomic step or two racing calls could start out of order.

    Semantics mirror the old asyncio Condition logic: a call may start
    once ``next >= seq``; only the exact ``next == seq`` call advances
    the gate (stale seqs from a previous incarnation pass through)."""

    __slots__ = ("next", "cond")

    def __init__(self):
        self.next = 0
        self.cond = threading.Condition()

    def try_enter(self, seq: int, dispatch):
        """Non-blocking: (True, dispatch()) if `seq` may start now.
        Non-blocking on the GATE LOCK too — a direct-call thread may
        hold it while waiting for the exec mutex (its dispatch claims
        the mutex under the lock for start-ordering), and this form
        runs on the worker's IO loop, which must never park behind a
        running task body. The caller already polls on False."""
        if not self.cond.acquire(blocking=False):
            return False, None
        try:
            if self.next < seq:
                return False, None
            if self.next == seq:
                self.next = seq + 1
                try:
                    out = dispatch()
                finally:
                    # notify even when dispatch raises (teardown races:
                    # closed actor loop, shut-down executor) — the gate
                    # HAS advanced, so parked successors must recheck
                    # or they wait forever on a true predicate
                    self.cond.notify_all()
                return True, out
            return True, dispatch()
        finally:
            self.cond.release()

    def enter(self, seq: int, dispatch):
        """Blocking form for direct-call threads."""
        with self.cond:
            while self.next < seq:
                self.cond.wait()
            if self.next == seq:
                self.next = seq + 1
                try:
                    out = dispatch()
                finally:
                    self.cond.notify_all()  # see try_enter: exceptions
                    # must not strand successors behind an advanced gate
                return out
            return dispatch()


class _ShmGetPin:
    """Pin bookkeeping for ONE zero-copy get: the store's get-ref is held
    while ``count`` > 0. Slots: one per live out-of-band buffer wrapper
    (the numpy views handed to pickle — reconstructed arrays keep them
    alive as their buffer base) plus, optionally, one for the local
    ObjectRef(s), dropped when the last counted ref dies.

    Reentrancy design (a GC can fire ObjectRef.__del__ at ANY allocation,
    including inside store internals): wrapper finalizers and the
    ref-drop path only ever append to the owner's event deque
    (reentrancy-safe, lock-free); every count mutation after seal() and
    every ``store.release`` happens inside CoreWorker._drain_pin_events,
    whose locks are all acquired non-blocking. Wrappers are held by
    STRONG refs until seal() arms their finalizers, so no event for this
    pin can exist before its count is final.
    Ref analog: plasma's client-side object refcount, which keeps a
    Get() buffer mapped until the last PlasmaBuffer is destroyed."""

    __slots__ = ("oid", "_events", "_count", "_wrappers")

    def __init__(self, oid: ObjectID, events: collections.deque):
        self.oid = oid
        self._events = events
        self._count = 1          # guard until seal()/abort()
        self._wrappers: list = []

    @property
    def n_wrappers(self) -> int:
        return len(self._wrappers)

    def wrap(self, view: memoryview):
        """buffer_wrapper for deserialize(): interpose a weakref-able
        holder between pickle and the raw shm view."""
        import numpy as np

        w = np.frombuffer(view, dtype=np.uint8)
        self._wrappers.append(w)  # strong ref: finalizer armed at seal()
        return w

    def seal(self, ref_held: bool) -> bool:
        """Fix the slot count and arm the wrapper finalizers. True =>
        nothing pins the mapping (no views, no counted ref): the caller
        must queue this pin on the event deque, whose drain drops the
        remaining guard slot and releases the store's get-ref."""
        wrappers, self._wrappers = self._wrappers, []
        self._count = len(wrappers) + (1 if ref_held else 0)
        if self._count == 0:
            self._count = 1  # consumed by the caller's queued event
            return True
        for w in wrappers:
            weakref.finalize(w, self._events.append, self)
        return False

    def abort(self):
        """Deserialize failed: drop the wrapper refs and queue one
        release for the store's get-ref."""
        self._wrappers = []
        self._count = 1
        self._events.append(self)

    def dec(self) -> bool:
        """One slot died. Called ONLY under the owner's drain lock (the
        single consumer), so no pin-level lock is needed. True => last
        slot: the drain releases the store's get-ref."""
        self._count -= 1
        return self._count == 0


class CoreWorker:
    def __init__(self, mode: str, job_id: JobID, gcs_address: Address,
                 node_address: Address, node_id: NodeID):
        assert mode in ("driver", "worker")
        self.mode = mode
        self.job_id = job_id
        self.gcs_address = gcs_address
        self.node_address = node_address
        self.node_id = node_id
        self.worker_id = WorkerID.random()
        self.io = EventLoopThread()
        self.server = RpcServer()
        self.server.add_service(self)
        self.memory_store = MemoryStore(self.io.loop)
        self.shm = make_shm_store(node_id)
        # device-resident objects held by THIS worker process
        # (payloads held by this process; see device_objects.py)
        self.device_store = DeviceObjectStore()
        self.object_meta: dict[ObjectID, ObjectMeta] = {}
        self._object_events: dict[ObjectID, asyncio.Event] = {}
        self.pending_tasks: dict[TaskID, _PendingTask] = {}
        self._return_to_task: dict[ObjectID, TaskID] = {}
        # streaming-generator tasks we own (ref: generator_waiter.cc)
        self._streams: dict[TaskID, Any] = {}
        # zero-copy get pins: oid -> pins holding a live ref-holder slot;
        # _pin_events queues slot-death notifications (finalizer-safe)
        self._shm_pins: dict[ObjectID, list[_ShmGetPin]] = {}
        self._pin_lock = threading.Lock()
        self._pin_events: collections.deque = collections.deque()
        self._pin_drain_lock = threading.Lock()
        self.reference_counter = ReferenceCounter(
            is_owner=self._owns, free_fn=self._free_object,
            notify_owner_fn=self._notify_owner_refcount,
            release_local_fn=self._release_shm_pins)
        # object-plane observability (`rayt memory` feed): creation
        # callsite + timestamp per owned object, leak-watchdog state,
        # and the last published report for delta computation
        self._object_state_enabled = get_config().object_state_enabled
        self._object_sites: dict[ObjectID, tuple[str, float]] = {}
        self._leak_since: dict[ObjectID, float] = {}
        self._leaked: set[ObjectID] = set()
        self._obj_report_last: dict = {"refs": {}, "pins": {}, "leaks": {}}
        # bumped by the reconnect-reset: a baseline built BEFORE a GCS
        # restart must not be committed after it (the restarted store
        # is empty — stale baselines suppress the full re-send)
        self._obj_report_epoch = 0
        # owner-meta mutation counter (sites/sizes recorded at put /
        # task completion / free): with the refcounter version, lets an
        # idle flush tick skip the O(owned-objects) snapshot rebuild
        self._obj_meta_version = 0
        # shm args of CURRENTLY-EXECUTING task bodies: their get-pins
        # are counted at the SUBMITTER, not here, so the watchdog must
        # treat them as healthy (a 5s+ training step would otherwise
        # flag every big arg as a leak). oid -> executing-body count.
        self._arg_pins: collections.Counter = collections.Counter()
        self._arg_pins_lock = threading.Lock()
        self.root_task_id = TaskID.for_normal_task(job_id)
        self._exec_ctx = _ExecutionContext()
        # GPUs of this worker's lease: an actor's for its lifetime, a
        # normal task's while it runs (device_objects.rebuild_device),
        # and the cards they are (CUDA_VISIBLE_DEVICES names; the private
        # accelerators.lease_gpu_ids reads them)
        self.leased_gpus = 0.0
        self.leased_gpu_ids: tuple = ()
        self._put_index = 0
        self._put_lock = threading.Lock()
        self._conns: dict[str, Connection] = {}
        self._conn_locks: dict[str, asyncio.Lock] = {}
        self._node_addrs: dict[NodeID, Address] = {}
        self._dead_nodes: set[NodeID] = set()
        self._lease_cache: dict[tuple, _LeasePool] = {}
        self.lease_rpcs_sent = 0   # request_lease round-trips (perf hook)
        self._actor_submitters: dict[ActorID, _ActorTaskSubmitter] = {}
        # function table (core/function_table.py): owner side hashes +
        # publishes code once per (function, job); worker side caches
        # loaded code by id with a KV-backed miss path
        from ray_tpu_torch.core.function_table import FunctionCache, FunctionTable

        self.fn_table = FunctionTable()
        self.fn_cache = FunctionCache(get_config().fn_cache_size)
        # sync fast-lane waiters: return-object id -> threading.Event set
        # by a direct-actor reader thread when the result lands
        self._sync_waiters: dict[ObjectID, threading.Event] = {}
        # serializes _complete_task/_fail_task terminal bookkeeping across
        # the IO loop and direct-actor reader threads
        self._completion_lock = threading.RLock()
        # worker-wide execution mutex: serializes sync task/actor bodies
        # across ALL execution paths (the max_workers=1 executor, and
        # direct-channel connection threads running bodies inline).
        # RLock: the inline dispatch pre-acquires it under the seq-gate
        # lock for start-ordering, then the body re-acquires it.
        self._exec_mutex = threading.RLock()
        # worker-mode execution state
        self.executor = ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="rayt-exec")
        self._running_normal_task: TaskID | None = None
        self._exec_thread_ident: int | None = None
        self.actor_instance = None
        self.actor_id: ActorID | None = None
        self._actor_async_loop: EventLoopThread | None = None
        self._actor_gates: dict[str, _SeqGate] = {}
        # direct-call plane (core/direct.py): server on workers, client
        # cache on owners
        self._direct_server = None
        self._direct_clients: dict[tuple, Any] = {}
        self._direct_lock = threading.Lock()
        # reader-less direct clients for the sync fast lane: the GETTER
        # thread pumps replies itself (direct.DirectClient.drive)
        self._sync_direct_clients: dict[tuple, Any] = {}
        # ObjectID -> sync-mode client owing its completion; getters use
        # it to route their wait into drive() instead of an event park
        self._sync_read_owners: dict[ObjectID, Any] = {}
        # method name -> is-async (worker side; instance methods are
        # fixed for the worker's lifetime)
        self._method_kind: dict[str, bool] = {}
        self._shutdown = False
        # approximate in-flight count backing the queue-depth gauge
        # (racy += is fine for telemetry; never used for control flow)
        self._inflight_tasks = 0
        # every fire-and-forget coroutine goes through _spawn (on-loop) or
        # _spawn_from_thread (foreign threads) so shutdown can
        # cancel-and-await them: an abandoned pending task at loop
        # teardown prints "Task was destroyed but it is pending!" and can
        # mask a real hang. _closing gates late spawns during the sweep.
        self._bg_tasks: set[asyncio.Task] = set()
        self._closing = False
        # batched loop wakeups for _spawn_from_thread (see its docstring)
        self._spawn_queue: collections.deque = collections.deque()
        self._spawn_wake_lock = threading.Lock()
        self._spawn_wake_pending = False
        # leases finished by direct-channel reader threads, parked here
        # for loop-side recycling (pool structures are loop-affine);
        # entries: (demand, winfo, token, nm_addr, strategy, reusable)
        self._lease_returns: collections.deque = collections.deque()
        # lease-fetch checks requested by user-thread submits, drained
        # by the loop; entries: (key, demand, pool, strategy)
        self._fetch_requests: collections.deque = collections.deque()
        self.gcs: GcsClient | None = None
        self.node_conn: Connection | None = None
        self.worker_info: WorkerInfo | None = None
        # task-event tracing (ref: task_event_buffer.cc); flushed to the
        # GCS ring by _task_event_flush_loop, rendered by `rayt timeline`
        from ray_tpu_torch._internal.tracing import TaskEventBuffer

        self.task_events = TaskEventBuffer(self.worker_id.hex(),
                                           self.node_id.hex())
        # pre-bound metric handles (tag merge + key sort paid once, not
        # per task); None when telemetry is unavailable
        self._m_submitted = self._m_queue_depth = None
        self._m_finished = self._m_sched_lat = self._m_exec_lat = None
        if _bm is not None:
            try:
                owner = {"owner": self.worker_id.hex()[:12]}
                self._m_submitted = _bm.tasks_submitted.with_tags()
                self._m_queue_depth = _bm.task_queue_depth.with_tags(owner)
                self._m_finished = {
                    "ok": _bm.tasks_finished.with_tags({"status": "ok"}),
                    "error": _bm.tasks_finished.with_tags(
                        {"status": "error"}),
                }
                self._m_sched_lat = _bm.task_sched_latency.with_tags()
                self._m_exec_lat = {
                    "task": _bm.task_exec_latency.with_tags(
                        {"kind": "task"}),
                    "actor": _bm.task_exec_latency.with_tags(
                        {"kind": "actor"}),
                }
            except Exception:
                pass

    def _emit_task_event(self, spec: TaskSpec, state: str, *,
                         error: dict | None = None):
        """Record one lifecycle state transition for `spec` (ref:
        task_event_buffer.cc RecordTaskStatusEvent). Never fails the
        caller — telemetry must not break submission/execution. The
        attempt number rides the spec (set by the submitter before each
        dispatch), so worker-side events carry it too."""
        try:
            if spec.is_actor_creation:
                kind = "actor_creation"
            elif spec.actor_id is not None:
                kind = "actor_task"
            else:
                kind = "task"
            self.task_events.record_transition(
                task_id=spec.task_id.hex(),
                name=spec.name or spec.method_name or "task",
                kind=kind, state=state, job_id=spec.job_id.hex(),
                actor_id=spec.actor_id.hex() if spec.actor_id else "",
                attempt=getattr(spec, "attempt", 0), error=error,
                # demand shape on the submit-side transition only: the
                # why-pending join key (a dict ref, not a copy)
                resources=(spec.resources
                           if state == "PENDING_ARGS" else None))
        except Exception:
            pass

    def _spawn(self, coro) -> "asyncio.Task | None":
        """ensure_future + lifetime tracking (must run on the IO loop).
        During the shutdown sweep new background work is dropped — a task
        scheduled after the cancel-and-await would be destroyed pending."""
        if self._closing:
            coro.close()
            return None
        t = asyncio.ensure_future(coro)
        self._bg_tasks.add(t)
        t.add_done_callback(self._bg_tasks.discard)
        return t

    def _spawn_from_thread(self, coro) -> None:
        """Thread-safe fire-and-forget onto the IO loop, shutdown-tracked
        (the raw io.spawn future is untracked — fine only when the caller
        awaits it). Wakeups are batched: a submit burst from the user
        thread queues its coroutines and rings the loop's self-pipe ONCE
        per drain, not once per submission (each call_soon_threadsafe
        wakeup costs a syscall + a GIL handoff on small hosts)."""
        if self._closing:
            # io.stop() halts the loop without closing it, so a
            # post-shutdown call_soon_threadsafe would "succeed" and the
            # callback never run, leaking a never-awaited coroutine
            coro.close()
            return
        self._spawn_queue.append(coro)
        self._ring_loop()

    def _drain_spawn_queue(self):
        """Runs on the IO loop: start every queued coroutine. The wake
        flag clears FIRST so a concurrent append re-arms the wakeup (it
        may also be drained right here — an extra no-op drain is
        harmless)."""
        with self._spawn_wake_lock:
            self._spawn_wake_pending = False
        self._drain_lease_returns()
        while True:
            try:
                key, demand, pool, strat = self._fetch_requests.popleft()
            except IndexError:
                break
            pool.fetch_armed = False
            self._maybe_fetch_leases(key, demand, pool, strat)
        while True:
            try:
                coro = self._spawn_queue.popleft()
            except IndexError:
                break
            self._spawn(coro)

    def _ring_loop(self):
        """Schedule one batched _drain_spawn_queue on the IO loop
        (thread-safe, at most one wakeup outstanding)."""
        with self._spawn_wake_lock:
            if self._spawn_wake_pending:
                return
            self._spawn_wake_pending = True
        try:
            self.io.loop.call_soon_threadsafe(self._drain_spawn_queue)
        except RuntimeError:  # loop already closed (shutdown tail)
            with self._spawn_wake_lock:
                self._spawn_wake_pending = False
            while True:  # close queued coros: avoid never-awaited leaks
                try:
                    self._spawn_queue.popleft().close()
                except IndexError:
                    break

    def _queue_lease_return(self, demand, winfo, token, nm_addr, strategy,
                            reusable: bool):
        """Reader-thread side of lease recycling: park the finished
        lease and ring the loop once per batch (the next submit's spawn
        drain also picks these up, so a busy pipeline recycles leases
        without a dedicated wakeup)."""
        self._lease_returns.append(
            (demand, winfo, token, nm_addr, strategy, reusable))
        self._ring_loop()

    def _drain_lease_returns(self):
        """Loop side: recycle or release every lease parked by direct
        reader threads."""
        while True:
            try:
                demand, winfo, token, nm_addr, strategy, reusable = \
                    self._lease_returns.popleft()
            except IndexError:
                return
            if reusable and not self._shutdown:
                self._recycle_lease(demand, winfo, token, nm_addr,
                                    strategy)
            else:
                self._spawn(self._release_lease(winfo, token, nm_addr,
                                                reusable=False))

    # ------------------------------------------------------------ bootstrap
    def connect_cluster(self):
        self.io.run(self._async_connect())
        set_core_worker(self)

    async def _async_connect(self):
        host = "127.0.0.1"
        port = await self.server.start(host, 0)
        direct_port = 0
        if self.mode == "worker":
            from ray_tpu_torch.core.direct import DirectServer

            self._direct_server = DirectServer({
                "push_task": self._direct_push_task,
                "push_actor_task": self._direct_push_actor_task,
            })
            direct_port = self._direct_server.port
        self.worker_info = WorkerInfo(self.worker_id, self.node_id,
                                      Address(host, port),
                                      direct_port=direct_port)
        self.gcs = await GcsClient.connect(self.gcs_address)
        self.node_conn = await connect(self.node_address.host,
                                       self.node_address.port)
        for n in await self.gcs.get_all_nodes():
            self._node_addrs[n.node_id] = n.address

        def on_node_event(msg):
            info = msg["node"]
            if msg["event"] == "added":
                self._node_addrs[info.node_id] = info.address
                self._dead_nodes.discard(info.node_id)
            elif msg["event"] == "removed":
                # Prune the dead node from location metadata so gets stop
                # trying to pull from it; objects whose only copies lived
                # there become candidates for lineage reconstruction (ref:
                # object_recovery_manager.h:38).
                self._dead_nodes.add(info.node_id)
                self._node_addrs.pop(info.node_id, None)
                for meta in self.object_meta.values():
                    if info.node_id in meta.node_ids:
                        meta.node_ids.remove(info.node_id)

        await self.gcs.subscribe(CH_NODE, on_node_event)

        def on_actor_event(info):
            sub = self._actor_submitters.get(info.actor_id)
            if sub is not None:
                self._spawn(sub.on_actor_update(info))

        await self.gcs.subscribe(CH_ACTOR, on_actor_event)
        # a restarted GCS has an EMPTY object manager: reset the delta
        # baseline so the next flush re-sends this process's full
        # object state (node managers do the same on re-register)
        self.gcs.on_reconnect.append(self._reset_object_report_baseline)
        self._spawn(self._task_event_flush_loop())
        if self.mode == "worker":
            await self.node_conn.call(
                "register_worker", (self.worker_info, os.getpid()))

    def shutdown(self):
        if self._shutdown:
            return
        self._shutdown = True
        set_core_worker(None)
        try:
            self.io.run(self._async_shutdown(), timeout=5)
        except Exception:
            pass
        self.executor.shutdown(wait=False)
        self.io.stop()

    async def _async_shutdown(self):
        # stop background work BEFORE tearing down connections: a lease
        # expiry or flush tick racing the close would error, and any task
        # still pending when the loop stops prints "Task was destroyed".
        # _closing first, so a cancelled task's cleanup can't re-spawn.
        self._closing = True
        for t in list(self._bg_tasks):
            t.cancel()
        if self._bg_tasks:
            await asyncio.gather(*list(self._bg_tasks),
                                 return_exceptions=True)
        self._bg_tasks.clear()
        for pool in self._lease_cache.values():
            for winfo, token, nm_addr, _ in pool.idle:
                await self._release_lease(winfo, token, nm_addr,
                                          reusable=False)
            pool.idle.clear()
        self._lease_cache.clear()
        for cache in (self._direct_clients, self._sync_direct_clients):
            for dc in cache.values():
                try:
                    dc.close()
                except Exception:
                    pass
            cache.clear()
        if self._direct_server is not None:
            self._direct_server.close()
        for conn in self._conns.values():
            await conn.close()
        if self.gcs is not None:
            await self.gcs.close()
        if self.node_conn is not None:
            await self.node_conn.close()
        await self.server.stop()
        self.shm.close()

    # ---------------------------------------------------------- connections
    async def _conn_to(self, address: Address) -> Connection:
        key = address.key()
        lock = self._conn_locks.setdefault(key, asyncio.Lock())
        async with lock:
            conn = self._conns.get(key)
            if conn is None or conn.closed:
                conn = await connect(address.host, address.port)
                self._conns[key] = conn
            return conn

    # ------------------------------------------------------------ ownership
    def _owns(self, oid: ObjectID) -> bool:
        meta = self.object_meta.get(oid)
        if meta is not None or self.memory_store.contains(oid):
            return True
        return oid in self._return_to_task

    def current_task_id(self) -> TaskID:
        return self._exec_ctx.task_id or self.root_task_id

    def _free_shm_copies(self, meta: ObjectMeta):
        """Tell every node holding a shm copy of the object to drop its
        pin (ref: the free_objects path through the local object
        manager). Fire-and-forget from any thread."""
        oid = meta.object_id

        async def _free():
            try:
                for nid in meta.node_ids:
                    if nid == self.node_id:
                        await self.node_conn.call("free_object", oid)
                    else:
                        addr = self._node_addrs.get(nid)
                        if addr is not None:
                            c = await self._conn_to(addr)
                            await c.call("free_object", oid)
            except Exception:
                pass
        try:
            self._spawn_from_thread(_free())
        except Exception:
            pass

    # ------------------------------------------------- zero-copy get pins
    def _release_shm_pins(self, oid: ObjectID):
        """The last counted local ref to oid died: queue a sentinel that
        drops the registered pin's ref-holder slot (live buffer views
        keep their own slots, so the mapping stays pinned until they die
        too). This runs from ObjectRef.__del__ — i.e. potentially inside
        a GC triggered ANYWHERE, including while this very thread holds
        the pin or store locks — so it must only append + try-drain.
        Fast exit when no zero-copy pins exist at all (the common case
        for inline-result workloads): a registration racing this check
        reclaims its own orphan slot (see _load_shm_value)."""
        if self._shm_pins:
            self._pin_events.append(oid)
        if self._pin_events:
            self._drain_pin_events()

    def _drain_pin_events(self):
        """Process queued pin-slot deaths and release store get-refs.
        Single-consumer, and every lock here is acquired NON-blocking: a
        reentrant call (a GC collecting an ObjectRef while this thread
        is inside the pin registration block or store internals) bails
        out or requeues, leaving its events for the active drainer / the
        periodic flush loop. Events are either _ShmGetPin (one slot
        died) or an ObjectID sentinel (ref-holder slot drop)."""
        if not self._pin_drain_lock.acquire(blocking=False):
            return
        try:
            requeue = []
            while True:
                try:
                    ev = self._pin_events.popleft()
                except IndexError:
                    break
                if isinstance(ev, _ShmGetPin):
                    pins = (ev,)
                elif self._pin_lock.acquire(blocking=False):
                    try:
                        pins = tuple(self._shm_pins.pop(ev, ()))
                    finally:
                        self._pin_lock.release()
                else:
                    requeue.append(ev)  # registration in progress: later
                    continue
                for pin in pins:
                    if pin.dec():
                        try:
                            self.shm.release(pin.oid)
                        except Exception:
                            pass
            self._pin_events.extend(requeue)
        finally:
            self._pin_drain_lock.release()

    def _free_object(self, oid: ObjectID):
        self._release_shm_pins(oid)
        self.memory_store.delete(oid)
        self._object_sites.pop(oid, None)
        self._obj_meta_version += 1
        meta = self.object_meta.pop(oid, None)
        if meta is not None and meta.in_shm:
            # drop THIS process's cached store mapping too: the
            # fallback store's create path caches one that no _ShmGetPin
            # tracks, so without this the creator keeps the segment
            # mapped for its whole lifetime after the last ref died —
            # exactly the drift the leak watchdog flags. Store-specific
            # API: the native arena must NOT release here (its get-refs
            # belong to live zero-copy views; fallback mappings park as
            # zombies under live views, so dropping is always safe).
            drop = getattr(self.shm, "drop_cached_mapping", None)
            if drop is not None:
                try:
                    drop(oid)
                except Exception:
                    pass
        # Lineage retention (ref: task_manager.h:212 lineage pinning): the
        # VALUE is freed, but a reconstructable task's spec is kept so a
        # downstream task that lost its own output can transitively
        # re-execute this producer. Bounded by max_lineage_entries.
        tid = self._return_to_task.get(oid)
        keep_lineage = False
        if tid is not None:
            pt = self.pending_tasks.get(tid)
            keep_lineage = (
                pt is not None and pt.spec.actor_id is None
                and pt.spec.max_retries > 0
                and len(self.pending_tasks)
                < get_config().max_lineage_entries)
        if not keep_lineage:
            self._return_to_task.pop(oid, None)
            if tid is not None:
                pt = self.pending_tasks.get(tid)
                if pt is not None and pt.done:
                    self.pending_tasks.pop(tid, None)
        if meta is not None and meta.in_shm:
            self._free_shm_copies(meta)
        if meta is not None and meta.in_device:
            self.device_store.delete(oid)
            holder = meta.holder
            if holder is not None and holder.worker_id != self.worker_id:
                async def _free_dev():
                    try:
                        c = await self._conn_to(holder.address)
                        await c.call("free_device_object", oid)
                    except Exception:
                        pass
                try:
                    self._spawn_from_thread(_free_dev())
                except Exception:
                    pass

    def _notify_owner_refcount(self, oid: ObjectID, owner, kind: str):
        if owner is None:
            return

        async def _send():
            try:
                conn = await self._conn_to(owner.address)
                await conn.notify(kind, (oid, self.worker_info.address.key()))
            except Exception:
                pass
        try:
            self._spawn_from_thread(_send())
        except Exception:
            pass

    def rpc_add_borrower(self, conn, arg):
        oid, key = arg
        self.reference_counter.add_borrower(oid, key)

    def rpc_remove_borrower(self, conn, arg):
        oid, key = arg
        self.reference_counter.remove_borrower(oid, key)

    # ------------------------------------------------- shm create helpers
    def _shm_create_blocking(self, oid: ObjectID, chunks: list, size: int):
        """Create+seal a serialize() chunk list holding the create-ref
        (so LRU can't evict before the node manager pins) — each chunk is
        written straight into the segment, the payload is never joined
        host-side; on arena-OOM ask the node manager to spill and retry
        (ref: plasma create-request queue)."""
        for _ in range(100):
            try:
                self.shm.create_from_chunks(oid, chunks, size, hold=True)
                return
            except MemoryError:
                try:
                    freed = self.io.run(self.node_conn.call(
                        "spill_now", size), timeout=60)
                except Exception:
                    freed = 0
                if not freed:
                    time.sleep(0.1)
        raise MemoryError(
            f"object store full: could not place {size} bytes")

    async def _shm_create_async(self, oid: ObjectID, chunks: list,
                                size: int):
        for _ in range(100):
            try:
                self.shm.create_from_chunks(oid, chunks, size, hold=True)
                return
            except MemoryError:
                try:
                    freed = await self.node_conn.call("spill_now", size)
                except Exception:
                    freed = 0
                if not freed:
                    await asyncio.sleep(0.1)
        raise MemoryError(
            f"object store full: could not place {size} bytes")

    def _release_create_ref(self, oid: ObjectID):
        release = getattr(self.shm, "release_create_ref", None)
        if release is not None:
            try:
                release(oid)
            except Exception:
                pass

    # ---------------------------------------------------------------- put
    def put(self, value: Any) -> ObjectRef:
        with self._put_lock:
            self._put_index += 1
            idx = self._put_index
        oid = ObjectID.for_put(self.current_task_id(), idx)
        if self._object_state_enabled:
            # recorded BEFORE the store (the announce reads the site);
            # popped on failure or the entry would leak — _free_object,
            # the normal cleanup, never runs without an ObjectRef
            self._object_sites[oid] = (_capture_callsite(), time.time())
        try:
            self._store_owned_value(oid, value)
        except BaseException:
            self._object_sites.pop(oid, None)
            raise
        return ObjectRef(oid, self.worker_info)

    def put_device(self, value: Any) -> ObjectRef:
        """Store a torch.Tensor as a DEVICE-RESIDENT object: the payload
        stays in this process's memory (the card's, for a CUDA tensor);
        only metadata reaches the object directory. get() in this process
        returns the same tensor; get() elsewhere host-stages the raw
        bytes over RPC — never a pickle of the device buffer (ref analog:
        torch_tensor_nccl_channel.py device channels)."""
        if not is_device_value(value):
            raise TypeError(
                f"put_device expects a torch.Tensor, got {type(value)}")
        with self._put_lock:
            self._put_index += 1
            idx = self._put_index
        oid = ObjectID.for_put(self.current_task_id(), idx)
        if self._object_state_enabled:
            self._object_sites[oid] = (_capture_callsite(), time.time())
        try:
            self.device_store.put(oid, value)
        except BaseException:
            self._object_sites.pop(oid, None)
            raise
        self.object_meta[oid] = ObjectMeta(
            oid, size=getattr(value, "nbytes", -1), in_device=True,
            holder=self.worker_info, node_ids=[self.node_id])
        self._signal_object_ready(oid)
        return ObjectRef(oid, self.worker_info)

    def _store_owned_value(self, oid: ObjectID, value: Any,
                           is_exception: bool = False):
        cfg = get_config()
        chunks = None
        size = -1
        try:
            # serialize to a chunk list: big payloads go straight from
            # the value's buffers into the shm segment, never joined
            chunks = serialize(value)
            size = serialized_size(chunks)
        except Exception as e:
            value = TaskError(e, "serialization", traceback.format_exc())
            is_exception = True
        if chunks is not None and size > cfg.max_direct_call_object_size \
                and not is_exception:
            self._shm_create_blocking(oid, chunks, size)
            meta = ObjectMeta(oid, size=size, in_shm=True,
                              node_ids=[self.node_id])
            self.object_meta[oid] = meta

            site = self._object_sites.get(oid, ("", 0.0))[0]

            async def _announce(oid=oid, size=size, site=site):
                try:
                    await self.node_conn.call(
                        "object_created",
                        (oid, size, self.worker_info, site))
                finally:
                    self._release_create_ref(oid)

            self._spawn_from_thread(_announce())
        else:
            self.memory_store.put(oid, value, is_exception)
            self.object_meta[oid] = ObjectMeta(oid, size=size, inline=True)
        self._signal_object_ready(oid)

    def _signal_object_ready(self, oid: ObjectID):
        # no registered async waiter (the common case: getters either
        # haven't arrived or wait on sync events): skip the loop hop.
        # Safe against the register race — _wait_object_event re-checks
        # readiness AFTER registering its event.
        if oid not in self._object_events:
            return

        def _set():
            ev = self._object_events.pop(oid, None)
            if ev is not None:
                ev.set()
        # on the IO loop already (task completion path): set inline —
        # call_soon_threadsafe from the loop thread still writes the
        # self-pipe, a syscall + handle per object
        if asyncio._get_running_loop() is self.io.loop:
            _set()
        else:
            self.io.loop.call_soon_threadsafe(_set)

    def _wake_sync_waiter(self, oid: ObjectID):
        """Release a caller-thread getter parked on a direct fast-lane
        result (every completion path funnels here, so a task that
        failed over from the direct channel to the asyncio path still
        wakes its original getter)."""
        if self._sync_waiters:
            ev = self._sync_waiters.pop(oid, None)
            if ev is not None:
                ev.set()

    # ---------------------------------------------------------------- get
    def get(self, refs: list[ObjectRef], timeout: float | None = None) -> list:
        deadline = None if timeout is None else time.monotonic() + timeout
        # Fast path: every ref is already resolved in the local memory
        # store (completed inline results — the common case right after a
        # burst completes or a fast-lane actor call returns). No IO-loop
        # hop, no coroutine machinery.
        out = self._get_local_fast(refs, deadline)
        if out is not None:
            return out

        async def _get_all():
            return await asyncio.gather(
                *[self._async_get(r, deadline) for r in refs])

        values = self.io.run(_get_all())
        out = []
        for ref, (v, kind) in zip(refs, values):
            if kind == "shm":
                # deserialize OFF the IO loop, zero-copy over the mapping
                v, kind = self._load_shm_value(ref, v[0], v[1], deadline)
            if kind == "exc":
                raise v
            if kind == "des" and isinstance(v, BaseException):
                raise v
            out.append(v)
        return out

    def _get_local_fast(self, refs: list[ObjectRef],
                        deadline: float | None) -> list | None:
        """Resolve gets without touching the IO loop: memory-store hits
        return immediately; a ref whose result is about to arrive on a
        direct fast lane blocks on the reader thread's event (one
        condvar wake, no loop round-trip). Resolution runs in REVERSE
        list order: tasks chained onto one lease complete FIFO, so
        blocking on the last ref first means the earlier ones are
        memory hits by the time it fires — one wake per wave instead of
        one per ref. None => take the async path."""
        out: list = [None] * len(refs)
        for i in range(len(refs) - 1, -1, -1):
            ref = refs[i]
            obj = self.memory_store.get_if_exists(ref.id)
            if obj is None and ref.id in self._sync_read_owners:
                # sync-lane result: THIS thread pumps the sockets — the
                # reply (and any completion queued before it, on any
                # sync client) dispatches here, no reader-thread wake
                self._drive_sync_replies(ref.id, deadline)
                obj = self.memory_store.get_if_exists(ref.id)
            if obj is None:
                ev = self._sync_waiters.get(ref.id)
                if ev is None:
                    return None
                budget = (None if deadline is None
                          else max(0.0, deadline - time.monotonic()))
                if not ev.wait(budget):
                    raise GetTimeoutError(f"get({ref.id}) timed out")
                obj = self.memory_store.get_if_exists(ref.id)
                if obj is None:
                    return None  # completed into shm/device: slow path
            out[i] = obj
        # exceptions raise in list order, independent of resolve order
        for obj in out:
            if obj.is_exception:
                raise obj.value
        return [obj.value for obj in out]

    def _drive_sync_replies(self, oid: ObjectID,
                            deadline: float | None) -> bool:
        """Pump EVERY sync-mode direct client until `oid`'s completion
        dispatched (True) or the deadline passed / another thread owns
        all the pumping (False — the caller parks on the oid's event;
        the other pump or the reaper completes it). Pumping all clients
        at once matters: a reply on client B can depend on a completion
        sitting unread on client A (a worker resolving its args asks
        this owner for an object whose completion we haven't read)."""
        import select

        while oid in self._sync_read_owners:
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                slice_s = min(remaining, 1.0)
            else:
                slice_s = 1.0
            claimed = []
            for c in list(self._sync_direct_clients.values()):
                if c.closed or not c._pending:
                    continue
                if c.read_lock.acquire(blocking=False):
                    claimed.append(c)
            if not claimed:
                return False  # a concurrent getter pumps everything
            dispatch: list = []
            try:
                try:
                    ready, _, _ = select.select(
                        [c.sock for c in claimed], [], [], slice_s)
                except (OSError, ValueError):
                    ready = []  # a socket died: read_available handles
                for c in claimed:
                    if c.sock in ready:
                        dispatch.append((c, c.read_available()))
            finally:
                for c in claimed:
                    c.read_lock.release()
            for c, msgs in dispatch:
                c.dispatch_all(msgs)
        return True

    def _load_shm_value(self, ref: ObjectRef, oid: ObjectID, size: int,
                        deadline: float | None):
        """Map + deserialize a local sealed shm object with NO copy: the
        returned value's arrays alias the shared-memory mapping (read-
        only). Pin contract: the mapping is held open while any counted
        local ObjectRef to oid exists OR any aliasing view is alive;
        the pin drops when both are gone. If the local copy vanished
        between resolve and map (freed / spilled / evicted), re-resolve
        through _async_get — that path restores or re-pulls it."""
        for _ in range(4):
            try:
                view = self.shm.get_view(oid, size)
            except (KeyError, FileNotFoundError, TypeError, ValueError):
                # gone (freed/spilled/evicted) or a concurrent release
                # closed the mapping under us: re-resolve — that path
                # restores, re-pulls, or reopens the segment
                v, kind = self.io.run(self._async_get(ref, deadline))
                if kind == "shm":
                    oid, size = v
                    continue
                return v, kind
            pin = _ShmGetPin(oid, self._pin_events)
            try:
                value = deserialize(memoryview(view).toreadonly(),
                                    buffer_wrapper=pin.wrap)
            except BaseException:
                pin.abort()
                self._drain_pin_events()
                raise
            ref_held = (pin.n_wrappers > 0
                        and self.reference_counter.has_record(oid))
            # registration + seal under ONE lock hold: a ref-drop
            # sentinel (which needs this lock, non-blocking, to pop the
            # list) can never observe the pin before its count is final
            with self._pin_lock:
                pins = self._shm_pins.setdefault(oid, []) \
                    if ref_held else None
                if pins:
                    # one ref-holder slot per oid suffices to pin the
                    # segment for the ref's lifetime — repeated gets of
                    # a live ref must not grow the pin list (this pin
                    # then lives only as long as its views do)
                    ref_held = False
                release_now = pin.seal(ref_held=ref_held)
                if ref_held:
                    pins.append(pin)
            if ref_held and not self.reference_counter.has_record(oid):
                # the ref died inside the registration window and its
                # sentinel may have fired before our append: reclaim the
                # orphan slot unless a later sentinel already popped it
                with self._pin_lock:
                    lst = self._shm_pins.get(oid)
                    if lst and pin in lst:
                        lst.remove(pin)
                        if not lst:
                            del self._shm_pins[oid]
                        self._pin_events.append(pin)  # drop its ref slot
            if release_now:
                # nothing aliases the mapping and no counted ref exists:
                # the queued event drops the guard slot + store get-ref
                self._pin_events.append(pin)
            self._drain_pin_events()
            return value, "des"
        raise ObjectLostError(f"{oid}: local shm copy keeps vanishing")

    async def _async_get(self, ref: ObjectRef, deadline: float | None):
        oid = ref.id
        pull_failures = 0
        while True:
            # 1. owner-local inline
            obj = self.memory_store.get_if_exists(oid)
            if obj is not None:
                return (obj.value, "exc" if obj.is_exception else "val")
            meta = self.object_meta.get(oid)
            if meta is not None and meta.error is not None:
                return (meta.error, "exc")
            # 2a. device-resident object: zero-copy if we hold it, else
            # host-staged fetch from the holder worker (device_objects.py)
            if meta is not None and meta.in_device:
                local = self.device_store.get(oid)
                if local is not None:
                    return (local, "val")
                arr = await self._fetch_device_object(oid, meta.holder,
                                                      deadline)
                if arr is not None:
                    return (arr, "val")
                if deadline is not None and time.monotonic() >= deadline:
                    raise GetTimeoutError(f"get({oid}) timed out")
                if self._owns(oid) and self._maybe_recover_object(oid):
                    continue
                raise ObjectLostError(
                    f"{oid}: device-object holder is gone and the value "
                    "is not reconstructable")
            # 2. shm object we own: read locally, pull cross-node, or
            # reconstruct via lineage (ref: object_recovery_manager.h:38)
            if meta is not None and meta.in_shm:
                if self.shm.contains_locally(oid):
                    return ((oid, meta.size), "shm")
                if await self._pull_object(oid, meta.size, meta.node_ids,
                                           ref.owner or self.worker_info):
                    if self.node_id not in meta.node_ids:
                        meta.node_ids.append(self.node_id)
                    return ((oid, meta.size), "shm")
                if self._owns(oid) and self._maybe_recover_object(oid):
                    continue
                raise ObjectLostError(
                    f"{oid}: all copies lost and not reconstructable")
            if self.shm.contains_locally(oid):
                info = await self.node_conn.call("object_lookup", oid)
                if info is not None:
                    return ((oid, info["size"]), "shm")
            if self._owns(oid):
                tid = self._return_to_task.get(oid)
                pt = self.pending_tasks.get(tid) if tid is not None else None
                if (pt is not None and pt.done and meta is None
                        and not self.memory_store.contains(oid)):
                    # freed value with retained lineage: re-execute
                    if not self._maybe_recover_object(oid):
                        raise ObjectLostError(
                            f"{oid}: freed and not reconstructable")
                    continue
                # pending task return: wait for completion signal
                ok = await self._wait_object_event(oid, deadline)
                if not ok:
                    raise GetTimeoutError(f"get({oid}) timed out")
                continue
            # 3. remote owner
            if ref.owner is None:
                raise ObjectLostError(f"{oid} has no known owner")
            res = await self._remote_status(ref, wait_s=self._poll_budget(deadline))
            kind = res[0]
            if kind == "inline":
                _, blob, is_exc = res
                val = deserialize(blob)
                return (val, "exc" if is_exc else "val")
            if kind == "shm":
                _, size, locations = res
                if not self.shm.contains_locally(oid):
                    if not await self._pull_object(
                            oid, size, [nid for nid, _ in locations],
                            ref.owner, addrs=dict(locations)):
                        # a location may have died between the owner's
                        # answer and our pull; re-ask the owner (it prunes
                        # dead nodes and may lineage-reconstruct)
                        pull_failures += 1
                        if pull_failures >= 3:
                            raise ObjectLostError(f"could not pull {oid}")
                        await asyncio.sleep(0.1)
                        continue
                return ((oid, size), "shm")
            if kind == "device":
                _, holder = res
                local = self.device_store.get(oid)
                if local is not None:
                    return (local, "val")  # we ARE the holder: zero-copy
                arr = await self._fetch_device_object(oid, holder, deadline)
                if arr is not None:
                    return (arr, "val")
                # tell the owner its holder looks dead so IT can lineage-
                # reconstruct (the owner can't see worker-level deaths on
                # other nodes); then re-ask — a recovering owner answers
                # "pending" until the re-execution lands
                pull_failures += 1
                try:
                    conn = await self._conn_to(ref.owner.address)
                    await conn.call("report_device_object_lost",
                                    (oid, holder.worker_id))
                except Exception:
                    pass
                if pull_failures >= 3:
                    raise ObjectLostError(
                        f"could not fetch device object {oid}")
                await asyncio.sleep(0.1)
                continue
            if kind == "pending":
                if deadline is not None and time.monotonic() >= deadline:
                    raise GetTimeoutError(f"get({oid}) timed out")
                continue
            raise ObjectLostError(f"{oid}: owner reports {kind}")

    async def _pull_object(self, oid: ObjectID, size: int,
                           node_ids: list[NodeID], owner,
                           addrs: dict | None = None) -> bool:
        """Pull a shm object from any live holder into the local node's
        store (ref: pull_manager.h:52 owner-directed pull)."""
        for nid in list(node_ids):
            if nid in self._dead_nodes:
                continue
            if nid == self.node_id:
                # local but not in shm: it may have been SPILLED to disk —
                # ask the node manager to restore it (ref: un-spill path
                # in local_object_manager)
                try:
                    if await self.node_conn.call("restore_object", oid):
                        return True
                except Exception:
                    pass
                continue
            addr = (addrs or {}).get(nid) or self._node_addrs.get(nid)
            if addr is None:
                continue
            try:
                ok = await self.node_conn.call(
                    "store_remote_object", (oid, size, owner, addr),
                    timeout=300)
            except Exception:
                ok = False
            if ok:
                return True
        return self.shm.contains_locally(oid)

    async def _fetch_device_object(self, oid: ObjectID, holder,
                                   deadline: float | None = None):
        """Host-staged device-object transfer: raw shard bytes from the
        holder worker's HBM -> local device_put. Never pickles the
        device buffer (ref analog: NCCL channel p2p, host-staged for
        the MPMD plane; in-mesh transfers ride XLA collectives).

        Returns None when the holder is unreachable/doesn't have the
        object (callers may recover via lineage); REMOTE errors (e.g.
        the holder failing to serialize the array) propagate — they
        would recur on retry and must not masquerade as a lost holder."""
        if holder is None:
            return None
        budget = 300.0
        if deadline is not None:
            budget = max(0.05, min(budget, deadline - time.monotonic()))
        try:
            conn = await self._conn_to(holder.address)
            res = await conn.call("fetch_device_object", oid,
                                  timeout=budget)
        except RemoteError:
            raise
        except Exception as e:
            logger.warning("device-object fetch of %s from %s failed: %s",
                           oid, holder.address, e)
            return None
        if res is None:
            return None
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, deserialize_array, res)

    def _maybe_recover_object(self, oid: ObjectID) -> bool:
        """Lineage reconstruction: resubmit the task that produced `oid`
        (ref: object_recovery_manager.h:38 + task_manager.h:212 lineage
        resubmission). Returns True if a re-execution is (now) in flight.
        Runs on the IO loop, so state flips are race-free."""
        tid = self._return_to_task.get(oid)
        if tid is None:
            return False
        pt = self.pending_tasks.get(tid)
        if pt is None or pt.spec.actor_id is not None:
            return False  # puts and actor tasks are not reconstructable
        if not pt.done:
            return True  # a resubmission is already in flight
        if pt.retries_left <= 0:
            return False
        pt.retries_left -= 1
        pt.done = False
        for i in range(pt.spec.num_returns):
            roid = ObjectID.for_return(tid, i)
            self.object_meta.pop(roid, None)
            self.memory_store.delete(roid)
        for aid in pt.pinned:
            self.reference_counter.add_task_pin(aid)
        logger.warning("reconstructing %s by re-executing task %s",
                       oid, pt.spec.name)
        self._spawn(self._run_normal_task(pt.spec))
        return True

    def _poll_budget(self, deadline: float | None) -> float:
        if deadline is None:
            return 5.0
        return max(0.05, min(5.0, deadline - time.monotonic()))

    async def _remote_status(self, ref: ObjectRef, wait_s: float):
        conn = await self._conn_to(ref.owner.address)
        return await conn.call("get_object", (ref.id, wait_s),
                               timeout=wait_s + 30.0)

    async def _wait_object_event(self, oid: ObjectID,
                                 deadline: float | None) -> bool:
        ev = self._object_events.get(oid)
        if ev is None:
            ev = asyncio.Event()
            self._object_events[oid] = ev
        # re-check after registering to avoid lost wakeups
        if self.memory_store.contains(oid) or (
                self.object_meta.get(oid) is not None
                and not self._is_pending(oid)):
            return True
        if deadline is None:
            await ev.wait()  # no wait_for: saves a Task + timer per ref
            return True
        try:
            await asyncio.wait_for(
                ev.wait(), max(0.0, deadline - time.monotonic()))
            return True
        except asyncio.TimeoutError:
            return False

    def _is_pending(self, oid: ObjectID) -> bool:
        meta = self.object_meta.get(oid)
        if meta is not None:
            return meta.size == -1 and not meta.inline and meta.error is None
        tid = self._return_to_task.get(oid)
        if tid is None:
            return False
        pt = self.pending_tasks.get(tid)
        return pt is not None and not pt.done

    async def rpc_get_object(self, conn, arg):
        """Owner-side object status/fetch (long-poll when pending)."""
        oid, wait_s = arg
        deadline = time.monotonic() + max(0.0, wait_s)
        while True:
            obj = self.memory_store.get_if_exists(oid)
            if obj is not None:
                return ("inline", serialize_to_bytes(obj.value), obj.is_exception)
            meta = self.object_meta.get(oid)
            if meta is not None and meta.error is not None:
                return ("inline", serialize_to_bytes(meta.error), True)
            if meta is not None and meta.in_device:
                return ("device", meta.holder)
            if meta is not None and meta.in_shm:
                locs = [(nid, self._node_addrs.get(nid)) for nid in meta.node_ids
                        if self._node_addrs.get(nid) is not None]
                if locs or self.shm.contains_locally(oid):
                    return ("shm", meta.size, locs)
                # every copy died with its node: reconstruct, then serve
                # the borrower from the fresh copy (transitive recovery)
                if self._maybe_recover_object(oid):
                    continue
                return ("unknown",)
            if self._is_pending(oid):
                if time.monotonic() >= deadline:
                    return ("pending",)
                ok = await self._wait_object_event(oid, deadline)
                if not ok:
                    return ("pending",)
                continue
            # freed value with retained lineage: reconstruct, then serve
            if self._maybe_recover_object(oid):
                continue
            return ("unknown",)

    def rpc_add_object_location(self, conn, arg):
        """A node manager evacuated a copy of an object we own (drain
        migration): record the new location so reads keep resolving from
        the copy after the draining node dies — never through lineage
        re-execution."""
        oid, node_id = arg
        meta = self.object_meta.get(oid)
        if meta is None or not meta.in_shm:
            return False
        if node_id not in meta.node_ids and \
                node_id not in self._dead_nodes:
            meta.node_ids.append(node_id)
        return True

    def rpc_report_device_object_lost(self, conn, arg):
        """A borrower failed to reach the recorded holder of a device
        object we own: drop the stale meta and lineage-reconstruct if
        possible (ref: object_recovery_manager.h:38)."""
        oid, holder_wid = arg
        meta = self.object_meta.get(oid)
        if meta is None or not meta.in_device or meta.holder is None                 or meta.holder.worker_id != holder_wid:
            return False  # already recovered / different holder now
        if self.device_store.contains(oid):
            return False  # we hold a live copy ourselves
        return self._maybe_recover_object(oid)

    async def rpc_fetch_device_object(self, conn, oid: ObjectID):
        """Serve a device object we hold as raw host bytes (+dtype/shape).
        Runs the gather on an executor thread — device_get can block."""
        if not self.device_store.contains(oid):
            return None
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self.device_store.payload,
                                          oid)

    def rpc_free_device_object(self, conn, oid: ObjectID):
        self.device_store.delete(oid)
        return True

    # --------------------------------------------------------------- wait
    def wait(self, refs: list[ObjectRef], num_returns: int = 1,
             timeout: float | None = None):
        """Event-driven wait: owned refs block on the object-ready event,
        remote refs long-poll the owner — no fixed-interval re-polling
        (ref: CoreWorker::Wait fulfills from memory-store/plasma
        callbacks, not polling)."""
        deadline = None if timeout is None else time.monotonic() + timeout

        def _ready_now(ref: ObjectRef) -> bool:
            oid = ref.id
            if self.memory_store.contains(oid):
                return True
            if self.object_meta.get(oid) is not None or self._owns(oid):
                return not self._is_pending(oid)
            return self.shm.contains_locally(oid)

        async def _wait_ready(ref: ObjectRef):
            """Resolves (to the ref) only when the ref becomes ready."""
            oid = ref.id
            while True:
                if _ready_now(ref):
                    return ref
                if ref.owner is None \
                        or ref.owner.worker_id == self.worker_id:
                    if not self._owns(oid):
                        # freed self-owned ref: status is "unknown", which
                        # counts as no-longer-pending (matches the remote
                        # owner path's semantics)
                        return ref
                    await self._wait_object_event(oid, deadline)
                    if deadline is not None \
                            and time.monotonic() >= deadline:
                        return None
                    continue
                # remote owner: long-poll its status endpoint
                budget = self._poll_budget(deadline)
                try:
                    res = await self._remote_status(ref, wait_s=budget)
                except Exception:
                    await asyncio.sleep(0.5)  # owner unreachable; retry
                    res = ("pending",)
                if res[0] != "pending":
                    return ref
                if deadline is not None and time.monotonic() >= deadline:
                    return None

        async def _wait_loop():
            waiters = {asyncio.ensure_future(_wait_ready(r)): r
                       for r in refs}
            ready_ids = set()
            try:
                while len(ready_ids) < num_returns and waiters:
                    budget = None if deadline is None else max(
                        0.0, deadline - time.monotonic())
                    done, _ = await asyncio.wait(
                        waiters.keys(), timeout=budget,
                        return_when=asyncio.FIRST_COMPLETED)
                    if not done:
                        break  # deadline hit with nothing new
                    for t in done:
                        r = waiters.pop(t)
                        if not t.cancelled() and t.exception() is None \
                                and t.result() is not None:
                            ready_ids.add(r.id)
            finally:
                for t in waiters:
                    t.cancel()
                if waiters:
                    await asyncio.gather(*waiters, return_exceptions=True)
            ready = [r for r in refs if r.id in ready_ids]
            not_ready = [r for r in refs if r.id not in ready_ids]
            return ready, not_ready

        return self.io.run(_wait_loop())

    # ------------------------------------------------------ task submission
    def submit_task(self, function: Any, args: tuple, kwargs: dict,
                    options) -> list[ObjectRef]:
        task_id = TaskID.for_normal_task(self.job_id)
        spec_args, pinned = self._prepare_args(args)
        spec_kwargs, pinned_kw = self._prepare_args(kwargs)
        cfg = get_config()
        max_retries = options.max_retries
        if max_retries < 0:
            max_retries = cfg.default_max_retries
        if options.num_returns == -1 and options.tensor_transport:
            raise ValueError(
                "tensor_transport is not supported for streaming "
                "generators; yielded items go through the object store")
        if options.num_returns == -1:
            # retrying a partially-consumed stream would replay items
            max_retries = 0
        runtime_env = self._package_runtime_env(options.runtime_env)
        # Function table: hash/serialize the code once per (function,
        # job); the spec carries only the id and the blob rides the first
        # push per worker connection (_run_normal_task) with GCS KV as
        # the miss path. runtime_env tasks bypass the table — their code
        # must be (re)loaded under the materialized env every execution.
        if runtime_env is None:
            fid, blob = self.fn_table.register(function, self.job_id)
            self._publish_code_blob(fid, blob)
            function_blob = None
        else:
            fid, function_blob = None, _dumps_code_now(function)
        spec = TaskSpec(
            task_id=task_id, job_id=self.job_id,
            name=options.name or getattr(function, "__name__", "task"),
            function_blob=function_blob, function_id=fid,
            args=spec_args, kwargs=spec_kwargs,
            num_returns=options.num_returns,
            resources=self._demand_for(options),
            owner=self.worker_info, max_retries=max_retries,
            retry_exceptions=options.retry_exceptions,
            scheduling_strategy=options.scheduling_strategy,
            runtime_env=runtime_env,
            tensor_transport=options.tensor_transport,
            trace_ctx=_trace_carrier())
        refs = self._register_task(spec, pinned + pinned_kw)
        self._emit_task_event(spec, "PENDING_ARGS")
        if self._m_submitted is not None:
            try:
                self._inflight_tasks += 1
                self._m_submitted.inc()
                self._m_queue_depth.set(float(self._inflight_tasks))
            except Exception:
                pass  # telemetry must never fail a submission
        # dispatch-or-park ON THIS THREAD: an idle cached lease is
        # claimed and the push goes out with no loop involvement at all;
        # otherwise the task parks in the pool's claim queue (where a
        # reader-thread chain or the loop's grant path picks it up) and
        # the loop is woken at most once per pool to top up lease
        # fetches — a submit burst costs O(1) wakeups, not O(N)
        pt = self.pending_tasks[spec.task_id]
        pt.t_sched = time.perf_counter()
        self._submit_normal_task(spec, pt, _push_strategy(spec))
        if spec.num_returns == -1:
            from ray_tpu_torch.core.streaming import ObjectRefGenerator

            return ObjectRefGenerator(self, spec.task_id)
        return refs

    def _package_runtime_env(self, renv: dict | None) -> dict | None:
        """Validate + upload a runtime_env at submission time (ref:
        _private/runtime_env/packaging.py). Raises on unsupported keys —
        never silently drops the option."""
        if not renv:
            return None
        from ray_tpu_torch._internal import runtime_env as renv_mod

        def kv_put(key: str, data: bytes):
            self.io.run(self.gcs.kv_put(
                key, data, namespace=renv_mod.KV_NAMESPACE))

        return renv_mod.package(renv, kv_put)

    def _apply_runtime_env(self, spec: TaskSpec):
        """Worker side: materialize the packaged env before execution.

        Returns a restore callable. Normal tasks run on POOLED workers, so
        the caller must revert (env vars / cwd / sys.path leak into the
        next task otherwise); actor creation keeps the env for the actor's
        lifetime — its worker is dedicated (ref: the reference dedicates
        workers per runtime-env hash)."""
        if not spec.runtime_env:
            return None
        import sys

        from ray_tpu_torch._internal import runtime_env as renv_mod

        saved_keys = list(spec.runtime_env.get("env_vars") or {})
        if spec.runtime_env.get("pip"):
            saved_keys += ["VIRTUAL_ENV", "PATH"]  # venv splice reverts too
        if spec.runtime_env.get("conda"):
            saved_keys += ["CONDA_PREFIX", "PATH"]
        saved_env = {k: os.environ.get(k) for k in saved_keys}
        saved_cwd = os.getcwd()
        saved_path = list(sys.path)

        def kv_get(key: str):
            return self.io.run(self.gcs.kv_get(
                key, namespace=renv_mod.KV_NAMESPACE))

        renv_mod.materialize(spec.runtime_env, kv_get)

        def restore():
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            try:
                os.chdir(saved_cwd)
            except OSError:
                pass
            sys.path[:] = saved_path
            if spec.runtime_env.get("pip"):
                renv_mod.release_pip_venv(spec.runtime_env["pip"])
                # modules imported from the venv must not satisfy later
                # imports on this pooled worker (sys.modules outlives the
                # sys.path splice)
                venv_root = renv_mod._VENV_ROOT
                for name, mod in list(sys.modules.items()):
                    f = getattr(mod, "__file__", None) or ""
                    if f.startswith(venv_root):
                        del sys.modules[name]

        return restore

    def _demand_for(self, options) -> dict[str, float]:
        demand = options.resources.to_demand()
        strat = options.scheduling_strategy
        if isinstance(strat, PlacementGroupSchedulingStrategy):
            # rewrite demand onto the PG's reserved bundle resources
            pgid = strat.placement_group_id
            idx = strat.bundle_index
            if idx >= 0:
                demand = {f"{r}_pg_{pgid.hex()}_{idx}": amt
                          for r, amt in demand.items()}
        return demand

    def _prepare_args(self, args):
        pinned: list[ObjectID] = []
        if isinstance(args, dict):
            out = {}
            for k, v in args.items():
                if isinstance(v, ObjectRef):
                    out[k] = RefArg(v.id, v.owner)
                    self.reference_counter.add_task_pin(v.id)
                    pinned.append(v.id)
                else:
                    out[k] = v
            return out, pinned
        out = []
        for v in args:
            if isinstance(v, ObjectRef):
                out.append(RefArg(v.id, v.owner))
                self.reference_counter.add_task_pin(v.id)
                pinned.append(v.id)
            else:
                out.append(v)
        return out, pinned

    def _register_task(self, spec: TaskSpec, pinned) -> list[ObjectRef]:
        pt = _PendingTask(spec=spec, retries_left=spec.max_retries,
                          pinned=pinned)
        self.pending_tasks[spec.task_id] = pt
        if spec.num_returns == -1:  # streaming generator
            from ray_tpu_torch.core.streaming import _StreamState

            self._streams[spec.task_id] = _StreamState(
                spec.task_id, get_config().generator_backpressure_num_objects)
            return []
        refs = []
        for i in range(spec.num_returns):
            oid = ObjectID.for_return(spec.task_id, i)
            self._return_to_task[oid] = spec.task_id
            # every return gets a sync-waiter event at registration:
            # getters park on one condvar wake instead of spinning up
            # an asyncio task per ref (_get_local_fast), regardless of
            # which path — direct or asyncio — completes the task
            self._sync_waiters[oid] = threading.Event()
            refs.append(ObjectRef(oid, self.worker_info))
        return refs

    # ------------------------------------------------------ function table
    def _publish_code_blob(self, fid: str, blob: bytes,
                           sync: bool = False):
        """Publish a function-table blob to GCS KV exactly once per id.
        Background for task submission (the piggybacked first-push copy
        covers the window); synchronous for actor creation, whose spec
        reaches the executing worker via the GCS with no piggyback
        opportunity."""
        from ray_tpu_torch.core.function_table import KV_NAMESPACE

        if not self.fn_table.needs_kv_push(fid):
            return
        if sync:
            try:
                self.io.run(self.gcs.kv_put(fid, blob,
                                            namespace=KV_NAMESPACE))
            except Exception:
                self.fn_table.kv_push_failed(fid)
                raise
            return

        async def _put():
            try:
                await self.gcs.kv_put(fid, blob, namespace=KV_NAMESPACE)
            except Exception:
                self.fn_table.kv_push_failed(fid)
        self._spawn_from_thread(_put())

    def _attach_code_blob_set(self, spec: TaskSpec, sent: set):
        """Piggyback the code blob on the FIRST push of this function id
        over a connection (`sent` is that connection's pushed-id set);
        every later push on the same connection sends only the id. Must
        run right before the send — frame encoding happens synchronously
        inside it, so wire order matches this bookkeeping even across
        concurrent pushes. (A marked-but-never-delivered blob — send
        raced a connection loss — self-heals through the worker's GCS KV
        miss path.)"""
        if spec.function_id is None:
            return
        if spec.function_id in sent:
            spec.function_blob = None
        else:
            sent.add(spec.function_id)
            spec.function_blob = self.fn_table.blob_for(spec.function_id)

    def _fetch_code_blob(self, fid: str) -> bytes | None:
        """KV miss path (worker side, executor thread): the owner's
        background publish usually races only the first milliseconds of
        a job, but a multi-hundred-KB blob's kv_put on a loaded host
        can lag — keep retrying for a few seconds before failing the
        task."""
        from ray_tpu_torch.core.function_table import KV_NAMESPACE

        for delay in (0.0, 0.05, 0.2, 0.5, 1.0, 1.5, 2.0):
            if delay:
                time.sleep(delay)
            try:
                blob = self.io.run(self.gcs.kv_get(
                    fid, namespace=KV_NAMESPACE), timeout=30)
            except Exception:
                blob = None
            if blob is not None:
                return blob
        return None

    def _resolve_function(self, spec: TaskSpec):
        """Loaded code for a spec: piggybacked/staged blob, worker LRU,
        or the GCS KV fallback (spillback/retry onto a fresh worker,
        LRU-evicted entries)."""
        if spec.function_id is None:
            return cloudpickle.loads(spec.function_blob)
        if spec.function_blob is not None:
            self.fn_cache.stage_blob(spec.function_id, spec.function_blob)
        return self.fn_cache.resolve(spec.function_id, spec.job_id.hex(),
                                     self._fetch_code_blob)

    def rpc_cuda_initialized(self, conn, arg=None) -> bool:
        """Whether this process may have initialised CUDA: the node manager
        asks before it pins an idle worker to other cards (CUDA reads
        CUDA_VISIBLE_DEVICES once a process). Any process that imported
        torch counts: ``torch.cuda.is_available()`` and
        ``device_count()`` start the driver, which reads the variable
        then, while ``torch.cuda.is_initialized()`` stays False."""
        return "torch" in sys.modules

    def rpc_evict_job_code(self, conn, job_hex: str):
        """Job-scoped cache eviction: pooled workers outlive jobs."""
        self.fn_cache.evict_job(job_hex)
        return True

    # --- lease management (ref: normal_task_submitter lease reuse) ---
    def _lease_key(self, demand: dict[str, float], strategy=None) -> tuple:
        # the scheduling class includes the strategy (ref: SchedulingClass
        # keyed by resource shape + strategy) so an affinity/SPREAD lease
        # is never handed to a task with different placement constraints
        if strategy is None:
            skey = None
        elif isinstance(strategy, NodeAffinitySchedulingStrategy):
            skey = ("affinity", strategy.node_id.hex(), strategy.soft)
        elif isinstance(strategy, NodeLabelSchedulingStrategy):
            # canonical: equal strategies share a pool regardless of dict
            # insertion order
            skey = ("label", tuple(sorted(strategy.hard.items())),
                    tuple(sorted(strategy.soft.items())))
        else:
            skey = repr(strategy)
        return (tuple(sorted(demand.items())), skey)

    def _lease_pool_for(self, key: tuple) -> "_LeasePool":
        pool = self._lease_cache.get(key)
        if pool is None:
            pool = _LeasePool()
            self._lease_cache[key] = pool
        return pool

    def _submit_normal_task(self, spec: TaskSpec, pt: "_PendingTask",
                            strat) -> None:
        """Dispatch or park one ready normal task (any thread): take an
        idle cached lease if one exists, otherwise park in the pool's
        claim queue and make sure enough lease fetches are in flight
        (ref: normal_task_submitter.cc:291 — one scheduling-key
        pipeline, workers handed task-to-task without a raylet
        round-trip)."""
        if pt.cancelled or pt.done:
            return
        key = self._lease_key(spec.resources, strat)
        pool = self._lease_pool_for(key)
        if pool.idle:
            with pool.idle_lock:
                entry = pool.idle.pop() if pool.idle else None
            if entry is not None:
                self._dispatch_leased(spec, pt, strat,
                                      (entry[0], entry[1], entry[2]))
                return
        pool.queue.append((spec, pt, strat))
        if asyncio._get_running_loop() is self.io.loop:
            self._maybe_fetch_leases(key, spec.resources, pool, strat)
        elif not pool.fetch_armed:
            pool.fetch_armed = True
            self._fetch_requests.append((key, spec.resources, pool,
                                         strat))
            self._ring_loop()

    def _dispatch_leased(self, spec: TaskSpec, pt: "_PendingTask", strat,
                         entry) -> None:
        """Push one task onto a granted lease. Runs on the IO loop (the
        grant path) or a submitting user thread (idle-lease claim) — the
        reader-thread chaining path pushes via _direct_push_normal
        directly and never enters here."""
        winfo, token, nm_addr = entry
        if pt.cancelled or pt.done:
            # cancelled while parked: returns were already failed by
            # cancel_task; just hand the lease back (SPREAD releases —
            # recycling would bypass the node manager's round-robin)
            self._queue_lease_return(spec.resources, winfo, token,
                                     nm_addr, strat, strat != "SPREAD")
            return
        spec.attempt = spec.max_retries - pt.retries_left
        self._emit_task_event(spec, "SCHEDULED")
        if pt.t_sched is not None:  # first grant only, not retries
            self._observe_sched_latency(time.perf_counter() - pt.t_sched)
            pt.t_sched = None
        pt.running_on = winfo
        self._emit_task_event(spec, "DISPATCHED")
        chain = _LeaseChain()
        if self._direct_push_normal(spec, pt, winfo, token, nm_addr,
                                    strat, chain):
            # the direct reader thread owns this attempt; keep a second
            # task in flight on the lease (pipeline fill)
            if strat != "SPREAD":
                key = self._lease_key(spec.resources, strat)
                self._fill_chain(key, chain, spec.resources, winfo,
                                 token, nm_addr, strat)
            return
        coro = self._push_via_loop(spec, pt, strat, winfo, token, nm_addr)
        if asyncio._get_running_loop() is self.io.loop:
            self._spawn(coro)
        else:
            self._spawn_from_thread(coro)

    def _resubmit(self, spec: TaskSpec, pt: "_PendingTask", strat) -> None:
        """Retry re-entry (loop side): a crashed/errored attempt goes
        back through dispatch-or-park."""
        self._submit_normal_task(spec, pt, strat)

    def _maybe_fetch_leases(self, key: tuple, demand: dict[str, float],
                            pool: "_LeasePool", strategy=None):
        """Keep enough lease capacity in flight for the parked tasks.

        Batched pools send ONE request sized to the current deficit
        (capped at lease_batch_max) instead of a round-trip per task,
        and keep at most two RPCs outstanding: one may be queued at a
        saturated node manager while the second covers tasks that
        arrived since. SPREAD pools stay unbatched — the node manager
        round-robins per request, so per-task requests ARE the placement
        policy."""
        deficit = len(pool.queue) - pool.inflight
        if deficit <= 0:
            return
        batch_max = 1 if strategy == "SPREAD" \
            else max(1, get_config().lease_batch_max)
        if batch_max <= 1:
            for _ in range(deficit):
                pool.inflight += 1
                pool.fetches += 1
                self._spawn(self._fetch_lease(key, demand, pool,
                                              strategy, 1))
            return
        if pool.fetches >= 2:
            return
        n = min(deficit, batch_max)
        pool.inflight += n
        pool.fetches += 1
        self._spawn(self._fetch_lease(key, demand, pool, strategy, n))

    async def _fetch_lease(self, key: tuple, demand: dict[str, float],
                           pool: "_LeasePool", strategy=None,
                           count: int = 1):
        """One in-flight lease request (possibly batched) against the
        cluster; grants go to the waiters first in line, surplus batched
        grants park as warm idle leases (the existing reuse machinery
        recycles or expires them)."""
        try:
            entries = await self._request_cluster_lease(demand, strategy,
                                                        count)
        except BaseException as e:
            # BaseException: a shutdown-sweep CancelledError must run the
            # same bookkeeping, else pool.inflight stays inflated and a
            # waiter future hangs forever (its task destroyed pending).
            pool.inflight -= count
            pool.fetches -= 1
            # a failed fetch fails exactly ONE parked task — same blast
            # radius as the request-per-task design; remaining tasks
            # re-arm their own fetch below.
            while pool.queue:
                try:
                    fspec, fpt, _ = pool.queue.popleft()
                except IndexError:
                    break
                if fpt.cancelled or fpt.done:
                    continue
                if isinstance(e, asyncio.CancelledError):
                    self._fail_task(fspec,
                                    WorkerCrashedError("shutting down"))
                else:
                    self._fail_task(fspec, TaskError(e, fspec.name, ""))
                break
            if isinstance(e, asyncio.CancelledError):
                raise
            self._maybe_fetch_leases(key, demand, pool, strategy)
            return
        pool.inflight -= count
        pool.fetches -= 1
        for entry in entries:
            # count>1 surplus parks warm (burst tail reuses it); a single
            # unwanted grant is returned so it can't starve other clients
            # queued at the node manager
            self._offer_lease(key, pool, entry, recycled=(count > 1))
        self._maybe_fetch_leases(key, demand, pool, strategy)

    def _offer_lease(self, key: tuple, pool: "_LeasePool", entry,
                     recycled: bool):
        """Hand a granted/finished lease to the next parked task;
        otherwise keep a recycled lease warm for lease_reuse_idle_s, and
        return a fetched lease nobody wants (holding it would starve
        other clients queued at the node manager)."""
        while pool.queue:
            try:
                spec, pt, strat = pool.queue.popleft()
            except IndexError:
                break
            if pt.cancelled or pt.done:
                continue
            self._dispatch_leased(spec, pt, strat, entry)
            return
        idle_s = get_config().lease_reuse_idle_s
        if not recycled or idle_s <= 0 or self._shutdown:
            self._spawn(self._release_lease(
                entry[0], entry[1], entry[2], reusable=False))
            return
        # identity sentinel: the same lease can be recycled repeatedly, so
        # an expire timer from an EARLIER idle period must not evict the
        # lease's newer idle incarnation (tuple equality would)
        idle_entry = (entry[0], entry[1], entry[2], object())
        with pool.idle_lock:
            pool.idle.append(idle_entry)

        async def _expire():
            await asyncio.sleep(idle_s)
            with pool.idle_lock:  # vs concurrent user-thread claims
                expired = False
                for i, cand in enumerate(pool.idle):
                    if cand[3] is idle_entry[3]:
                        del pool.idle[i]
                        expired = True
                        break
            if expired:
                await self._release_lease(
                    entry[0], entry[1], entry[2], reusable=False)
        self._spawn(_expire())

    @staticmethod
    def _infeasible_error(demand: dict, res) -> RuntimeError:
        """Enriched submitter-side infeasible error: names the demand
        shape, the nearest-fit node's view (from the deciding node's
        candidate snapshot riding the reply), and points at the
        scheduling-observability surfaces — the reason string alone
        told the user nothing actionable."""
        reason = res[1]
        detail = (res[2] if len(res) > 2 and isinstance(res[2], dict)
                  else {})
        shape = detail.get("shape") or ",".join(
            f"{k}:{demand[k]:g}" for k in sorted(demand)) or "(none)"
        cands = detail.get("candidates") or {}
        nearest = ""
        if cands:
            # nearest fit: a node that could EVER fit beats one that
            # can't; among those, the most demanded-resource headroom
            def score(item):
                view = item[1]
                return (view.get("fits_ever", False),
                        view.get("fits_now", False),
                        sum(view.get("available", {}).values()))
            nid, view = max(cands.items(), key=score)
            fit = (" (could fit when idle)" if view.get("fits_ever")
                   else " (can NEVER fit this shape)")
            nearest = (f" Nearest fit: node {nid[:12]} "
                       f"available={view.get('available')}{fit}.")
        return RuntimeError(
            f"infeasible task: {reason} (demand shape: {shape})."
            f"{nearest} Run `rayt why-pending <task_id>` for the live "
            f"verdict or `rayt status` for cluster-wide pending demand.")

    async def _request_cluster_lease(self, demand: dict[str, float],
                                     strategy=None, count: int = 1):
        """-> list of (winfo, token, nm_addr) grants (1..count)."""
        nm_addr = Address(self.node_address.host, self.node_address.port)
        allow_spill = True
        infeasible_deadline: float | None = None
        hop = 0
        # spillback hop count: rides the request so each node's
        # decision trace records its position in the chain, and rides
        # the spillback reply back so the chain reassembles in the GCS
        spill_hop = 0
        while hop < 1000:
            hop += 1
            try:
                conn = (self.node_conn
                        if nm_addr.key() == self.node_address.key()
                        else await self._conn_to(nm_addr))
                self.lease_rpcs_sent += 1
                res = await conn.call("request_lease",
                                      (demand, allow_spill, strategy,
                                       count, spill_hop,
                                       self.job_id.hex()),
                                      timeout=_TASK_PUSH_TIMEOUT)
            except (ConnectionLost, RpcError, OSError):
                if nm_addr.key() == self.node_address.key():
                    raise  # our own node manager is gone — unrecoverable
                # spillback target died (stale cluster view); fall back to
                # the local manager, whose view refreshes via heartbeat
                self._conns.pop(nm_addr.key(), None)
                nm_addr = Address(self.node_address.host,
                                  self.node_address.port)
                allow_spill = True
                spill_hop = 0
                await asyncio.sleep(0.3)
                continue
            if res[0] == "granted":
                return [(w, t, nm_addr) for w, t in res[1]]
            if res[0] == "spillback":
                nm_addr = res[1]
                spill_hop = (int(res[2]) if len(res) > 2
                             else spill_hop + 1)
                allow_spill = False
                continue
            if res[0] == "cancelled":
                # the node believed this caller gone (e.g. a reconnect
                # race): retry from the local manager
                nm_addr = Address(self.node_address.host,
                                  self.node_address.port)
                allow_spill = True
                spill_hop = 0
                await asyncio.sleep(0.2)
                continue
            # infeasible NOW: publish the unmet demand so an autoscaler can
            # act on it (ref: raylets feeding resource_demands to the
            # autoscaler), and keep retrying until lease_timeout_s —
            # capacity may be on its way
            if infeasible_deadline is None:
                infeasible_deadline = (time.monotonic()
                                       + get_config().lease_timeout_s)
            if time.monotonic() >= infeasible_deadline:
                raise self._infeasible_error(demand, res)
            try:
                autoscaler_listening = await self.gcs.call(
                    "report_task_demand", demand)
            except Exception:
                autoscaler_listening = False
            if not autoscaler_listening and "draining" not in str(res[1]):
                # nothing will ever grow the cluster — fail fast.
                # Exception: a drain-caused verdict is transient by
                # construction (migration is freeing capacity right
                # now), so keep retrying until lease_timeout_s.
                raise self._infeasible_error(demand, res)
            nm_addr = Address(self.node_address.host, self.node_address.port)
            allow_spill = True
            spill_hop = 0
            await asyncio.sleep(0.5)
        raise RuntimeError("lease spillback loop exceeded")

    async def _release_lease(self, winfo, token, nm_addr,
                             reusable: bool = True):
        try:
            conn = (self.node_conn if nm_addr.key() == self.node_address.key()
                    else await self._conn_to(nm_addr))
            await conn.call("return_lease", token)
        except Exception:
            pass

    def _recycle_lease(self, demand: dict[str, float], winfo, token, nm_addr,
                       strategy=None):
        """A task finished on this leased worker: hand the lease straight
        to the next queued task of the same shape, or keep it warm for
        lease_reuse_idle_s. Runs on the IO loop."""
        key = self._lease_key(demand, strategy)
        self._offer_lease(key, self._lease_pool_for(key),
                          (winfo, token, nm_addr), recycled=True)

    async def _run_normal_task(self, spec: TaskSpec):
        """Loop-side re-entry for retries and lineage reconstruction:
        route the task (back) through dispatch-or-park."""
        pt = self.pending_tasks.get(spec.task_id)
        if pt is None:
            return
        self._submit_normal_task(spec, pt, _push_strategy(spec))

    async def _push_via_loop(self, spec: TaskSpec, pt: "_PendingTask",
                             strat, winfo, token, nm_addr):
        """Asyncio-path push of one leased attempt (workers without a
        direct channel, oversized specs, chaos testing). Carries the
        full reply/error/retry handling the direct path marshals back
        here for."""
        try:
            conn = await self._conn_to(winfo.address)
            self._attach_code_blob_set(
                spec, conn.__dict__.setdefault("_fn_pushed", set()))
            spec.gpu_ids = parse_lease_token(token)[1]
            reply = await conn.call("push_task", spec,
                                    timeout=_TASK_PUSH_TIMEOUT)
        except (ConnectionLost, RpcError, OSError) as e:
            pt.running_on = None
            await self._release_lease(winfo, token, nm_addr, reusable=False)
            if pt.cancelled:
                # force-cancel kills the worker mid-task; that death is
                # the cancellation succeeding, not a crash
                self._fail_task(spec, TaskCancelledError(
                    f"task {spec.name} cancelled while running"))
                return
            if pt.retries_left > 0:
                pt.retries_left -= 1
                logger.warning("task %s worker crash, retrying (%s)",
                               spec.name, e)
                await asyncio.sleep(0.05)
                self._resubmit(spec, pt, strat)
                return
            self._fail_task(spec, WorkerCrashedError(
                f"worker died running {spec.name}: {e}"))
            return
        pt.running_on = None
        if pt.cancelled:
            # cancel() already returned True — it wins even when the
            # worker raced to a result. Never recycle this lease: on
            # force-cancel the worker is milliseconds from os._exit.
            self._spawn(self._release_lease(
                winfo, token, nm_addr, reusable=False))
            self._fail_task(spec, TaskCancelledError(
                f"task {spec.name} cancelled while running"))
            return
        if strat == "SPREAD":
            # no sticky reuse for SPREAD: recycling would funnel the
            # whole wave onto the first-granted node; releasing makes
            # every task take the round-robin path at the node manager
            # (fire-and-forget: no reply-latency cost per task)
            self._spawn(self._release_lease(
                winfo, token, nm_addr, reusable=False))
        else:
            self._recycle_lease(spec.resources, winfo, token, nm_addr,
                                strat)
        if reply[0] == "task_error":
            _, err_blob, tb = reply
            if spec.retry_exceptions and pt.retries_left > 0:
                pt.retries_left -= 1
                self._resubmit(spec, pt, strat)
                return
            try:
                cause = deserialize(err_blob)
            except Exception as e:
                cause = RuntimeError(f"undeserializable task error: {e}")
            self._fail_task(spec, TaskError(cause, spec.name, tb))
            return
        self._complete_task(spec, reply[1], winfo)

    def _observe_sched_latency(self, dur_s: float):
        if self._m_sched_lat is None:
            return
        try:
            self._m_sched_lat.observe(dur_s)
        except Exception:
            pass

    def _direct_push_normal(self, spec: TaskSpec, pt, winfo: WorkerInfo,
                            token, nm_addr, strat,
                            chain: "_LeaseChain | None" = None) -> bool:
        """Push a leased normal task over the worker's direct channel.
        True => sent: the direct reader thread owns the rest of this
        attempt — it completes/fails the task under _completion_lock and
        chains the next parked same-shape task onto the hot lease (the
        loop never enters the steady-state submit→complete cycle); cold
        paths (task_error replies, connection loss) marshal back onto
        the IO loop where the retry machinery lives. False => caller
        takes the asyncio path (no direct port, oversized spec, chaos
        testing). ``chain`` tracks the in-flight pipeline on this lease
        — whoever drops it to zero disposes of the lease."""
        dc = self._direct_client_for(winfo.address.host,
                                     getattr(winfo, "direct_port", 0))
        if dc is None:
            return False
        spec.gpu_ids = parse_lease_token(token)[1]
        key = self._lease_key(spec.resources, strat)
        if chain is None:
            chain = _LeaseChain()

        def on_reply(reply):
            pt.running_on = None
            if reply[0] == "task_error":
                # cold path: retry/cancel decisions live on the loop
                if chain.release_one():
                    self._queue_lease_return(
                        spec.resources, winfo, token, nm_addr, strat,
                        strat != "SPREAD" and not pt.cancelled)
                self._spawn_from_thread(
                    self._handle_task_error_reply(spec, pt, reply))
                return
            with self._completion_lock:
                cancelled = pt.cancelled and not pt.done
                if cancelled:
                    # cancel() already returned True — it wins even when
                    # the worker raced to a result
                    self._fail_task_locked(spec, TaskCancelledError(
                        f"task {spec.name} cancelled while running"))
                else:
                    self._complete_task_locked(spec, reply[1], winfo)
            with chain.lock:
                chain.inflight -= 1
            # hot-lease chaining: top the pipeline back up straight from
            # this reader thread. Skipped for SPREAD (reuse would defeat
            # round-robin) and cancelled leases (on force-cancel the
            # worker is milliseconds from os._exit).
            if not cancelled and strat != "SPREAD" and not self._shutdown:
                self._fill_chain(key, chain, spec.resources, winfo,
                                 token, nm_addr, strat)
            if chain.try_dispose():
                self._queue_lease_return(
                    spec.resources, winfo, token, nm_addr, strat,
                    (not cancelled) and strat != "SPREAD")

        def on_error(exc):
            self._spawn_from_thread(self._handle_direct_push_loss(
                spec, pt, winfo, token, nm_addr, exc,
                release=chain.release_one()))

        if not chain.acquire_one():
            return False  # chain already disposed: lease is being
            # returned — the caller re-parks the task
        # push_lock makes attach-blob + send one atomic step: a racing
        # pusher on another thread cannot slip a blob-less frame for
        # this function id onto the wire before the blob-carrying one
        with dc.push_lock:
            self._attach_code_blob_set(spec, dc.fn_pushed)
            sent = dc.try_call("push_task", spec, on_reply, on_error)
        if sent:
            return True
        with chain.lock:
            chain.inflight -= 1
        return False

    def _fill_chain(self, key: tuple, chain: "_LeaseChain",
                    demand: dict[str, float], winfo, token, nm_addr,
                    strat) -> None:
        """Claim parked tasks onto this lease (runs on reader threads
        and the dispatching thread). Refilling to ONE in-flight push is
        unconditional — that is classic lease reuse. Pipelining a
        SECOND push (so the worker's next request is already buffered
        when it finishes) happens only under real queue pressure: a
        short queue's tasks may be long-running, and queueing one
        behind a busy worker would serialize work that an incoming
        lease grant could run in parallel. A claimed task the channel
        refuses (oversized spec, client teardown) is re-parked
        head-of-queue for the loop."""
        pool = self._lease_cache.get(key)
        if pool is None:
            return
        while True:
            target = (_LeaseChain.DEPTH
                      if len(pool.queue) >= _PIPELINE_MIN_QUEUE else 1)
            with chain.lock:
                if chain.inflight >= target:
                    return
            nxt = self._claim_parked_task(key)
            if nxt is None:
                return
            nspec, npt, nstrat = nxt
            nspec.attempt = nspec.max_retries - npt.retries_left
            self._emit_task_event(nspec, "SCHEDULED")
            if npt.t_sched is not None:
                self._observe_sched_latency(
                    time.perf_counter() - npt.t_sched)
                npt.t_sched = None
            npt.running_on = winfo
            self._emit_task_event(nspec, "DISPATCHED")
            if not self._direct_push_normal(nspec, npt, winfo, token,
                                            nm_addr, nstrat, chain):
                npt.running_on = None
                self._repark_task(key, nspec, npt, nstrat)
                # if that refusal left the chain idle, the lease must
                # still be disposed of exactly once (no-op when another
                # holder or a racing dispose already owns it)
                if chain.try_dispose():
                    self._queue_lease_return(demand, winfo, token,
                                             nm_addr, strat,
                                             strat != "SPREAD")
                return

    def _repark_task(self, key: tuple, spec: TaskSpec, pt, strat) -> None:
        """Head-of-queue re-park (claim raced a channel teardown); arms
        a loop-side fetch check so the task cannot strand."""
        pool = self._lease_pool_for(key)
        pool.queue.appendleft((spec, pt, strat))
        if not pool.fetch_armed:
            pool.fetch_armed = True
            self._fetch_requests.append((key, spec.resources, pool,
                                         strat))
            self._ring_loop()

    def _claim_parked_task(self, key: tuple):
        """Thread-safe claim of the next live parked task for this
        scheduling key — the deque pop IS the claim (atomic under the
        GIL); cancelled/finished entries are skipped. None when empty."""
        pool = self._lease_cache.get(key)
        if pool is None:
            return None
        q = pool.queue
        while True:
            try:
                spec, pt, strat = q.popleft()
            except IndexError:
                return None
            if pt.cancelled or pt.done:
                continue
            return spec, pt, strat

    async def _handle_task_error_reply(self, spec: TaskSpec, pt, reply):
        """Loop side of a direct-channel task_error reply (the lease was
        already parked by the reader thread)."""
        _, err_blob, tb = reply
        if pt.done:
            return
        if pt.cancelled:
            self._fail_task(spec, TaskCancelledError(
                f"task {spec.name} cancelled while running"))
            return
        if spec.retry_exceptions and pt.retries_left > 0:
            pt.retries_left -= 1
            self._resubmit(spec, pt, _push_strategy(spec))
            return
        try:
            cause = deserialize(err_blob)
        except Exception as e:
            cause = RuntimeError(f"undeserializable task error: {e}")
        self._fail_task(spec, TaskError(cause, spec.name, tb))

    async def _handle_direct_push_loss(self, spec: TaskSpec, pt,
                                       winfo, token, nm_addr, exc,
                                       release: bool = True):
        """Loop side of a direct-channel connection loss mid-push —
        mirrors the asyncio path's worker-crash retry clause. With a
        pipelined lease, only the LAST outstanding push's handler
        releases it (release=True)."""
        pt.running_on = None
        if release:
            await self._release_lease(winfo, token, nm_addr,
                                      reusable=False)
        if pt.done:
            return
        if pt.cancelled:
            # force-cancel kills the worker mid-task; that death is the
            # cancellation succeeding, not a crash
            self._fail_task(spec, TaskCancelledError(
                f"task {spec.name} cancelled while running"))
            return
        if pt.retries_left > 0:
            pt.retries_left -= 1
            logger.warning("task %s worker crash, retrying (%s)",
                           spec.name, exc)
            await asyncio.sleep(0.05)
            self._resubmit(spec, pt, _push_strategy(spec))
            return
        self._fail_task(spec, WorkerCrashedError(
            f"worker died running {spec.name}: {exc}"))

    def _task_finished(self, status: str):
        if self._m_finished is None:
            return
        try:
            self._inflight_tasks = max(0, self._inflight_tasks - 1)
            self._m_finished[status].inc()
            self._m_queue_depth.set(float(self._inflight_tasks))
        except Exception:
            pass

    def _complete_task(self, spec: TaskSpec, results: list, winfo: WorkerInfo):
        # direct-actor reader threads complete tasks off the IO loop, so
        # the terminal done-check/flag and pin release must be atomic
        # against the loop-side cancel/fail paths
        with self._completion_lock:
            self._complete_task_locked(spec, results, winfo)

    def _complete_task_locked(self, spec: TaskSpec, results: list,
                              winfo: WorkerInfo):
        pt = self.pending_tasks.get(spec.task_id)
        if pt is not None and pt.done:
            return  # lost the race with a cancel-fail; returns hold errors
        for i, entry in enumerate(results):
            if entry[0] == "stream_done":
                # all generator_item RPCs were acked before this reply was
                # sent, so the buffer is complete — close the stream
                stream = self._streams.get(spec.task_id)
                if stream is not None:
                    stream.finish(entry[1])
                continue
            oid = ObjectID.for_return(spec.task_id, i)
            if entry[0] == "inline":
                _, blob, is_exc = entry
                try:
                    value = deserialize(blob)
                except Exception as e:
                    value, is_exc = TaskError(e, spec.name, ""), True
                self.memory_store.put(oid, value, is_exc)
                self.object_meta[oid] = ObjectMeta(oid, size=len(blob),
                                                   inline=True)
            elif entry[0] == "device":
                _, size, holder = entry
                self.object_meta[oid] = ObjectMeta(
                    oid, size=size, in_device=True, holder=holder,
                    node_ids=[holder.node_id])
            else:  # ("shm", size)
                _, size = entry
                self.object_meta[oid] = ObjectMeta(
                    oid, size=size, in_shm=True, node_ids=[winfo.node_id])
            if self._object_state_enabled and oid not in self._object_sites:
                # owner-side attribution for task returns: the submit
                # site isn't reachable here, so the task NAME is the
                # callsite (matches the node directory's "task:<name>")
                self._object_sites[oid] = (f"task:{spec.name}", time.time())
            self._obj_meta_version += 1  # size/site now known
            self._signal_object_ready(oid)
            self._wake_sync_waiter(oid)
        if pt is not None:
            pt.done = True
            for oid in pt.pinned:
                self.reference_counter.remove_task_pin(oid)
            if spec.actor_id is None:  # actor calls aren't counted at
                self._task_finished("ok")  # submit; keep the pair honest

    def _fail_task(self, spec: TaskSpec, error: Exception):
        with self._completion_lock:
            self._fail_task_locked(spec, error)

    def _fail_task_locked(self, spec: TaskSpec, error: Exception):
        pt = self.pending_tasks.get(spec.task_id)
        if pt is not None and pt.done:
            # already failed/completed (e.g. cancelled while queued, then
            # the lease path errored too): a second pass would double-
            # decrement the arg pins
            return
        stream = self._streams.get(spec.task_id)
        if stream is not None:
            stream.abort(error)
        from ray_tpu_torch._internal.tracing import truncate_error

        cause = getattr(error, "cause", None)  # TaskError wraps the app exc
        if not isinstance(cause, BaseException):
            cause = error
        # a deliberate rt.cancel() is CANCELLED, not a failure — it must
        # not pollute `rayt list tasks --state FAILED` or failure counts
        terminal = ("CANCELLED" if isinstance(error, TaskCancelledError)
                    else "FAILED")
        self._emit_task_event(
            spec, terminal,
            error=truncate_error(
                type(cause).__name__, str(cause),
                getattr(error, "remote_traceback", "")))
        for i in range(max(spec.num_returns, 0)):
            oid = ObjectID.for_return(spec.task_id, i)
            self.memory_store.put(oid, error, is_exception=True)
            meta = self.object_meta.setdefault(oid, ObjectMeta(oid))
            meta.error = error
            self._signal_object_ready(oid)
            self._wake_sync_waiter(oid)
        if pt is not None:
            pt.done = True
            for oid in pt.pinned:
                self.reference_counter.remove_task_pin(oid)
            if spec.actor_id is None:
                self._task_finished("error")

    # ------------------------------------------------------ actor lifecycle
    def create_actor(self, cls: Any, args: tuple, kwargs: dict,
                     options) -> ActorID:
        actor_id = ActorID.of(self.job_id)
        task_id = TaskID.for_actor_task(actor_id)
        spec_args, pinned = self._prepare_args(args)
        spec_kwargs, pinned_kw = self._prepare_args(kwargs)
        runtime_env = self._package_runtime_env(options.runtime_env)
        # Actor-creation specs carry a function id too: the class blob is
        # published to GCS KV synchronously (the spec travels via the GCS
        # to the node manager — no owner connection to piggyback on) and
        # the creating worker fetches it once per class. A pool of N
        # identical actors ships the class N times -> once per worker.
        if runtime_env is None:
            fid, blob = self.fn_table.register(cls, self.job_id)
            self._publish_code_blob(fid, blob, sync=True)
            function_blob = None
        else:
            fid, function_blob = None, _dumps_code_now(cls)
        spec = TaskSpec(
            task_id=task_id, job_id=self.job_id,
            name=getattr(cls, "__name__", "Actor"),
            function_blob=function_blob, function_id=fid,
            args=spec_args, kwargs=spec_kwargs, num_returns=1,
            resources=self._demand_for(options),
            owner=self.worker_info, actor_id=actor_id,
            is_actor_creation=True, actor_options=options,
            scheduling_strategy=options.scheduling_strategy,
            runtime_env=runtime_env,
            trace_ctx=_trace_carrier())
        self.io.run(self.gcs.register_actor(spec))
        return actor_id

    def get_actor_submitter(self, actor_id: ActorID) -> "_ActorTaskSubmitter":
        sub = self._actor_submitters.get(actor_id)
        if sub is None:
            sub = _ActorTaskSubmitter(self, actor_id)
            self._actor_submitters[actor_id] = sub
        return sub

    def submit_actor_task(self, actor_id: ActorID, method_name: str,
                          args: tuple, kwargs: dict, options) -> list[ObjectRef]:
        task_id = TaskID.for_actor_task(actor_id)
        spec_args, pinned = self._prepare_args(args)
        spec_kwargs, pinned_kw = self._prepare_args(kwargs)
        max_retries = options.max_retries if options.max_retries >= 0 else 0
        if options.num_returns == -1 and options.tensor_transport:
            raise ValueError(
                "tensor_transport is not supported for streaming "
                "generators; yielded items go through the object store")
        if options.num_returns == -1:
            # retrying a partially-consumed stream would replay items
            max_retries = 0
        spec = TaskSpec(
            task_id=task_id, job_id=self.job_id,
            name=f"{method_name}", function_blob=None,
            args=spec_args, kwargs=spec_kwargs,
            num_returns=options.num_returns,
            resources={}, owner=self.worker_info,
            max_retries=max_retries,
            actor_id=actor_id, method_name=method_name,
            tensor_transport=options.tensor_transport,
            trace_ctx=_trace_carrier())
        refs = self._register_task(spec, pinned + pinned_kw)
        self._emit_task_event(spec, "PENDING_ARGS")
        sub = self.get_actor_submitter(actor_id)
        if spec.num_returns == 1 and not spec.tensor_transport \
                and self._try_direct_actor_submit(sub, spec):
            return refs
        sub.note_async_queued()
        self._spawn_from_thread(sub.submit(spec, queued=True))
        if spec.num_returns == -1:
            from ray_tpu_torch.core.streaming import ObjectRefGenerator

            return ObjectRefGenerator(self, spec.task_id)
        return refs

    def _try_direct_actor_submit(self, sub: "_ActorTaskSubmitter",
                                 spec: TaskSpec) -> bool:
        """Sync fast lane for actor calls: serialize + send on THIS
        (caller) thread over the worker's direct channel; the channel's
        reader thread completes the task and wakes sync getters. False
        => caller must take the asyncio submitter path. Stands down
        whenever asyncio submissions are queued (order preservation),
        the actor isn't resolved-ALIVE, or the channel is unavailable."""
        if sub.state != ActorState.ALIVE or sub.pending_async:
            return False
        if spec.method_name in sub.async_methods:
            return False  # async bodies must overlap on the actor loop
        address, dport = sub.address, sub.direct_port
        if address is None or not dport:
            return False
        # prefer the reader-less sync client: the eventual getter pumps
        # the reply on its own thread (2 thread wakes per round-trip);
        # fall back to the reader-thread client if the dial failed
        dc = self._sync_direct_client_for(address.host, dport)
        sync_mode = dc is not None
        if dc is None:
            dc = self._direct_client_for(address.host, dport)
            if dc is None:
                return False
        # the return's sync-waiter event was created by _register_task
        oid = ObjectID.for_return(spec.task_id, 0)
        node_id = sub.node_id or self.node_id

        def on_reply(reply):
            if reply[0] == "task_error":
                _, err_blob, tb = reply
                try:
                    cause = deserialize(err_blob)
                except Exception as e:
                    cause = RuntimeError(f"undeserializable error: {e}")
                self._fail_task(spec, TaskError(cause, spec.name, tb))
            else:
                self._complete_task(
                    spec, reply[1],
                    WorkerInfo(WorkerID.nil(), node_id, address))
            self._sync_read_owners.pop(oid, None)

        def on_error(exc):
            self._sync_read_owners.pop(oid, None)
            if isinstance(exc, RemoteError):
                # handler-level failure with a live connection: the
                # asyncio path owns the authoritative semantics — replay
                # through it (it terminally fails or retries)
                self._spawn_from_thread(sub.submit(spec))
            else:
                self._spawn_from_thread(
                    sub.handle_direct_loss(address, spec))

        with sub._seq_lock:
            if sub.pending_async:
                return False
            spec.seq_no = sub.seq
            spec.attempt = 0
            self._emit_task_event(spec, "SCHEDULED")
            self._emit_task_event(spec, "DISPATCHED")
            if sync_mode:
                self._sync_read_owners[oid] = dc
            sent = dc.try_call(
                "push_actor_task",
                (spec, self.worker_info.address.key()),
                on_reply, on_error)
            if sent:
                sub.seq += 1  # a failed send must not burn a seq —
                # the worker's gate would wait on it forever
            elif sync_mode:
                self._sync_read_owners.pop(oid, None)
        return sent

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        self.io.run(self.gcs.kill_actor(actor_id, no_restart))

    def cancel_task(self, ref: ObjectRef, force: bool = False) -> bool:
        """Best-effort cancel of the normal task producing `ref` (ref
        analog: core_worker.cc CancelTask / ray.cancel).

        Queued tasks fail immediately with TaskCancelledError; a running
        task gets an async exception raised between bytecodes (blocked C
        calls — sleep, IO — are only interrupted by force=True, which
        kills the executing worker; same limitation as the reference).
        Returns False when the task already finished — its value stands."""
        tid = self._return_to_task.get(ref.id)
        if tid is None:
            raise ValueError(
                "cancel() needs a task-return ObjectRef owned by this "
                "driver (for actors use rt.kill)")
        if tid.has_actor():
            raise ValueError(
                "cancelling actor tasks is not supported; rt.kill(actor) "
                "tears down the whole actor")
        # all bookkeeping on the IO loop: serializes against
        # _run_normal_task/_complete_task (they run there too), so the
        # done-check, flag set, and immediate fail are atomic
        return self.io.run(self._cancel_on_loop(tid, force))

    async def _cancel_on_loop(self, tid: TaskID, force: bool) -> bool:
        # check-and-set under the completion lock: a direct reader thread
        # completing the task concurrently either finishes first (we see
        # pt.done and return False) or sees pt.cancelled and fails the
        # task with TaskCancelledError — cancel-wins stays atomic
        with self._completion_lock:
            pt = self.pending_tasks.get(tid)
            if pt is None or pt.done:
                return False
            pt.cancelled = True
            pt.retries_left = 0
        winfo = pt.running_on
        if winfo is None:
            # not yet on a worker: fail the returns now — the parked
            # pool-queue entry is skipped at claim time (pt.done), so a
            # cancelled task stops competing for capacity (and feeding
            # autoscaler demand)
            self._fail_task(pt.spec, TaskCancelledError(
                f"task {pt.spec.name} cancelled before it started"))
            return True

        async def _send():
            try:
                conn = await self._conn_to(winfo.address)
                await conn.call("cancel_task", (tid, force), timeout=10)
            except Exception:
                pass  # worker may be mid-death; push path handles it
            # If the worker replied False (push not yet arrived, or body
            # finished), pt.cancelled is still set: the push reply path
            # fails the task with TaskCancelledError either way.
        self._spawn(_send())
        return True

    # --------------------------------------------------- streaming (owner)
    async def rpc_generator_item(self, conn, arg):
        """One yielded item from a streaming task we own (ref:
        CoreWorker::ReportGeneratorItemReturns). The ack is delayed while
        the unconsumed buffer exceeds the backpressure threshold, which
        blocks the producer."""
        task_id, index, entry = arg
        stream = self._streams.get(task_id)
        if stream is None:
            return False  # consumer gone; producer may stop
        oid = ObjectID.for_return(task_id, index)
        if entry[0] == "inline":
            _, blob, is_exc = entry
            try:
                value = deserialize(blob)
            except Exception as e:
                value, is_exc = TaskError(e, "stream item", ""), True
            self.memory_store.put(oid, value, is_exc)
            self.object_meta[oid] = ObjectMeta(oid, size=len(blob),
                                               inline=True)
        else:  # ("shm", size, node_id)
            _, size, node_id = entry
            self.object_meta[oid] = ObjectMeta(
                oid, size=size, in_shm=True, node_ids=[node_id])
        await stream.wait_capacity()
        if stream.dropped:
            # consumer went away while we waited: free the stored item,
            # including the producer-node shm copy (it was pinned by
            # object_created and would otherwise leak until node restart)
            self.memory_store.delete(oid)
            dropped_meta = self.object_meta.pop(oid, None)
            if dropped_meta is not None and dropped_meta.in_shm:
                self._free_shm_copies(dropped_meta)
            return False
        stream.push(index, oid)
        return True

    # ------------------------------------------------- worker-side execution
    async def _report_stream_item(self, spec: TaskSpec, index: int, item):
        """Serialize + push one yielded item to the owner; resolves to the
        owner's ack (False = consumer dropped the stream)."""
        cfg = get_config()
        oid = ObjectID.for_return(spec.task_id, index)
        try:
            chunks = serialize(item)
            size = serialized_size(chunks)
        except Exception as e:
            entry = ("inline", serialize_to_bytes(
                TaskError(e, spec.name, traceback.format_exc())), True)
        else:
            if size > cfg.max_direct_call_object_size:
                # yielded blocks ride the same copy-free path as normal
                # returns: chunks straight into shm, no host-side join
                await self._shm_create_async(oid, chunks, size)
                try:
                    await self.node_conn.call(
                        "object_created",
                        (oid, size, spec.owner, f"task:{spec.name}"))
                finally:
                    self._release_create_ref(oid)
                entry = ("shm", size, self.node_id)
            else:
                entry = ("inline", chunks_to_bytes(chunks), False)
        conn = await self._conn_to(spec.owner.address)
        return await conn.call(
            "generator_item", (spec.task_id, index, entry),
            timeout=_TASK_PUSH_TIMEOUT)

    def _stream_returns(self, spec: TaskSpec, gen) -> tuple:
        """Drive a (sync) generator, pushing each item to the owner as
        produced. Runs on an executor thread; each report blocks on the
        owner's ack (the backpressure point)."""
        count = 0
        for item in gen:
            alive = self.io.run(self._report_stream_item(spec, count, item))
            count += 1
            if alive is False:
                break  # consumer dropped the stream
        return ("ok", [("stream_done", count)])

    async def _stream_returns_async(self, spec: TaskSpec, agen) -> tuple:
        """Async-generator variant (async actors / Serve streaming)."""
        count = 0
        async for item in agen:
            fut = self.io.spawn(self._report_stream_item(spec, count, item))
            alive = await asyncio.wrap_future(fut)
            count += 1
            if alive is False:
                break
        return ("ok", [("stream_done", count)])

    def _ensure_executor_alive(self):
        """A stale cancellation async-exc can, in a narrow window, land in
        the pooled executor thread's idle loop and kill it silently —
        ThreadPoolExecutor never replaces dead threads, so every later
        push would hang. Detect and rebuild."""
        ident = self._exec_thread_ident
        if ident is None:
            return
        if any(t.ident == ident for t in threading.enumerate()):
            return
        # release the dead executor's bookkeeping (its work queue and
        # thread registry otherwise leak for the worker's lifetime);
        # wait=False since the only thread is already gone
        old = self.executor
        self.executor = ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="rayt-exec")
        self._exec_thread_ident = None
        try:
            old.shutdown(wait=False)
        except Exception:
            pass

    # ------------------------------------------------- direct-call plane
    def _direct_push_task(self, spec: TaskSpec):
        """Direct-channel normal-task execution (runs on a direct-server
        connection thread). The body runs INLINE on this thread under
        the worker-wide exec mutex — no executor round-trip (2 thread
        handoffs per task on a small host); the single-execution
        invariant and the cancel machinery (_exec_thread_ident async-exc
        delivery) are enforced inside _execute_task itself."""
        if spec.function_id is not None and spec.function_blob is not None:
            self.fn_cache.stage_blob(spec.function_id, spec.function_blob)
        return self._execute_task(spec)

    def _direct_push_actor_task(self, arg):
        """Direct-channel ordered actor-task execution (connection
        thread). Same seq gate as the asyncio handler — the blocking
        enter() parks this connection's thread until predecessors from
        the same caller have been dispatched. Sync bodies run inline on
        this thread; async bodies go to the actor loop as usual."""
        spec, caller_key = arg
        gate = self._actor_gates.setdefault(caller_key, _SeqGate())
        out = gate.enter(spec.seq_no,
                         lambda: self._dispatch_actor_task_direct(spec))
        if out is _INLINE:
            # ordering already secured: dispatch pre-acquired the exec
            # mutex under the gate lock; run the body here and release
            try:
                return self._execute_actor_task(spec)
            finally:
                self._exec_mutex.release()
        return out.result()

    def _dispatch_actor_task_direct(self, spec: TaskSpec):
        """Dispatch step for the direct path (runs under the seq-gate
        lock). Async methods keep the actor loop (their bodies must
        overlap). Sync methods claim the exec mutex HERE — while the
        gate is still closed to successors — so start order equals seq
        order even when a successor races in via the asyncio/executor
        path; the caller then runs the body inline."""
        if self._method_is_async(spec.method_name):
            return asyncio.run_coroutine_threadsafe(
                self._run_async_method(spec), self._actor_async_loop.loop)
        self._exec_mutex.acquire()
        return _INLINE

    def _method_is_async(self, method_name: str) -> bool:
        """Cached is-this-an-async-method lookup (the inspect pair costs
        ~10us per call on the hot path; the instance's methods are fixed
        for the worker's lifetime)."""
        hit = self._method_kind.get(method_name)
        if hit is None:
            import inspect

            method = getattr(self.actor_instance, method_name, None)
            hit = bool(asyncio.iscoroutinefunction(method)
                       or inspect.isasyncgenfunction(method))
            self._method_kind[method_name] = hit
        return hit

    def rpc_direct_port(self, conn, arg=None):
        """Direct-channel endpoint discovery (actor submitters resolve
        an actor's ADDRESS from the GCS, then ask the worker itself for
        its direct port — keeps the GCS schema untouched). Advertises 0
        when calls must be able to OVERLAP on this worker (threaded
        max_concurrency>1): a direct connection thread blocks per call,
        which would serialize them. An async-capable actor advertises
        the port PLUS its async method names — the owner keeps those on
        the asyncio path (their bodies overlap on the actor loop) while
        sync methods, whose bodies the single executor serializes
        anyway, still take the direct lane."""
        if self._direct_server is None:
            return 0
        if getattr(self.executor, "_max_workers", 1) != 1:
            return 0
        if self._actor_async_loop is None:
            return self._direct_server.port
        import inspect

        cls = type(self.actor_instance)
        async_methods = sorted(
            m for m in dir(cls) if not m.startswith("__")
            and (asyncio.iscoroutinefunction(getattr(cls, m, None))
                 or inspect.isasyncgenfunction(getattr(cls, m, None))))
        return (self._direct_server.port, async_methods)

    def _direct_client_for(self, host: str, direct_port: int):
        """Cached DirectClient for a worker endpoint, or None when the
        channel is unavailable (no port, chaos testing active, or the
        dial failed — callers fall back to the asyncio path)."""
        return self._cached_direct_client(self._direct_clients, host,
                                          direct_port, reader=True)

    def _sync_direct_client_for(self, host: str, direct_port: int):
        """Reader-less variant for the sync fast lane (replies pumped by
        getter threads via drive())."""
        return self._cached_direct_client(self._sync_direct_clients, host,
                                          direct_port, reader=False)

    def _cached_direct_client(self, cache: dict, host: str,
                              direct_port: int, reader: bool):
        if not direct_port or get_config().testing_rpc_failure_prob > 0:
            return None
        key = (host, direct_port)
        dc = cache.get(key)
        if dc is not None and not dc.closed:
            return dc
        # dial OUTSIDE the lock: a hung host's 10s connect must not
        # stall every other thread's access to healthy clients. Racing
        # creators are rare; the loser's connection is closed.
        try:
            from ray_tpu_torch.core.direct import DirectClient

            fresh = DirectClient(host, direct_port, reader=reader)
        except OSError:
            return None
        with self._direct_lock:
            cur = cache.get(key)
            if cur is not None and not cur.closed:
                fresh.close()
                return cur
            cache[key] = fresh
            return fresh

    async def rpc_push_task(self, conn, spec: TaskSpec):
        if spec.function_id is not None and spec.function_blob is not None:
            # stage the piggybacked blob BEFORE the executor hop: a later
            # same-connection push omitting the blob must always find it
            self.fn_cache.stage_blob(spec.function_id, spec.function_blob)
        loop = asyncio.get_running_loop()
        self._ensure_executor_alive()
        return await loop.run_in_executor(
            self.executor, self._execute_task, spec)

    def _emit_task_failed(self, spec: TaskSpec, e: BaseException, tb: str):
        """Terminal failure transition carrying the LIVE exception's
        type/message plus the truncated traceback — recorded at the
        catch site so the payload never degrades to a traceback
        re-parse. A cancellation delivered into the body is CANCELLED,
        not FAILED."""
        from ray_tpu_torch._internal.tracing import truncate_error

        self._emit_task_event(
            spec,
            "CANCELLED" if isinstance(e, TaskCancelledError) else "FAILED",
            error=truncate_error(type(e).__name__, str(e), tb))

    def _execute_task(self, spec: TaskSpec):
        with self._exec_mutex:
            return self._execute_task_mutexed(spec)

    def _execute_task_mutexed(self, spec: TaskSpec):
        # visible to the RPC loop thread for cancel_task (the exec context
        # is a threading.local, so it can't serve cross-thread lookups)
        self._exec_thread_ident = threading.get_ident()
        self._running_normal_task = spec.task_id
        t0 = time.perf_counter()
        self._emit_task_event(spec, "RUNNING")
        # execution span parents remotely on the submitter's span: one
        # trace id across the whole task tree (ref: _private/tracing
        # _wrap_task_execution). No-op context when tracing is off.
        try:
            with _otel.execute_span(
                    spec.name or "task", getattr(spec, "trace_ctx", None),
                    task_id=spec.task_id.hex()) as sp:
                out = self._execute_task_body(spec)
                sp["ok"] = not (isinstance(out, tuple) and out
                                and out[0] == "task_error")
        finally:
            self._running_normal_task = None
        dur = time.perf_counter() - t0
        if not (isinstance(out, tuple) and out and out[0] == "task_error"):
            self._emit_task_event(spec, "FINISHED")
        # (FAILED was emitted at the catch site with the live exception)
        self._observe_exec_latency(dur, "task")
        return out

    def _observe_exec_latency(self, dur_s: float, kind: str):
        if self._m_exec_lat is None:
            return
        try:
            self._m_exec_lat[kind].observe(dur_s)
        except Exception:
            pass

    def rpc_cancel_task(self, conn, arg):
        """Worker-side cancel (ref analog: CoreWorker::HandleCancelTask).

        Non-force: raise TaskCancelledError asynchronously in the executor
        thread — delivered between bytecodes, so C-blocked calls (sleep,
        IO) keep running until they return (reference has the same
        limitation). Force: kill this worker process shortly after the
        reply flushes; the owner maps the resulting connection loss to
        TaskCancelledError. A cancel that races task completion may land
        after the body returns — the in-flight result is then dropped via
        the errored push reply, which cancellation semantics allow."""
        tid, force = arg
        if self._running_normal_task != tid:
            return False  # finished or never arrived; owner handles it
        if force:
            # NOTE: this process may hold device-plane results of EARLIER
            # tasks (lease reuse); they die with it and their owners fall
            # back to lineage reconstruction (api.cancel documents this)
            threading.Timer(0.05, os._exit, args=(1,)).start()
            return True
        ident = self._exec_thread_ident
        if ident is None:
            return False
        import ctypes

        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(ident), ctypes.py_object(TaskCancelledError))
        # TOCTOU guard: if the body finished between our check and the
        # raise, the pending exception would fire in the idle executor
        # loop (killing the pooled thread) or inside the NEXT task.
        # Re-check and revoke (SetAsyncExc with NULL clears a pending
        # async exc); _ensure_executor_alive covers the residual window.
        if self._running_normal_task != tid:
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(ident), None)
            return False
        return True

    def _execute_task_body(self, spec: TaskSpec):
        self._exec_ctx.task_id = spec.task_id
        self._exec_ctx.job_id = spec.job_id
        if self.actor_id is None:
            self.leased_gpus = gpu_lease(spec.resources)
            self._pin_cards(spec.gpu_ids)
        restore_env = None
        held_args: list = []
        try:
            restore_env = self._apply_runtime_env(spec)
            fn = self._resolve_function(spec)
            args = self._resolve_args(spec.args, hold=held_args)
            kwargs = self._resolve_args(spec.kwargs, hold=held_args)
            result = fn(*args, **kwargs)
            if spec.num_returns == -1:
                return self._stream_returns(spec, result)
            return self._package_returns(spec, result)
        except Exception as e:
            tb = traceback.format_exc()
            self._emit_task_failed(spec, e, tb)
            return ("task_error", serialize_to_bytes(e), tb)
        finally:
            self._release_arg_pins(held_args)
            if restore_env is not None:
                try:
                    restore_env()
                except Exception:
                    pass
            if self.actor_id is None:
                self.leased_gpus = 0.0
                self.leased_gpu_ids = ()
            self._exec_ctx.task_id = None
            self._exec_ctx.job_id = None

    def _pin_cards(self, gpu_ids) -> None:
        """Make this process see the lease's cards before the body runs:
        CUDA_VISIBLE_DEVICES, which CUDA reads when the process first
        initialises it (the node manager never hands a worker that has
        done so under other cards a lease of these). A lease without a GPU
        leaves the view as it is: every card of the node."""
        self.leased_gpu_ids = tuple(gpu_ids or ())
        if gpu_ids:
            os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(gpu_ids)

    def _resolve_args(self, args, hold: list | None = None):
        """Resolve RefArg placeholders to values. `hold` (a list the
        caller later passes to _release_arg_pins in its finally) marks
        the resolved oids as executing-task args so the leak watchdog
        doesn't flag their zero-copy pins — the counted ref lives at
        the SUBMITTER, not in this process."""
        def one(v):
            if not isinstance(v, RefArg):
                return v
            if hold is not None:
                hold.append(v.object_id)
                with self._arg_pins_lock:
                    self._arg_pins[v.object_id] += 1
            return self.get([ObjectRef(v.object_id, v.owner,
                                       _add_local_ref=False)])[0]

        if isinstance(args, dict):
            return {k: one(v) for k, v in args.items()}
        return [one(v) for v in args]

    def _release_arg_pins(self, oids: list):
        if not oids:
            return
        with self._arg_pins_lock:
            for oid in oids:
                n = self._arg_pins.get(oid, 0)
                if n <= 1:
                    self._arg_pins.pop(oid, None)
                else:
                    self._arg_pins[oid] = n - 1

    def _package_returns(self, spec: TaskSpec, result):
        cfg = get_config()
        if spec.num_returns == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != spec.num_returns:
                raise ValueError(
                    f"task declared num_returns={spec.num_returns} but "
                    f"returned {len(values)} values")
        out = []
        for i, value in enumerate(values):
            oid = ObjectID.for_return(spec.task_id, i)
            if spec.tensor_transport and is_device_value(value):
                # device plane: the array never leaves this worker's HBM;
                # the owner records holder metadata only
                self.device_store.put(oid, value)
                out.append(("device", getattr(value, "nbytes", -1),
                            self.worker_info))
                continue
            try:
                chunks = serialize(value)
                size = serialized_size(chunks)
            except Exception as e:
                out.append(("inline", serialize_to_bytes(
                    TaskError(e, spec.name, traceback.format_exc())), True))
                continue
            if size > cfg.max_direct_call_object_size:
                # chunk list goes straight into the shm segment — the
                # return payload is never joined into a host-side blob
                self._shm_create_blocking(oid, chunks, size)
                try:
                    self.io.run(self.node_conn.call(
                        "object_created",
                        (oid, size, spec.owner, f"task:{spec.name}")))
                finally:
                    self._release_create_ref(oid)
                out.append(("shm", size))
            else:
                out.append(("inline", chunks_to_bytes(chunks), False))
        return ("ok", out)

    async def rpc_create_actor(self, conn, spec: TaskSpec):
        loop = asyncio.get_running_loop()
        opts = spec.actor_options
        if opts is not None and opts.max_concurrency > 1:
            # same leak as _ensure_executor_alive: the default 1-thread
            # executor this replaces is idle on a fresh worker — shut it
            # down rather than stranding its thread + queue
            old = self.executor
            self.executor = ThreadPoolExecutor(
                max_workers=opts.max_concurrency,
                thread_name_prefix="rayt-actor")
            try:
                old.shutdown(wait=False)
            except Exception:
                pass
        err = await loop.run_in_executor(
            None, self._instantiate_actor, spec)
        return err

    def _instantiate_actor(self, spec: TaskSpec) -> str | None:
        self._exec_ctx.task_id = spec.task_id
        self._exec_ctx.job_id = spec.job_id
        self._emit_task_event(spec, "RUNNING")
        held_args: list = []
        # before the constructor runs: it may read a device edge or object
        self.leased_gpus = gpu_lease(spec.resources)
        self._pin_cards(spec.gpu_ids)
        try:
            self._apply_runtime_env(spec)
            cls = self._resolve_function(spec)
            args = self._resolve_args(spec.args, hold=held_args)
            kwargs = self._resolve_args(spec.kwargs, hold=held_args)
            self.actor_instance = cls(*args, **kwargs)
            self.actor_id = spec.actor_id
            # async actors: methods that are coroutines (or async gens)
            # run on their own loop
            import inspect

            if any(asyncio.iscoroutinefunction(getattr(cls, m, None))
                   or inspect.isasyncgenfunction(getattr(cls, m, None))
                   for m in dir(cls) if not m.startswith("__")):
                self._actor_async_loop = EventLoopThread("rayt-actor-async")
            self._emit_task_event(spec, "FINISHED")
            return None
        except Exception as e:
            tb = traceback.format_exc()
            self._emit_task_failed(spec, e, tb)
            return tb
        finally:
            self._release_arg_pins(held_args)
            self._exec_ctx.task_id = None
            self._exec_ctx.job_id = None

    async def rpc_push_actor_task(self, conn, arg):
        """Ordered actor-task execution (ref: actor_scheduling_queue.cc).

        Ordering contract (mirrors the reference): calls from one caller
        *start* in seq order. With max_concurrency=1 the single executor
        thread makes start order == completion order (sequential actors);
        with max_concurrency>1 (threaded) or async methods, starts are
        ordered but bodies overlap — same as the reference's threaded/async
        actors (out_of_order_actor_scheduling_queue.cc)."""
        spec, caller_key = arg
        gate = self._actor_gates.setdefault(caller_key, _SeqGate())
        while True:
            ok, fut = gate.try_enter(spec.seq_no,
                                     lambda: self._dispatch_actor_task(spec))
            if ok:
                return await asyncio.wrap_future(fut)
            # out-of-order arrival (mixed direct/asyncio paths or a
            # reconnect): poll until the predecessor passes the gate —
            # rare, so a 1ms cadence costs nothing in steady state
            await asyncio.sleep(0.001)

    def _dispatch_actor_task(self, spec: TaskSpec):
        """Queue one ordered actor task for execution; returns a
        concurrent.futures.Future. Runs under the seq-gate lock (from
        either the asyncio handler or a direct-call thread) so the
        executor's FIFO order equals seq order."""
        if self._method_is_async(spec.method_name):
            # async actor: runs concurrently on the actor's asyncio loop
            return asyncio.run_coroutine_threadsafe(
                self._run_async_method(spec), self._actor_async_loop.loop)
        # executor queues FIFO, so start order is preserved; its
        # max_workers bounds actual concurrency
        self._ensure_executor_alive()
        return self.executor.submit(self._execute_actor_task, spec)

    async def _run_async_method(self, spec: TaskSpec):
        import inspect

        self._exec_ctx.task_id = spec.task_id
        self._exec_ctx.job_id = spec.job_id
        self._emit_task_event(spec, "RUNNING")
        # span covers the async execution path too (trace ids stay
        # consistent; interleaved async spans are handled by the
        # tracer's entry-removal discipline)
        with _otel.execute_span(
                spec.method_name or "actor_task",
                getattr(spec, "trace_ctx", None),
                task_id=spec.task_id.hex(),
                actor_id=(self.actor_id.hex()
                          if self.actor_id else "")) as sp:
            held_args: list = []
            try:
                method = getattr(self.actor_instance, spec.method_name)
                args = self._resolve_args_async(spec.args, held_args)
                kwargs = self._resolve_args_async(spec.kwargs, held_args)
                if spec.num_returns == -1 and \
                        inspect.isasyncgenfunction(method):
                    out = await self._stream_returns_async(
                        spec, method(*args, **kwargs))
                    self._emit_task_event(spec, "FINISHED")
                    return out
                result = await method(*args, **kwargs)
                if spec.num_returns == -1:
                    out = await self._stream_returns_async(spec, result)
                    self._emit_task_event(spec, "FINISHED")
                    return out
                out = self._package_returns(spec, result)
                self._emit_task_event(spec, "FINISHED")
                return out
            except Exception as e:
                sp["ok"] = False
                tb = traceback.format_exc()
                self._emit_task_failed(spec, e, tb)
                return ("task_error", serialize_to_bytes(e), tb)
            finally:
                self._release_arg_pins(held_args)
                self._exec_ctx.task_id = None
                self._exec_ctx.job_id = None

    def _resolve_args_async(self, args, hold: list | None = None):
        # async path: refs resolved via blocking get on a worker thread would
        # deadlock the actor loop only if it waited on itself; args are
        # resolved eagerly here via the IO loop (cheap for inline objects).
        return self._resolve_args(args, hold=hold)

    def _execute_actor_task(self, spec: TaskSpec):
        # threaded actors (max_concurrency>1) must let bodies overlap —
        # the mutex only backs the single-threaded executor's invariant
        # (the direct lane is disabled for threaded actors anyway)
        if getattr(self.executor, "_max_workers", 1) != 1:
            return self._execute_actor_task_mutexed(spec)
        with self._exec_mutex:
            return self._execute_actor_task_mutexed(spec)

    def _execute_actor_task_mutexed(self, spec: TaskSpec):
        t0 = time.perf_counter()
        self._emit_task_event(spec, "RUNNING")
        with _otel.execute_span(
                spec.method_name or "actor_task",
                getattr(spec, "trace_ctx", None),
                task_id=spec.task_id.hex(),
                actor_id=(self.actor_id.hex()
                          if self.actor_id else "")) as sp:
            out = self._execute_actor_task_body(spec)
            sp["ok"] = not (isinstance(out, tuple) and out
                            and out[0] == "task_error")
        dur = time.perf_counter() - t0
        if not (isinstance(out, tuple) and out and out[0] == "task_error"):
            self._emit_task_event(spec, "FINISHED")
        self._observe_exec_latency(dur, "actor")
        return out

    def _execute_actor_task_body(self, spec: TaskSpec):
        self._exec_ctx.task_id = spec.task_id
        self._exec_ctx.job_id = spec.job_id
        held_args: list = []
        try:
            if self.actor_instance is None:
                raise RuntimeError("actor not initialized")
            method = getattr(self.actor_instance, spec.method_name, None)
            if method is None and spec.method_name == "__rayt_apply__":
                # runtime escape hatch: run fn(actor_instance, *args) on
                # the actor without requiring the user class to define it
                # (the compiled-DAG executor loop rides this; ref analog:
                # __ray_call__ in python/ray/actor.py)
                inst = self.actor_instance
                method = lambda fn, *a, **k: fn(inst, *a, **k)  # noqa: E731
            if method is None:
                raise AttributeError(
                    f"actor has no method {spec.method_name!r}")
            args = self._resolve_args(spec.args, hold=held_args)
            kwargs = self._resolve_args(spec.kwargs, hold=held_args)
            result = method(*args, **kwargs)
            if spec.num_returns == -1:
                return self._stream_returns(spec, result)
            return self._package_returns(spec, result)
        except Exception as e:
            tb = traceback.format_exc()
            self._emit_task_failed(spec, e, tb)
            return ("task_error", serialize_to_bytes(e), tb)
        finally:
            self._release_arg_pins(held_args)
            self._exec_ctx.task_id = None
            self._exec_ctx.job_id = None

    async def _task_event_flush_loop(self):
        """Ship buffered task events to the GCS ring every second (ref:
        task_event_buffer.cc periodic flush to gcs_task_manager)."""
        while not self._shutdown:
            await asyncio.sleep(1.0)
            # piggyback: release shm get-pins whose last holder died on a
            # thread that couldn't drain (reentrant/contended at the time)
            self._drain_pin_events()
            if self._object_state_enabled:
                try:
                    self._leak_watchdog_tick()
                    built = self._build_object_report()
                    if built is not None:
                        report, new_baseline = built
                        epoch = self._obj_report_epoch
                        await self.gcs.publish(CH_OBJECTS, report)
                        # commit the delta baseline only once the
                        # publish lands — a dropped send must be
                        # retried next tick, or a refs_removed delta
                        # would be lost forever and the GCS record
                        # never freed. Epoch check: a GCS restart
                        # during the await reset the baseline (the new
                        # store is empty); committing over that reset
                        # would suppress the full re-send.
                        if epoch == self._obj_report_epoch:
                            self._obj_report_last = new_baseline
                except Exception:
                    pass  # observability is best-effort
            events = self.task_events.drain()
            if not events:
                continue
            try:
                await self.gcs.call("add_task_events", events)
            except Exception:
                pass  # dropped on GCS hiccup: tracing is best-effort

    # ------------------------------------------- object-plane observability
    def _reset_object_report_baseline(self):
        self._obj_report_epoch += 1
        self._obj_report_last = {"refs": {}, "pins": {}, "leaks": {}}

    def _held_get_refs(self) -> dict[ObjectID, int]:
        """This process's outstanding zero-copy get-pins (store-level
        truth: mappings cached / arena get-refs held)."""
        getter = getattr(self.shm, "get_ref_counts", None)
        if getter is None:
            return {}
        try:
            return getter()
        except Exception:
            return {}

    def _leak_watchdog_tick(self):
        """Flag shm segments that outlived every counted ref but still
        hold get-pins past the grace window (PR-4's pin contract, now
        watchable in production instead of assert-only). A pin held by a
        live zero-copy view is LEGAL — the flag marks ones that look
        forgotten; it clears the moment the pin actually drops (or a
        counted ref reappears)."""
        held = self._held_get_refs()
        now = time.monotonic()
        grace = get_config().object_leak_grace_s
        for oid in held:
            if self.reference_counter.has_record(oid) \
                    or oid in self._arg_pins:
                # counted ref exists (or the pin belongs to a currently
                # -executing task body's arg — its ref lives at the
                # submitter): healthy pin, reset any timer
                self._leak_since.pop(oid, None)
                self._leaked.discard(oid)
                continue
            t0 = self._leak_since.setdefault(oid, now)
            if now - t0 >= grace and oid not in self._leaked:
                self._leaked.add(oid)
                logger.warning(
                    "shm leak watchdog: %s held by get-pins %.1fs past "
                    "its last counted ref (grace %.1fs)", oid,
                    now - t0, grace)
                if _bm is not None:
                    try:
                        _bm.object_leaks_flagged.inc()
                    except Exception:
                        pass
        # pins that dropped: clear timers + flags (the report's
        # leaks_cleared delta tells the GCS to unflag)
        for oid in list(self._leak_since):
            if oid not in held:
                self._leak_since.pop(oid, None)
                self._leaked.discard(oid)

    def _build_object_report(self) -> tuple[dict, dict] | None:
        """Delta-encode this process's object state for the GCS object
        manager: the owner-side ReferenceCounter breakdown (with size /
        callsite / created-at attribution), outstanding get-pins, and
        leak-watchdog flags. Returns (report, new_baseline) — the
        CALLER commits the baseline after a successful publish — or
        None when nothing changed since the last published report."""
        held = self._held_get_refs()
        now = time.monotonic()
        pins = {oid.hex(): n for oid, n in held.items()}
        leaks = {oid.hex(): now - self._leak_since.get(oid, now)
                 for oid in self._leaked}
        last = self._obj_report_last
        versions = (self.reference_counter.version,
                    self._obj_meta_version)
        leaks_stale = (leaks.keys() != last["leaks"].keys()
                       or any(v - last["leaks"][k] >= _LEAK_AGE_RESEND_S
                              for k, v in leaks.items()))
        if versions == last.get("versions") and pins == last["pins"] \
                and not leaks_stale:
            # idle tick: no ref/meta mutation, same pins, same flags —
            # skip the O(owned-objects) snapshot + dict rebuild
            return None
        snap = self.reference_counter.debug_snapshot()
        refs: dict[str, dict] = {}
        for oid, rec in snap.items():
            if not rec["owned"]:
                continue
            meta = self.object_meta.get(oid)
            site, created = self._object_sites.get(oid, ("", 0.0))
            refs[oid.hex()] = {
                "local": rec["local"], "borrowers": rec["borrowers"],
                "task_pins": rec["task_pins"], "escaped": rec["escaped"],
                "size": meta.size if meta is not None else -1,
                "inline": bool(meta.inline) if meta is not None else False,
                "callsite": site, "created_at": created,
                "job": oid.job_id().hex(),
            }
        changed_refs = {k: v for k, v in refs.items()
                        if last["refs"].get(k) != v}
        refs_removed = [k for k in last["refs"] if k not in refs]
        changed_pins = {k: v for k, v in pins.items()
                        if last["pins"].get(k) != v}
        pins_removed = [k for k in last["pins"] if k not in pins]
        # new flags always travel; existing ones re-send once their age
        # advanced enough to matter (so the GCS shows a real duration)
        changed_leaks = {
            k: v for k, v in leaks.items()
            if k not in last["leaks"]
            or v - last["leaks"][k] >= _LEAK_AGE_RESEND_S}
        leaks_cleared = [k for k in last["leaks"] if k not in leaks]
        if not (changed_refs or refs_removed or changed_pins
                or pins_removed or changed_leaks or leaks_cleared):
            # versions moved but the visible state is identical (e.g. a
            # ref added and dropped between ticks): record the versions
            # so the next idle tick takes the cheap exit
            self._obj_report_last = dict(last, versions=versions)
            return None
        report = {
            "kind": "worker", "worker": self.worker_id.hex(),
            "node": self.node_id.hex(), "ts": time.time(),
            "refs": changed_refs, "refs_removed": refs_removed,
            "pins": changed_pins, "pins_removed": pins_removed,
            "leaks": changed_leaks, "leaks_cleared": leaks_cleared,
        }
        # the baseline keeps the ages actually SENT (not the freshly
        # computed ones) so the next age-resend measures from the last
        # value the GCS saw
        sent_leaks = {k: changed_leaks.get(k, last["leaks"].get(k, v))
                      for k, v in leaks.items()}
        return report, {"refs": refs, "pins": pins, "leaks": sent_leaks,
                        "versions": versions}

    def rpc_exit_worker(self, conn, arg=None):
        def _die():
            os._exit(0)
        threading.Timer(0.1, _die).start()
        return True

    def rpc_dump_stacks(self, conn, arg=None):
        """All-thread stack dump (ref analog: `ray stack` via py-spy —
        here cooperative via sys._current_frames, no ptrace needed)."""
        import traceback as tb

        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for ident, frame in frames.items():
            out.append({
                "thread": names.get(ident, str(ident)),
                "stack": "".join(tb.format_stack(frame)),
            })
        return {"pid": os.getpid(), "worker_id": self.worker_id.hex(),
                "actor_id": self.actor_id.hex() if self.actor_id else None,
                "threads": out}

    async def rpc_profile_worker(self, conn, arg=None):
        """On-demand self-profiling (ref: dashboard profile_manager
        py-spy/memray attach — cooperative here, no ptrace): mode "cpu"
        samples all threads' stacks, mode "memory" opens a tracemalloc
        window. Runs on an executor thread so the IO loop keeps serving."""
        from ray_tpu_torch._internal import profiler

        arg = arg or {}
        mode = arg.get("mode", "cpu")
        duration = float(arg.get("duration_s", 5.0))
        loop = asyncio.get_running_loop()
        if mode == "memory":
            return await loop.run_in_executor(
                None, profiler.sample_memory, duration,
                int(arg.get("top_n", 25)))
        return await loop.run_in_executor(
            None, profiler.sample_cpu, duration,
            float(arg.get("interval_s", 0.01)))

    def rpc_worker_stats(self, conn, arg=None):
        return {
            "worker_id": self.worker_id.hex(),
            "mode": self.mode,
            "actor_id": self.actor_id.hex() if self.actor_id else None,
            "num_pending_tasks": sum(
                1 for t in self.pending_tasks.values() if not t.done),
            "memory_store_size": len(self.memory_store),
            "refcount": self.reference_counter.stats(),
        }


class _ActorTaskSubmitter:
    """Per-actor ordered submission pipeline (ref: actor_task_submitter.h:75).

    Calls are pipelined: each gets a seq_no; the receiver reorders. The
    submitter tracks actor liveness via GCS pubsub and queues while the
    actor is PENDING/RESTARTING."""

    def __init__(self, cw: CoreWorker, actor_id: ActorID):
        self.cw = cw
        self.actor_id = actor_id
        self.seq = 0
        self.state = ActorState.PENDING
        self.address: Address | None = None
        self.node_id: NodeID | None = None
        self.death_cause = ""
        self._resolved = asyncio.Event()
        self._resolve_started = False
        # address observed to be dead (connection refused/lost); GCS may lag
        # behind the death, so an ALIVE report at this address is stale
        self._avoid_address: Address | None = None
        # direct fast lane: seq allocation is shared between the sync
        # fast path (user threads) and the asyncio path (IO loop), so it
        # needs a real lock; direct_port is learned from the worker
        # itself after resolution (0 = unknown/unavailable)
        self._seq_lock = threading.Lock()
        self.direct_port = 0
        self.async_methods: frozenset = frozenset()
        # asyncio submissions queued but not yet seq-stamped: the fast
        # lane stands down while any exist, so one caller's submission
        # order is preserved across the two paths
        self.pending_async = 0

    async def _ensure_resolved(self):
        if not self._resolve_started:
            self._resolve_started = True
            self.cw._spawn(self._resolve_loop())
        await self._resolved.wait()

    async def _resolve_loop(self):
        while True:
            try:
                res = await self.cw.gcs.actor_handle_state(self.actor_id)
            except Exception:
                await asyncio.sleep(0.25)
                continue
            if res is None:
                await asyncio.sleep(0.25)
                continue
            state, address, death_cause, _, node_id = res
            self.state = state
            self.death_cause = death_cause
            if state == ActorState.ALIVE and address is not None \
                    and address == self._avoid_address:
                # stale ALIVE record for an endpoint we saw die
                await asyncio.sleep(0.25)
                continue
            if state == ActorState.ALIVE and address is not None:
                if address != self.address:
                    with self._seq_lock:
                        self.seq = 0  # fresh incarnation: restart ordering
                    self.direct_port = 0
                self.address = address
                self.node_id = node_id
                self._resolved.set()
                self.cw._spawn(self._learn_direct_port(address))
                return
            if state == ActorState.DEAD:
                self._resolved.set()
                return
            # PENDING/RESTARTING: pubsub (on_actor_update) delivers the
            # transition promptly; this poll is only a lost-event fallback
            await asyncio.sleep(0.25)

    async def on_actor_update(self, info):
        self.state = info.state
        self.death_cause = info.death_cause
        if info.state == ActorState.ALIVE and info.address is not None:
            if info.address == self._avoid_address:
                return
            if info.address != self.address:
                with self._seq_lock:
                    self.seq = 0
                self.direct_port = 0
            self.address = info.address
            self.node_id = info.node_id
            self._resolved.set()
            self.cw._spawn(self._learn_direct_port(info.address))
        elif info.state == ActorState.DEAD:
            self.address = None
            self.direct_port = 0
            self._resolved.set()
        elif info.state == ActorState.RESTARTING:
            self.address = None
            self.direct_port = 0
            self._resolved.clear()
            self.cw._spawn(self._resolve_loop())

    async def _learn_direct_port(self, address: Address):
        """Ask the (now-ALIVE) actor worker for its direct-call port —
        endpoint discovery stays out of the GCS schema. Async-capable
        actors reply (port, async_method_names): those methods stay on
        the asyncio path so their bodies can overlap."""
        try:
            conn = await self.cw._conn_to(address)
            dp = await conn.call("direct_port", timeout=10)
        except Exception:
            dp = 0
        async_methods: tuple | list = ()
        if isinstance(dp, (tuple, list)):
            dp, async_methods = dp
        if self.address == address and self.state == ActorState.ALIVE:
            self.async_methods = frozenset(async_methods)
            self.direct_port = int(dp or 0)

    def note_async_queued(self):
        with self._seq_lock:
            self.pending_async += 1

    async def handle_direct_loss(self, address: Address, spec: TaskSpec):
        """A direct-channel connection died mid-call: mirror the asyncio
        path's failover — distrust the address, re-resolve via the GCS,
        and retry only when the task has retry budget."""
        if self.address == address:
            self._avoid_address = address
            self.address = None
            self.direct_port = 0
            self._resolved.clear()
            self.cw._spawn(self._resolve_loop())
        if spec.max_retries > 0:
            spec.max_retries -= 1  # the lost attempt consumed one
            await self.submit(spec)
        else:
            self.cw._fail_task(spec, ActorDiedError(
                self.actor_id, "connection lost: direct channel closed"))

    async def submit(self, spec: TaskSpec, queued: bool = False):
        attempts = spec.max_retries + 1
        try:
            await self._submit_attempts(spec, attempts)
        finally:
            if queued:
                with self._seq_lock:
                    self.pending_async -= 1

    async def _submit_attempts(self, spec: TaskSpec, attempts: int):
        while attempts > 0:
            attempts -= 1
            await self._ensure_resolved()
            if self.state == ActorState.DEAD:
                self.cw._fail_task(spec, ActorDiedError(
                    self.actor_id, self.death_cause))
                return
            # seq assigned synchronously post-resolution so pipelined calls
            # from this caller reach the current incarnation in order
            # (lock: the direct fast lane allocates from user threads)
            with self._seq_lock:
                spec.seq_no = self.seq
                self.seq += 1
            address = self.address
            spec.attempt = spec.max_retries - attempts
            self.cw._emit_task_event(spec, "SCHEDULED")
            try:
                self.cw._emit_task_event(spec, "DISPATCHED")
                conn = await self.cw._conn_to(address)
                reply = await conn.call(
                    "push_actor_task",
                    (spec, self.cw.worker_info.address.key()),
                    timeout=_TASK_PUSH_TIMEOUT)
            except (ConnectionLost, RpcError, OSError) as e:
                # actor worker died mid-call; wait for GCS verdict. Don't
                # trust ALIVE records still pointing at the dead endpoint.
                self._avoid_address = address
                self.address = None
                self._resolved.clear()
                self.cw._spawn(self._resolve_loop())
                if attempts > 0:
                    continue
                self.cw._fail_task(spec, ActorDiedError(
                    self.actor_id, f"connection lost: {e}"))
                return
            if reply[0] == "task_error":
                _, err_blob, tb = reply
                try:
                    cause = deserialize(err_blob)
                except Exception as e:
                    cause = RuntimeError(f"undeserializable error: {e}")
                self.cw._fail_task(spec, TaskError(cause, spec.name, tb))
                return
            winfo = WorkerInfo(WorkerID.nil(),
                               self.node_id or self.cw.node_id, address)
            self.cw._complete_task(spec, reply[1], winfo)
            return
