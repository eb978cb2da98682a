"""Train-plane observability recorder (ref analog: TorchTitan's
per-step metrics processor, PAPERS.md arXiv:2410.06511; publishing
mirrors serve/request_context.py's batched recorder).

Each train worker owns one :class:`StepRecorder`, keyed by the run id
the TrainController minted. The train loop brackets its phases —
``data_wait`` (ingest dequeue), ``h2d`` (the host-to-device copy),
``step`` (compute, up to a synchronize), ``ckpt_block`` (synchronous slice of
checkpoint save) — and closes each step with :meth:`end_step`, which
buffers ONE waterfall record whose stages tile the step wall time by
construction. The hot path costs phase timestamps + a lock + a list
append (< 50µs, enforced by test_perf_gate); a flusher on the core
worker's IO loop ships batches to the GCS ``train_state`` channel on
the ``train_flush_interval_s`` cadence.

The same flush cycle carries two sidecars:

- a blocked-phase HEARTBEAT when the loop has been inside one phase
  longer than ``train_stall_grace_s`` — the GCS train manager's stall
  watchdog turns it into an attributed flag (ingest-starved /
  checkpoint-blocked / collective-barrier) + cluster event;
- a per-card memory snapshot from ``torch.cuda.memory_stats`` at most
  once per second (a process that has not used CUDA falls back to
  process RSS, as the JAX package does on its CPU backend, so the
  ``rayt_device_memory_*`` gauges stay live).

First-call accounting rides :meth:`wrap_jit` (the JAX package's name,
which the GCS train manager's ``compile``/``retrace`` events keep): the
first call per argument-shape signature is timed as the ``compile``
event (in eager PyTorch, the first call's warm-up: allocator growth,
cuBLAS handles, kernel loads); a NEW signature after the first is a
``retrace``, published with the shape delta that caused it (the GCS
surfaces it as a WARNING cluster event).

The port of ray_tpu/train/telemetry.py. It never imports torch at module
level: the functions that read tensors consult ``sys.modules`` and act
only when the caller already imported torch.
"""

from __future__ import annotations

import asyncio
import sys
import threading
import time
import uuid
import weakref
from typing import Optional

from ray_tpu_torch.core.gcs_train_manager import CH_TRAIN

# phase name -> waterfall stage key (manager TRAIN_STAGES order)
_PHASES = ("data_wait", "h2d", "step", "ckpt_block")
# device-memory snapshot cadence (rides the flush cycle, rate-limited)
_MEMORY_INTERVAL_S = 1.0


def mint_run_id() -> str:
    """A fresh run id (uuid4 hex): minted once in the TrainController,
    it rides WorkerGroup.setup into every worker's session and keys the
    GCS train manager's per-run store."""
    return uuid.uuid4().hex


def recording_enabled() -> bool:
    """Config gate, resolved per call so RAYT_CONFIG_JSON-spawned
    processes and tests see live values (get_config caches)."""
    try:
        from ray_tpu_torch._internal.config import get_config

        return bool(get_config().train_state_enabled)
    except Exception:
        return False


# ------------------------------------------------------------ publisher
class _TrainPublisher:
    """Process-local buffer of train records with a periodic flush to
    the GCS train channel (same lifecycle handling as the serve
    recorder: the pending flush is presumed dead when aged out or
    spawned on a previous core worker). An ``owner`` StepRecorder may
    attach to contribute heartbeat/memory sidecar records each cycle
    and keep the chain alive while a phase is blocked."""

    def __init__(self, owner=None):
        self._lock = threading.Lock()
        self._buf: list[dict] = []
        self._scheduled = False
        self._scheduled_at = 0.0
        self._scheduled_cw: Optional[weakref.ref] = None
        self._interval: float | None = None
        self._owner = weakref.ref(owner) if owner is not None else None

    def publish(self, record: dict):
        if not recording_enabled():
            return
        cw = self._core_worker()
        if cw is None:
            return
        with self._lock:
            self._buf.append(record)
        self._kick(cw)

    def kick(self):
        """Ensure a flush cycle is pending even with an empty buffer —
        begin_phase calls this so the blocked-phase heartbeat flows
        while the loop is parked inside a phase."""
        if not recording_enabled():
            return
        cw = self._core_worker()
        if cw is not None:
            self._kick(cw)

    def _kick(self, cw):
        with self._lock:
            now = time.monotonic()
            stale = max(2.0, 2.0 * (self._interval or 0.0) + 0.5)
            schedule = (not self._scheduled
                        or now - self._scheduled_at > stale
                        or self._scheduled_cw is None
                        or self._scheduled_cw() is not cw)
            if schedule:
                self._scheduled = True
                self._scheduled_at = now
                self._scheduled_cw = weakref.ref(cw)
        if schedule:
            self._spawn_flush(cw)

    @staticmethod
    def _core_worker():
        try:
            from ray_tpu_torch.core.object_ref import get_core_worker

            cw = get_core_worker()
            if cw is None or cw.gcs is None:
                return None
            return cw
        except Exception:
            return None

    def _spawn_flush(self, cw):
        try:
            cw._spawn_from_thread(self._flush_later(cw))
        except Exception:
            with self._lock:
                self._scheduled = False

    async def _flush_later(self, cw):
        from ray_tpu_torch._internal.config import get_config

        try:
            self._interval = get_config().train_flush_interval_s
            await asyncio.sleep(self._interval)
        except Exception:
            pass
        with self._lock:
            records, self._buf = self._buf, []
        keep_alive = False
        owner = self._owner() if self._owner is not None else None
        if owner is not None:
            try:
                extra, keep_alive = owner._flush_extras()
                records.extend(extra)
            except Exception:
                pass
        try:
            if records and cw.gcs is not None:
                await cw.gcs.publish(CH_TRAIN, records)
        except Exception:
            pass  # best-effort: dropped on GCS hiccup / shutdown
        resume = False
        with self._lock:
            if self._buf or keep_alive:
                resume = True  # records raced in / a phase is blocked
                self._scheduled_at = time.monotonic()
            else:
                self._scheduled = False
        if resume:
            try:
                cw._spawn(self._flush_later(cw))  # already on the IO loop
            except Exception:
                with self._lock:
                    self._scheduled = False

    def flush_now(self):
        """Synchronous best-effort drain (worker teardown): the final
        step records of a run must not die with the actor."""
        with self._lock:
            records, self._buf = self._buf, []
        if not records:
            return
        cw = self._core_worker()
        if cw is None:
            return
        try:
            cw.io.run(cw.gcs.publish(CH_TRAIN, records), timeout=2)
        except Exception:
            pass


_publisher = _TrainPublisher()


def publish_record(record: dict):
    """Best-effort publish of one train-channel record (controller
    side: run lifecycle records); never raises."""
    try:
        _publisher.publish(record)
    except Exception:
        pass


# -------------------------------------------------------------- recorder
class _PhaseCtx:
    __slots__ = ("_rec", "_name")

    def __init__(self, rec: "StepRecorder", name: str):
        self._rec = rec
        self._name = name

    def __enter__(self):
        self._rec.begin_phase(self._name)
        return self

    def __exit__(self, *exc):
        self._rec.end_phase()
        return False


class StepRecorder:
    """Per-worker step-waterfall recorder. One instance per
    (run, rank); the session owns it for trainer runs, the RL learner
    driver owns one directly (same record schema, ``experiment``
    prefixed ``rl:``)."""

    def __init__(self, run_id: str, experiment: str, rank: int = 0,
                 node_id: str = ""):
        self.run_id = run_id
        self.experiment = experiment
        self.rank = rank
        self.node_id = node_id
        self._pub = _TrainPublisher(owner=self)
        self._phase: Optional[tuple] = None  # (name, t0, step)
        self._acc = dict.fromkeys(_PHASES, 0.0)
        self._step = 0
        self._last_step_end: Optional[float] = None
        self._last_mem_ts = 0.0
        self._jit_shapes: dict[str, str] = {}
        self._closed = False

    # ------------------------------------------------------- phase marks
    def phase(self, name: str) -> _PhaseCtx:
        return _PhaseCtx(self, name)

    def begin_phase(self, name: str):
        self._phase = (name, time.perf_counter(), self._step)
        if name in ("data_wait", "ckpt_block"):
            # the block-prone phases arm the heartbeat chain; compute
            # phases ride the chain steps already keep alive
            self._pub.kick()

    def end_phase(self):
        ph = self._phase
        if ph is None:
            return
        self._phase = None
        name, t0, _ = ph
        if name in self._acc:
            self._acc[name] += time.perf_counter() - t0

    def add_stage(self, name: str, seconds: float):
        """Fold an externally-measured duration into the current step's
        stage (ingest already times its queue wait; RL loops time their
        batch drain)."""
        if name in self._acc:
            self._acc[name] += seconds

    # --------------------------------------------------------- step close
    def end_step(self, step: Optional[int] = None, *, tokens=None,
                 loss=None, ckpt_commit_s=None):
        """Close the current step: one waterfall record whose stages
        tile the wall time since the previous end_step. Hot path — a
        few timestamps, dict building, lock + append."""
        now = time.perf_counter()
        if step is not None:
            self._step = step
        wall = (now - self._last_step_end
                if self._last_step_end is not None
                else sum(self._acc.values()))
        self._last_step_end = now
        stages = {f"{k}_s": v for k, v in self._acc.items()}
        self._acc = dict.fromkeys(_PHASES, 0.0)
        rec = {"kind": "step", "run_id": self.run_id,
               "experiment": self.experiment, "rank": self.rank,
               "step": self._step, "wall_s": wall, "stages": stages,
               "ts": time.time()}
        if tokens is not None:
            rec["tokens"] = int(tokens)
        if loss is not None:
            rec["loss"] = float(loss)
        if ckpt_commit_s is not None:
            rec["ckpt_commit_s"] = float(ckpt_commit_s)
        self._step += 1
        self._pub.publish(rec)

    # ---------------------------------------------------- first calls
    def wrap_jit(self, fn, name: str):
        """Wrap a step callable with first-call accounting: the first
        call per argument-shape signature is timed (up to
        ``torch.cuda.synchronize()`` when an output is a CUDA tensor) and
        published as a ``compile`` event; later NEW signatures are
        ``retrace`` events carrying the shape delta."""
        def wrapped(*args, **kwargs):
            prev = self._jit_shapes.get(name)
            sig = _shape_sig(args, kwargs)
            if sig == prev:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync_cuda(out)
            elapsed = time.perf_counter() - t0
            self._jit_shapes[name] = sig
            self._pub.publish({
                "kind": "compile", "run_id": self.run_id,
                "experiment": self.experiment, "rank": self.rank,
                "fn": name,
                "event": "compile" if prev is None else "retrace",
                "compile_s": elapsed, "shape": sig,
                "prev_shape": prev or "", "ts": time.time()})
            return out
        wrapped.__name__ = f"rayt_obs_{name}"
        return wrapped

    # ------------------------------------------------- flush-cycle extras
    def _flush_extras(self):
        """Called by the publisher each flush cycle (IO-loop thread):
        blocked-phase heartbeat + rate-limited memory snapshot. Returns
        (records, keep_alive)."""
        recs: list[dict] = []
        keep = False
        ph = self._phase
        if ph is not None and not self._closed:
            keep = True
            name, t0, step = ph
            blocked = time.perf_counter() - t0
            if blocked >= _stall_grace_s():
                recs.append({"kind": "phase", "run_id": self.run_id,
                             "experiment": self.experiment,
                             "rank": self.rank, "phase": name,
                             "blocked_s": blocked, "step": step,
                             "ts": time.time()})
        now = time.time()
        if not self._closed and now - self._last_mem_ts >= \
                _MEMORY_INTERVAL_S:
            self._last_mem_ts = now
            mem = self._memory_record()
            if mem is not None:
                recs.append(mem)
        return recs, keep

    def _memory_record(self) -> Optional[dict]:
        devices = device_memory_snapshot()
        if not devices:
            return None
        return {"kind": "memory", "run_id": self.run_id,
                "rank": self.rank, "node_id": self.node_id,
                "devices": devices, "ts": time.time()}

    def close(self):
        """Worker teardown: stop sidecars and drain the buffer
        synchronously so the run's final records survive the actor. A run
        that ended before its first flush cycle took a memory snapshot
        lands one here."""
        if not self._closed and self._last_mem_ts == 0.0:
            self._last_mem_ts = time.time()
            mem = self._memory_record()
            if mem is not None:
                self._pub.publish(mem)
        self._closed = True
        self._phase = None
        self._pub.flush_now()


def _stall_grace_s() -> float:
    try:
        from ray_tpu_torch._internal.config import get_config

        return float(get_config().train_stall_grace_s)
    except Exception:
        return 5.0


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _sync_cuda(out) -> None:
    """Wait for the card when any output leaf is a CUDA tensor."""
    torch = sys.modules.get("torch")
    if torch is None:
        return
    for x in _leaves(out):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
            return


def _shape_sig(args, kwargs) -> str:
    """Argument-shape signature for retrace detection: dtype[shape] per
    tensor or array leaf (dicts, lists and tuples flattened), repr for
    other leaves (a changed static arg retraces too — that's exactly
    what we want to catch)."""
    parts = []
    for x in _leaves((args, kwargs)):
        shp = getattr(x, "shape", None)
        if shp is not None:
            dt = getattr(x, "dtype", "?")
            parts.append(f"{dt}[{','.join(map(str, shp))}]")
        else:
            parts.append(repr(x)[:24])
    return "(" + ", ".join(parts) + ")"


def device_memory_snapshot() -> list[dict]:
    """Per-card memory from ``torch.cuda.memory_stats`` (allocated bytes,
    current and peak) for each visible card, when this process has used
    CUDA; host-RSS fallback otherwise, so the gauges stay non-zero on a
    CPU run (the JAX package's fallback on its CPU backend)."""
    devices: list[dict] = []
    torch = sys.modules.get("torch")
    try:
        if torch is not None and torch.cuda.is_initialized():
            for i in range(torch.cuda.device_count()):
                ms = torch.cuda.memory_stats(i)
                used = int(ms.get("allocated_bytes.all.current", 0))
                devices.append({
                    "device": f"cuda:{i}", "bytes_in_use": used,
                    "peak_bytes": int(ms.get("allocated_bytes.all.peak",
                                             used))})
    except Exception:
        devices = []
    if devices:
        return devices
    try:
        import resource

        peak = int(resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss) * 1024
        used = peak
        try:
            with open("/proc/self/statm") as f:
                used = int(f.read().split()[1]) * 4096
        except Exception:
            pass
        return [{"device": "host:0", "bytes_in_use": used,
                 "peak_bytes": peak}]
    except Exception:
        return []
