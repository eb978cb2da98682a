"""Distributed tracing spans for the task/actor control plane (ref
analog: python/ray/_private/tracing — the reference injects
OpenTelemetry context into task specs so submission and execution link
into one distributed trace).

Self-contained implementation (this image ships only the OTel API
package, no SDK): spans carry W3C ``traceparent`` context — the
interoperable wire format — and export as JSON lines any OTLP bridge
can ingest. ``rayt timeline``'s Chrome trace remains the
zero-dependency view; this is the standards-based one.

Opt-in and zero-overhead when off:

* enable with ``RAYT_TRACING_DIR=/path`` in the driver's environment
  (inherited by every cluster process) — each process appends finished
  spans to ``<dir>/<pid>.spans.jsonl``; :func:`read_spans` aggregates.
* the submitter's active span context rides ``TaskSpec.trace_ctx`` as a
  ``{"traceparent": "00-<trace>-<span>-01"}`` carrier; the executing
  worker opens its span as a REMOTE CHILD, so a whole task tree shares
  one trace id across processes.

Hot-path phases (:func:`phase`) are always on: the engine round and the
train step name their parts into a bounded in-memory ring, each with its
host interval on ``time.perf_counter_ns()`` and, given a CUDA device, its
device span between two CUDA events on the current stream. No phase ever
synchronises the device: a device span resolves once its end event has
completed, seen when a later phase opens (once a few are pending) or when
a reader asks. While a ``torch.profiler`` session records the calling
thread, each phase also opens ``record_function(name)``, so the
profiler's trace names host time by phase on the device trace's own
clock. With ``RAYT_TRACING_DIR`` set, the ring is written to the
process's span file in batches.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import contextvars
import itertools
import json
import os
import secrets
import sys
import threading
import time
from typing import Optional

_lock = threading.Lock()
_enabled: Optional[bool] = None
_out_path: Optional[str] = None
# span stack as a ContextVar of an IMMUTABLE tuple: every asyncio task
# gets its own copy-on-write view (Task captures the context at
# creation), so interleaved tasks on one loop thread can no longer
# parent a submit_span under another task's execute_span — the failure
# mode of the previous threading.local stack. Plain threads still get
# independent stacks (each thread has its own context), and immutability
# means a child task's pushes never leak back into the parent.
_stack_var: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "rayt_otel_span_stack", default=())


def enable_tracing(out_dir: Optional[str] = None) -> None:
    global _enabled, _out_path
    with _lock:
        out_dir = out_dir or os.environ.get("RAYT_TRACING_DIR")
        if not out_dir:
            raise ValueError("enable_tracing() needs out_dir or "
                             "RAYT_TRACING_DIR")
        os.makedirs(out_dir, exist_ok=True)
        _out_path = os.path.join(out_dir, f"{os.getpid()}.spans.jsonl")
        _enabled = True


def tracing_enabled() -> bool:
    """Cheap gate for the hot paths: resolves once per process."""
    global _enabled
    if _enabled is None:
        if os.environ.get("RAYT_TRACING_DIR"):
            try:
                enable_tracing()
            except Exception:
                _enabled = False
        else:
            _enabled = False
    return bool(_enabled)


def _current() -> Optional[tuple[str, str]]:
    """(trace_id, span_id) of the current context's active span."""
    stack = _stack_var.get()
    return stack[-1] if stack else None


def current_context_carrier() -> Optional[dict]:
    """W3C traceparent dict for the ACTIVE span (rides TaskSpec)."""
    cur = _current()
    if cur is None:
        return None
    return {"traceparent": f"00-{cur[0]}-{cur[1]}-01"}


def _parse_carrier(carrier: Optional[dict]) -> tuple[Optional[str],
                                                     Optional[str]]:
    try:
        parts = (carrier or {}).get("traceparent", "").split("-")
        if len(parts) == 4 and len(parts[1]) == 32 and len(parts[2]) == 16:
            return parts[1], parts[2]
    except Exception:
        pass
    return None, None


def _export(span: dict) -> None:
    # observability must never crash user code: swallow everything
    # (unset path, unserializable attrs stringify via default=str)
    try:
        with open(_out_path, "a") as f:
            f.write(json.dumps(span, default=str) + "\n")
    except Exception:
        pass


@contextlib.contextmanager
def _span(name: str, kind: str, trace_id: Optional[str],
          parent_id: Optional[str], attrs: dict):
    """Yields a mutable handle: set handle["ok"] = False for failures
    the body reports as VALUES rather than exceptions (task_error
    tuples)."""
    span_id = secrets.token_hex(8)
    trace_id = trace_id or secrets.token_hex(16)
    entry = (trace_id, span_id)
    _stack_var.set(_stack_var.get() + (entry,))
    start = time.time_ns()
    handle = {"ok": True}
    try:
        yield handle
    except BaseException:
        handle["ok"] = False
        raise
    finally:
        # remove THIS span's entry, not blindly the top: even within one
        # context, generator-driven spans can exit out of LIFO order
        cur = _stack_var.get()
        if entry in cur:
            _stack_var.set(tuple(e for e in cur if e is not entry))
        _export({
            "name": name, "kind": kind,
            "trace_id": trace_id, "span_id": span_id,
            "parent_id": parent_id,
            "start_ns": start, "end_ns": time.time_ns(),
            "attributes": attrs, "status_ok": handle["ok"],
            "pid": os.getpid(),
        })


def submit_span(name: str, **attrs):
    """A submission-side span (driver or calling worker); nests under
    the thread's active span when one exists. No-op when tracing is
    off, so call sites stay unconditional."""
    if not tracing_enabled():
        return contextlib.nullcontext({"ok": True})
    cur = _current()
    return _span(name, "PRODUCER",
                 cur[0] if cur else None,
                 cur[1] if cur else None, attrs)


def execute_span(name: str, carrier: Optional[dict], **attrs):
    """An execution-side span, parented REMOTELY by the submitter's
    carrier when the spec carries one. No-op when tracing is off."""
    if not tracing_enabled():
        return contextlib.nullcontext({"ok": True})
    trace_id, parent_id = _parse_carrier(carrier)
    return _span(f"execute {name}", "CONSUMER", trace_id, parent_id,
                 attrs)


def export_chrome_trace(trace_dir: str, path: str) -> int:
    """Render every exported span as Chrome trace slices via the shared
    exporter in tracing.py (one pid row per process, one tid row per
    trace id — a compiled-DAG tick's producer/consumer spans line up on
    one row because they share the trace id of the tick's caller; phases,
    one row per thread). This process's phases are written out first."""
    from ray_tpu_torch._internal.tracing import export_chrome_trace as _export

    _recorder.flush()
    return _export(read_spans(trace_dir), path)


def read_spans(trace_dir: str) -> list[dict]:
    """Aggregate every process's exported spans (analysis/test helper)."""
    out: list[dict] = []
    for f in sorted(os.listdir(trace_dir)):
        if not f.endswith(".spans.jsonl"):
            continue
        with open(os.path.join(trace_dir, f)) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
    return out


# ------------------------------------------------------ hot-path phases
PHASE_RING = 65_536        # records kept; the oldest are evicted
PHASE_EXPORT_BATCH = 4_096  # records written to the span file at once
PHASE_RESOLVE_AT = 8        # pending device spans that a phase's open settles
_phase_var: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "rayt_otel_phase", default=None)


class _CudaClock:
    """Timing events on a CUDA device's current stream. The stream objects
    are kept by the stream's identity: building one per record costs more
    than the record itself."""

    def __init__(self):
        self._streams: dict = {}

    @staticmethod
    def key(device) -> Optional[int]:
        """The device's index, or None where the device is not a card."""
        if getattr(device, "type", None) != "cuda":
            return None
        import torch

        return (device.index if device.index is not None
                else torch.cuda.current_device())

    @staticmethod
    def event(key: int):
        import torch

        return torch.cuda.Event(enable_timing=True)

    def record(self, event, key: int) -> None:
        torch = sys.modules["torch"]
        ident = torch._C._cuda_getCurrentStream(key)
        stream = self._streams.get(ident)
        if stream is None:
            stream = self._streams[ident] = torch.cuda.Stream(
                stream_id=ident[0], device_index=ident[1],
                device_type=ident[2])
        torch._C._CudaEventBase.record(event, stream)


def _profiler_frame(name: str):
    """``record_function(name)``, entered, while a profiler records this
    thread; else None (torch is only looked up, never imported)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    frame = torch.autograd.profiler.record_function(name)
    frame.__enter__()
    return frame


class Phase:
    """One phase: a context manager that yields itself, and, once closed,
    the record the ring keeps. ``span_id`` names it as a ``parent``."""

    __slots__ = ("name", "span_id", "parent_id", "request_id", "attrs",
                 "thread", "start_ns", "end_ns", "device_ms", "_recorder",
                 "_key", "_events", "_token", "_frame")

    def __init__(self, recorder: "PhaseRecorder", name: str, device,
                 parent: Optional[int], request_id, attrs: dict):
        self._recorder = recorder
        self.name = name
        self.parent_id = parent
        self.request_id = request_id
        self.attrs = attrs
        self._key = None if device is None else recorder.clock.key(device)
        self.device_ms: Optional[float] = None
        self._events = None

    def __enter__(self) -> "Phase":
        rec = self._recorder
        if len(rec._pending) >= PHASE_RESOLVE_AT:
            rec.resolve()
        self.span_id = next(rec._ids)
        if self.parent_id is None:
            self.parent_id = _phase_var.get()
        self._token = _phase_var.set(self.span_id)
        self.thread = threading.get_ident()
        if self.thread not in rec._threads:
            rec._threads[self.thread] = threading.current_thread().name
        if self._key is not None:
            start = rec._event(self._key)
            rec.clock.record(start, self._key)
            self._events = (start, None)
        self._frame = _profiler_frame(self.name)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        rec = self._recorder
        if self._frame is not None:
            self._frame.__exit__(None, None, None)
            self._frame = None
        if self._key is not None and exc[0] is None:
            end = rec._event(self._key)
            rec.clock.record(end, self._key)
            self._events = (self._events[0], end)
            rec._pending.append(self)
        elif self._key is not None:
            # a failed body may have left the device unusable: record
            # nothing more, so its own exception is the one raised
            rec._pools.setdefault(self._key, []).append(self._events[0])
            self._events = None
        try:
            _phase_var.reset(self._token)
        except ValueError:       # closed in another context than opened
            pass
        self._token = None
        rec._ring.append(self)
        if tracing_enabled():
            rec._note_export(self)
        return False

    def as_dict(self) -> dict:
        """The record as the read API returns it: host times on
        ``time.perf_counter_ns()``, the device span in ms (None on the
        CPU or while unresolved)."""
        return {"name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "request_id": self.request_id,
                "attrs": dict(self.attrs), "thread": self.thread,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "device_ms": self.device_ms}


class PhaseRecorder:
    """The ring of closed phases, the pool of timing events and the phases
    whose device spans wait for their end events."""

    def __init__(self, maxlen: int = PHASE_RING, clock=None):
        self.clock = clock if clock is not None else _CudaClock()
        self._ring: collections.deque = collections.deque(maxlen=maxlen)
        self._pending: collections.deque = collections.deque()
        self._pools: dict = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._unexported: list = []
        self._atexit = False
        self._threads: dict = {}    # thread ident -> name, for the export

    def _event(self, key: int):
        try:
            return self._pools[key].pop()
        except (KeyError, IndexError):   # none pooled yet, or none free
            return self.clock.event(key)

    def _settle(self, ph: Phase) -> bool:
        """Resolve ``ph``'s device span if its end event has completed and
        return its events to the pool (lock held). False while pending."""
        if ph._events is None:
            return True
        start, end = ph._events
        if not end.query():
            return False
        ph.device_ms = start.elapsed_time(end)
        ph._events = None
        self._pools.setdefault(ph._key, []).extend((start, end))
        return True

    def resolve(self) -> None:
        """Resolve pending device spans, oldest first, up to the first whose
        end event has not completed. Never waits: another thread resolving
        at the time does the work."""
        if not self._lock.acquire(blocking=False):
            return
        try:
            while self._pending and self._settle(self._pending[0]):
                self._pending.popleft()
        finally:
            self._lock.release()

    def device_ms(self, phases) -> list:
        """The device spans of ``phases`` (None where unresolved or not on
        a card), resolving those whose end events have completed."""
        with self._lock:
            for ph in phases:
                self._settle(ph)
        return [ph.device_ms for ph in phases]

    def spans(self, since: Optional[float] = None,
              until: Optional[float] = None,
              name: Optional[str] = None) -> list[dict]:
        """Closed phases whose host end lies in [since, until] (perf_counter
        seconds; None leaves that side open), oldest close first."""
        self.resolve()
        lo = None if since is None else since * 1e9
        hi = None if until is None else until * 1e9
        return [ph.as_dict() for ph in self._ring.copy()
                if (name is None or ph.name == name)
                and (lo is None or ph.end_ns >= lo)
                and (hi is None or ph.end_ns <= hi)]

    # -- export to RAYT_TRACING_DIR, in batches
    def _note_export(self, ph: Phase) -> None:
        with self._lock:
            self._unexported.append(ph)
            full = len(self._unexported) >= PHASE_EXPORT_BATCH
            if not self._atexit:
                self._atexit = True
                atexit.register(self.flush, True)
        if full:
            self.flush()

    def flush(self, final: bool = False) -> int:
        """Write the phases closed since the last flush to this process's
        span file in one append, as ``read_spans`` dicts (epoch
        nanoseconds). Phases whose device span is still pending wait for
        the next flush, unless ``final``. Returns the count written."""
        if not tracing_enabled():
            return 0
        self.resolve()
        with self._lock:
            todo, self._unexported = self._unexported, []
            keep = [] if final else [ph for ph in todo
                                     if ph._events is not None]
            self._unexported.extend(keep)
        out = [ph for ph in todo if final or ph._events is None]
        if not out:
            return 0
        offset = time.time_ns() - time.perf_counter_ns()
        pid = os.getpid()
        lines = []
        for ph in out:
            attrs = dict(ph.attrs)
            if ph.request_id is not None:
                attrs["request_id"] = ph.request_id
            if ph.device_ms is not None:
                attrs["device_ms"] = ph.device_ms
            lines.append(json.dumps({
                "name": ph.name, "kind": "PHASE", "trace_id": None,
                "span_id": f"{ph.span_id:016x}",
                "parent_id": (None if ph.parent_id is None
                              else f"{ph.parent_id:016x}"),
                "start_ns": ph.start_ns + offset,
                "end_ns": ph.end_ns + offset, "attributes": attrs,
                "status_ok": True, "pid": pid,
                "thread": self._threads.get(ph.thread, str(ph.thread))},
                default=str))
        try:
            with open(_out_path, "a") as f:
                f.write("\n".join(lines) + "\n")
        except (OSError, TypeError):
            return 0
        return len(lines)


_recorder = PhaseRecorder()


def phase(name: str, *, device=None, parent: Optional[int] = None,
          request_id=None, **attrs) -> Phase:
    """A hot-path phase of this process: ``with phase("engine.decode",
    device=dev, parent=round_id) as ph: ...``. ``parent`` defaults to the
    phase open in this context (pass it explicitly across executor
    threads, which do not carry context variables); ``device``, a CUDA
    ``torch.device``, adds the device span (ignored on the CPU); ``attrs``
    are kept with the record."""
    return Phase(_recorder, name, device, parent, request_id, attrs)


def phase_spans(since: Optional[float] = None, until: Optional[float] = None,
                name: Optional[str] = None) -> list[dict]:
    """This process's closed phases whose host end lies in [since, until]
    (``time.perf_counter()`` seconds), as dicts (``Phase.as_dict``)."""
    return _recorder.spans(since, until, name)


def phase_device_s(phases) -> Optional[float]:
    """The summed device spans of ``phases``, in seconds; None where one is
    unresolved or not on a card, or there are none."""
    ms = _recorder.device_ms(phases)
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / 1e3
