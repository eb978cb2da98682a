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
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import secrets
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
    one row because they share the driver's trace id)."""
    from ray_tpu_torch._internal.tracing import export_chrome_trace as _export

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
