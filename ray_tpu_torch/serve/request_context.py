"""Serve request-path observability plumbing: the request id minted at
the ingress (echoed as ``X-Rayt-Request-Id``), the batched publisher
that ships partial request records to the GCS serve manager on the
``serve_state`` channel, and the contextvar bridge that lets the
LLMEngine stamp its phase timings (prefill / TTFT / TPOT / occupancy)
into the request being handled without threading a handle through
every engine call.

Publishing mirrors util/metrics.py's _Batcher: records buffer in a
process-local list and a flusher on the core worker's IO loop ships one
publish per ``metrics_flush_interval_s`` — the request hot path costs a
lock + list append, never an RPC. When no cluster is connected (or
``RAYT_SERVE_REQUESTS_ENABLED=0``) records drop at the door.
"""

from __future__ import annotations

import asyncio
import contextvars
import threading
import time
import uuid
import weakref
from typing import Optional

from ray_tpu_torch.core.gcs_serve_manager import CH_SERVE


def mint_request_id() -> str:
    """A fresh request id (uuid4 hex): minted once at the ingress, it
    rides the call envelope into handle -> replica -> engine and keys
    the coalesced GCS record."""
    return uuid.uuid4().hex


def recording_enabled() -> bool:
    """Config gate, resolved per call so RAYT_CONFIG_JSON-spawned
    processes and tests see live values (get_config caches)."""
    try:
        from ray_tpu_torch._internal.config import get_config

        return bool(get_config().serve_requests_enabled)
    except Exception:
        return False


# ------------------------------------------------------------- recorder
class _ServeRecorder:
    """Process-local buffer of partial request / engine records with a
    periodic flush to the GCS serve channel (same lifecycle handling as
    util/metrics.py's _Batcher: the pending flush is presumed dead when
    aged out or spawned on a previous core worker)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._buf: list[dict] = []
        self._scheduled = False
        self._scheduled_at = 0.0
        self._scheduled_cw: Optional[weakref.ref] = None
        self._interval: float | None = None

    def publish(self, record: dict):
        if not recording_enabled():
            return
        cw = self._core_worker()
        if cw is None:
            return
        with self._lock:
            self._buf.append(record)
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
            self._interval = get_config().metrics_flush_interval_s
            await asyncio.sleep(self._interval)
        except Exception:
            pass
        with self._lock:
            records, self._buf = self._buf, []
        try:
            if records and cw.gcs is not None:
                await cw.gcs.publish(CH_SERVE, records)
        except Exception:
            pass  # best-effort: dropped on GCS hiccup / shutdown
        resume = False
        with self._lock:
            if self._buf:
                resume = True  # records raced in during the publish
                self._scheduled_at = time.monotonic()
            else:
                self._scheduled = False
        if resume:
            try:
                cw._spawn(self._flush_later(cw))  # already on the IO loop
            except Exception:
                with self._lock:
                    self._scheduled = False


_recorder = _ServeRecorder()


def publish_record(record: dict):
    """Best-effort publish of one partial record (proxy/replica side);
    never raises on the request path."""
    try:
        _recorder.publish(record)
    except Exception:
        pass


# ------------------------------------------- engine phase-stamp bridge
# the replica sets this around the user-callable invocation; the
# LLMEngine picks it up in generate() and stamps phase timings into it
# from the engine-loop executor threads (plain dict writes — the GIL
# makes the individual float/int stores atomic, and the replica only
# reads after the handler returns)
_request_obs: contextvars.ContextVar[Optional[dict]] = \
    contextvars.ContextVar("rayt_serve_request_obs", default=None)


def current_request_obs() -> Optional[dict]:
    """Inside a replica handler: the mutable observation dict for the
    request being handled (None when recording is off or the call
    didn't come through an instrumented ingress)."""
    return _request_obs.get()


def _set_request_obs(obs: Optional[dict]):
    return _request_obs.set(obs)


def _reset_request_obs(token):
    _request_obs.reset(token)


def engine_section(obs: Optional[dict]) -> Optional[dict]:
    """Fold an engine-stamped observation dict into the record's
    ``engine`` section (replica side, after the handler returns).
    ``prefill_s`` is the host time of the request's prefill calls (their
    dispatch plus any sync inside them), ``prefill_device_s`` their time
    on the card (absent on the CPU). Returns None when the engine never
    touched the request."""
    if not obs or "gen_start" not in obs:
        return None
    first = obs.get("first_token")
    last = obs.get("last_token", first)
    tokens = int(obs.get("tokens", 0))
    out = {
        "queue_s": obs.get("queue_s"),
        "prefill_s": obs.get("prefill_s"),
        "prefill_device_s": obs.get("prefill_device_s"),
        "prefill_chunks": int(obs.get("prefill_chunks", 0)),
        "tokens": tokens,
        "decode_steps": int(obs.get("decode_steps", 0)),
    }
    if first is not None:
        out["ttft_s"] = first - obs["gen_start"]
        if last is not None and last > first and tokens > 1:
            out["decode_s"] = last - first
            out["tpot_s"] = (last - first) / (tokens - 1)
    steps = out["decode_steps"]
    if steps:
        out["occupancy_mean"] = obs.get("occupancy_sum", 0.0) / steps
    for k in ("prefix_cache", "prefix_hit_tokens", "kv_handoff_bytes",
              "kv_handoff_edge"):
        if obs.get(k) is not None:
            out[k] = obs[k]
    if obs.get("pool"):
        # one half of a disagg prefill/decode pair: this side's
        # structural zeros (decode counters on the prefill record,
        # chunk counts on the decode record) would clobber the other
        # half's real values at GCS coalesce time — merge order is
        # flush-cadence luck, so ship only the phases this pool ran
        out = {k: v for k, v in out.items() if v not in (None, 0)}
    return out
