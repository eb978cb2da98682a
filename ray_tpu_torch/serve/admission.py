"""Proxy admission control + backpressure primitives (ref analogs:
python/ray/serve/_private/proxy.py request management and the
max_ongoing_requests backpressure story in replica_scheduler/).

The ingress proxies (HTTP + gRPC) size a per-app ADMISSION WINDOW from
the routing table. With a sharded ingress (N proxy replicas behind the
shared table) each proxy admits a SHARE of cluster capacity::

    cluster_window = num_replicas * max_ongoing_requests * headroom
    window         = ceil(cluster_window / live_proxies)

``live_proxies`` rides the same routing-table refresh as replica
capacity (controller counts heartbeating proxies), so a dead proxy's
share redistributes to the survivors within one table refresh — no
extra control traffic, no proxy-to-proxy coordination. The per-proxy
windows sum to the cluster window (within ceil rounding).

Requests beyond the window are SHED immediately (HTTP 503 +
``Retry-After``; gRPC RESOURCE_EXHAUSTED) instead of queueing until the
request timeout — under overload the proxy's answer latency stays flat
and bounded while the excess is pushed back to the client. The headroom
slice (> 1.0) lets a bounded queue absorb bursts: admitted requests
beyond raw replica capacity wait in the ROUTER (DeploymentHandle's
capacity gate), not in an unbounded executor pile-up.

Replica-side queue-full (a replica at ``max_ongoing_requests``) raises
``ReplicaOverloadedError`` — backpressure, not a 500: the router retries
another replica and, if every replica is saturated past the queue
timeout, the error surfaces to the proxy which maps it to 503 /
RESOURCE_EXHAUSTED.

Env knobs (read per request so tests and operators can tune live where
the process inherits the env):

* ``RAYT_SERVE_REQUEST_TIMEOUT_S`` — end-to-end proxy wait for one
  request's result (default 60).
* ``RAYT_SERVE_ADMISSION_HEADROOM`` — window multiplier (default 2.0).
* ``RAYT_SERVE_RETRY_AFTER_S`` — Retry-After hint on shed (default 1).
* ``RAYT_SERVE_QUEUE_TIMEOUT_S`` — router capacity-wait bound
  (default 30; see handle.py).
"""

from __future__ import annotations

import math
import os
import threading

from ray_tpu_torch.core.common import RayTpuError

REQUEST_TIMEOUT_ENV = "RAYT_SERVE_REQUEST_TIMEOUT_S"
HEADROOM_ENV = "RAYT_SERVE_ADMISSION_HEADROOM"
RETRY_AFTER_ENV = "RAYT_SERVE_RETRY_AFTER_S"
QUEUE_TIMEOUT_ENV = "RAYT_SERVE_QUEUE_TIMEOUT_S"


class ReplicaOverloadedError(RayTpuError):
    """Every candidate replica is at max_ongoing_requests (router queue
    timeout hit), or a single replica refused a request at capacity.
    Maps to HTTP 503 / gRPC RESOURCE_EXHAUSTED at the ingress — clients
    should back off and retry."""


def request_timeout_s(default: float = 60.0) -> float:
    try:
        return float(os.environ.get(REQUEST_TIMEOUT_ENV, default))
    except (TypeError, ValueError):
        return default


def queue_timeout_s(default: float = 30.0) -> float:
    try:
        return float(os.environ.get(QUEUE_TIMEOUT_ENV, default))
    except (TypeError, ValueError):
        return default


def retry_after_s() -> int:
    try:
        return max(1, int(float(os.environ.get(RETRY_AFTER_ENV, "1"))))
    except (TypeError, ValueError):
        return 1


def is_overload_error(exc: BaseException) -> bool:
    """True for a ReplicaOverloadedError raised directly OR travelling
    as the ``cause`` of a TaskError (how a replica-side raise reaches
    the caller through rt.get)."""
    if isinstance(exc, ReplicaOverloadedError):
        return True
    return isinstance(getattr(exc, "cause", None), ReplicaOverloadedError)


# shed-EPISODE tracking: a shed after >= _EPISODE_GAP_S of none starts
# a new episode and lands ONE cluster event (the scheduling-plane log
# wants "the proxy started shedding app X at T because Y", not one
# event per 503 — the per-request count stays in rayt_serve_shed_total)
_EPISODE_GAP_S = 10.0
_episode_lock = threading.Lock()
_episodes: dict = {}


def _note_shed_episode(app: str, proxy: str, reason: str):
    import time as _time

    t = _time.monotonic()
    with _episode_lock:
        e = _episodes.get((app, proxy))
        if e is not None and t - e["last"] < _EPISODE_GAP_S:
            e["last"] = t
            e["count"] += 1
            return
        _episodes[(app, proxy)] = {"last": t, "count": 1}
    from ray_tpu_torch.core.gcs_event_manager import emit_cluster_event

    emit_cluster_event(
        source="serve", kind="serve_shed_episode", severity="WARNING",
        message=(f"proxy {proxy} started shedding app {app!r} "
                 f"({reason}) — overload episode"),
        app=app, proxy=proxy, reason=reason)


def count_shed(app: str, proxy: str, reason: str):
    """Increment rayt_serve_shed_total (best-effort; shared by both
    ingress proxies so the tag scheme can't drift). The first shed of
    an episode also lands a WARNING cluster event."""
    try:
        from ray_tpu_torch.util import builtin_metrics as bm

        bm.serve_shed.inc(tags={"app": app, "proxy": proxy,
                                "reason": reason})
    except Exception:
        pass
    try:
        _note_shed_episode(app, proxy, reason)
    except Exception:
        pass


def count_admitted(app: str, proxy: str):
    """Increment rayt_serve_admitted_total (best-effort)."""
    try:
        from ray_tpu_torch.util import builtin_metrics as bm

        bm.serve_admitted.inc(tags={"app": app, "proxy": proxy})
    except Exception:
        pass


class AdmissionWindow:
    """Per-app in-flight accounting for an ingress proxy.

    Thread-safe (the gRPC proxy acquires from server threads; the HTTP
    proxy from its event loop). ``try_acquire`` is the only decision
    point: it recomputes the window from the CURRENT routing-table
    capacity every call, so replica autoscaling grows/shrinks the window
    with no extra control traffic.
    """

    def __init__(self, headroom: float | None = None,
                 proxy_id: str = ""):
        if headroom is None:
            try:
                headroom = float(os.environ.get(HEADROOM_ENV, "2.0"))
            except (TypeError, ValueError):
                headroom = 2.0
        self.headroom = max(1.0, float(headroom))
        self.proxy_id = proxy_id
        self._lock = threading.Lock()
        self._admitted: dict[str, int] = {}
        self._windows: dict[str, int] = {}
        self._cluster_windows: dict[str, int] = {}
        self._shed_total: dict[str, int] = {}
        self._admitted_total: dict[str, int] = {}
        self._live_proxies = 1

    def cluster_window_for(self, num_replicas: int,
                           max_ongoing: int) -> int:
        return max(1, int(math.ceil(
            max(1, num_replicas) * max(1, max_ongoing) * self.headroom)))

    def window_for(self, num_replicas: int, max_ongoing: int,
                   live_proxies: int = 1) -> int:
        """This proxy's share of the cluster admission window. ceil
        keeps every share >= 1 so a proxy never starves; the shares sum
        to the cluster window within (live_proxies - 1) of rounding."""
        cluster = (max(1, num_replicas) * max(1, max_ongoing)
                   * self.headroom)
        return max(1, int(math.ceil(cluster / max(1, live_proxies))))

    def try_acquire(self, app: str, num_replicas: int,
                    max_ongoing: int, live_proxies: int = 1) -> bool:
        window = self.window_for(num_replicas, max_ongoing, live_proxies)
        with self._lock:
            self._windows[app] = window
            self._cluster_windows[app] = self.cluster_window_for(
                num_replicas, max_ongoing)
            self._live_proxies = max(1, int(live_proxies))
            if self._admitted.get(app, 0) >= window:
                self._shed_total[app] = self._shed_total.get(app, 0) + 1
                return False
            self._admitted[app] = self._admitted.get(app, 0) + 1
            self._admitted_total[app] = \
                self._admitted_total.get(app, 0) + 1
            return True

    def release(self, app: str):
        with self._lock:
            n = self._admitted.get(app, 0)
            self._admitted[app] = max(0, n - 1)

    def snapshot(self) -> dict:
        """Per-app admission accounting. ``window`` is THIS proxy's
        share; ``cluster_window`` the whole fleet's (shares x live
        proxies sum back to it within ceil rounding)."""
        with self._lock:
            return {
                app: {
                    "admitted": self._admitted.get(app, 0),
                    "window": self._windows.get(app, 0),
                    "cluster_window": self._cluster_windows.get(app, 0),
                    "admitted_total": self._admitted_total.get(app, 0),
                    "shed_total": self._shed_total.get(app, 0),
                }
                for app in (set(self._admitted) | set(self._windows)
                            | set(self._shed_total)
                            | set(self._admitted_total))
            }

    def fleet_snapshot(self) -> dict:
        """Top-level identity block merged into the /-/admission
        response (kept out of snapshot() so per-app keys stay flat)."""
        with self._lock:
            return {"proxy_id": self.proxy_id,
                    "live_proxies": self._live_proxies}
