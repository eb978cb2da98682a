"""DAG recompile-and-resume — worker fault tolerance for the channel
fast path.

The channel-compiled executor (dag/channel_exec.py) trades per-call
fault tolerance for zero-submission ticks: a dead actor loop just stops
touching its rings, and the whole DAG stalls until the driver's read
times out. The stall watchdog (core/gcs_dag_manager.py) already NAMES
the dead peer; this module acts on it (ref analog: the reference's
compiled-graph teardown + lineage story, arXiv:1712.05889 §4.2.3 —
recovery is the third fault-tolerance leg next to retries and the
refcounter).

``RecoverableDag`` wraps a compile function instead of a compiled DAG,
so it can rebuild the ring after a failure:

  1. DETECT — ``get()`` slices its wait into short probes
     (``dag_recovery_probe_s``); on each timeout slice it asks the GCS
     for peer liveness and the watchdog's dead-peer attribution
     (``ChannelCompiledDAG.failed_peers``). No dead peer -> keep
     waiting (an ordinary stall). Dead peer -> recover.
  2. TEAR DOWN — the idempotent close cascade: inputs first, then every
     driver-held channel; surviving actor loops drain and exit.
  3. RESTART — restartable dead actors (``max_restarts != 0``) are
     brought back by the GCS automatically; we wait for ALIVE up to
     ``dag_recovery_restart_timeout_s``. An algorithm-level
     ``recover_cb`` can instead respawn REPLACEMENT actors from its
     specs (RL does this for env runners) and re-push current state
     (weights) onto restarted ones.
  4. RECOMPILE — ``compile_fn(epoch=n+1, recovered_from=old_id)``
     replans every edge (shm/DCN/device re-selected for the NEW
     placement — a restarted actor may land on another node) and
     registers a fresh GCS record linked to the ring it replaces.
  5. RESUME — every not-yet-consumed tick input is resubmitted to the
     new ring in submission order; completed ticks are never replayed.
     Data loss is bounded to the in-flight ticks of the dead actor
     (they re-run from the driver's retained inputs). Frames are
     stamped with the new tick-sequence EPOCH, so stale pre-failure
     frames from surviving peers are discarded rather than
     double-consumed (see ``_EpochTick`` in channel_exec.py).
"""

from __future__ import annotations

import time
from typing import Any, Callable

from ray_tpu_torch._internal.logging_utils import setup_logger
from ray_tpu_torch.dag.channel import ChannelClosed

logger = setup_logger("dag")


class DagRecoveryError(RuntimeError):
    """Recovery could not bring the ring back: a dead actor is not
    restartable (and no recover_cb replaced it), restart timed out, or
    the per-DAG recovery budget is exhausted."""


def actor_state(handle) -> str:
    """Current GCS lifecycle state of an actor handle ("UNKNOWN" on a
    control-plane hiccup)."""
    from ray_tpu_torch.api import _core_worker

    cw = _core_worker()
    try:
        res = cw.io.run(cw.gcs.actor_handle_state(handle._actor_id),
                        timeout=5.0)
        return res[0] if res else "DEAD"
    except Exception:
        return "UNKNOWN"


def wait_actor_alive(handle, timeout_s: float) -> str:
    """Poll until the actor is ALIVE again (GCS auto-restart) or
    terminally DEAD or the deadline passes; returns the last state so
    callers decide between adopt-the-restart and respawn-a-replacement."""
    deadline = time.monotonic() + timeout_s
    state = actor_state(handle)
    while state != "ALIVE":
        if state == "DEAD" or time.monotonic() > deadline:
            return state
        time.sleep(0.2)
        state = actor_state(handle)
    return state


class RecoverableDagRef:
    """Future for one tick that survives ring recovery: resolving it may
    transparently tear down, recompile and resubmit under the hood."""

    def __init__(self, dag: "RecoverableDag", entry: dict):
        self._dag = dag
        self._entry = entry

    def get(self, timeout: float | None = None):
        return self._dag._get(self._entry, timeout)


class RecoverableDag:
    """Channel-compiled DAG with recompile-and-resume on actor death.

    ``compile_fn(epoch=..., recovered_from=...)`` builds a fresh
    compiled DAG from the CURRENT actor set — on a recovery it is called
    again, so an algorithm whose ``recover_cb`` swapped in replacement
    actors gets a graph over the replacements. The wrapper keeps every
    submitted-but-unconsumed tick input and replays them into the new
    ring in order; callers just see ``execute()``/``get()`` as usual.

    When ``compile_fn`` returns the per-call fallback executor
    (``CompiledDAG``), the wrapper degrades to plain delegation: that
    path already has per-call retries.
    """

    def __init__(self, compile_fn: Callable[..., Any], *,
                 recover_cb: Callable[[dict], None] | None = None,
                 name: str = ""):
        from ray_tpu_torch._internal.config import get_config

        self._compile = compile_fn
        self._recover_cb = recover_cb
        self._name = name
        self._cfg = get_config()
        self._epoch = 0
        self._recoveries = 0
        self._last_recovery_s = 0.0
        # ordered submitted-but-unconsumed ticks:
        # {"args", "kwargs", "ref"} — the retained inputs ARE the
        # resume log (bounded by the caller's pipeline depth)
        self._inflight: list[dict] = []
        self._dag = compile_fn(epoch=0, recovered_from="")

    # -------------------------------------------------------- delegation
    @property
    def dag(self):
        """The current inner compiled DAG (changes across recoveries)."""
        return self._dag

    @property
    def dag_id(self) -> str:
        return getattr(self._dag, "dag_id", "")

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def recoveries(self) -> int:
        return self._recoveries

    @property
    def last_recovery_s(self) -> float:
        """Wall time of the most recent teardown→restart→recompile→
        resume cycle (0.0 if no recovery has happened)."""
        return self._last_recovery_s

    @property
    def channel_kinds(self):
        return getattr(self._dag, "channel_kinds", {})

    def teardown(self):
        self._dag.teardown()

    # --------------------------------------------------------- execution
    def execute(self, *args, **kwargs) -> RecoverableDagRef:
        entry = {"args": args, "kwargs": kwargs, "ref": None}
        try:
            entry["ref"] = self._dag.execute(*args, **kwargs)
        except (TimeoutError, ChannelClosed) as e:
            # an input ring full against a dead consumer blocks the
            # write until the tick deadline — same detect/recover path
            failed = self._failed_peers()
            if not failed:
                raise
            self._recover(failed, cause=e)
            entry["ref"] = self._dag.execute(*args, **kwargs)
        self._inflight.append(entry)
        return RecoverableDagRef(self, entry)

    execute_async = execute

    def _get(self, entry: dict, timeout: float | None):
        """Resolve one tick under the caller's deadline, probing peer
        liveness every ``dag_recovery_probe_s`` so a dead runner is
        detected in seconds. A successful recovery RESETS the deadline:
        recovery is forward progress, not a hang."""
        timeout_s = (self._cfg.dag_tick_timeout_s if timeout is None
                     else timeout)
        probe = max(0.5, self._cfg.dag_recovery_probe_s)
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"tick read timed out after {timeout_s:.1f}s with "
                    "every DAG peer alive (stall, not a death) "
                    f"[dag {self.dag_id} epoch {self._epoch}]")
            try:
                val = entry["ref"].get(timeout=min(remaining, probe))
            except TimeoutError:
                failed = self._failed_peers()
                if not failed:
                    continue   # plain slow tick: keep waiting
            except ChannelClosed as e:
                failed = self._failed_peers()
                if not failed:
                    raise
                self._recover(failed, cause=e)
                deadline = time.monotonic() + timeout_s
                continue
            else:
                if entry in self._inflight:
                    self._inflight.remove(entry)
                return val
            self._recover(failed)
            deadline = time.monotonic() + timeout_s

    # ---------------------------------------------------------- recovery
    def _failed_peers(self) -> dict[str, str]:
        try:
            return self._dag.failed_peers()
        except Exception:
            return {}

    def _recover(self, failed: dict[str, str], cause=None):
        from ray_tpu_torch.core.gcs_event_manager import emit_cluster_event

        self._recoveries += 1
        if self._recoveries > self._cfg.dag_recovery_max_attempts:
            raise DagRecoveryError(
                f"dag {self.dag_id}: recovery budget exhausted "
                f"({self._cfg.dag_recovery_max_attempts} attempts); "
                f"dead peers: {failed}")
        old_id = self.dag_id
        t0 = time.monotonic()
        logger.warning(
            "dag %s epoch %d: dead peers %s — tearing down and "
            "recompiling (%s)", old_id, self._epoch, failed,
            self._name or "unnamed")
        emit_cluster_event(
            source="dag", kind="dag_recovery_started",
            severity="WARNING",
            message=(f"dag {old_id} lost peers "
                     f"{sorted(failed)}; recompile-and-resume "
                     f"starting (epoch {self._epoch + 1})"),
            dag_id=old_id, dead_peers=failed, epoch=self._epoch + 1)
        # grab the dead actors' handles BEFORE teardown drops the ring
        dead_handles = [
            h for h in getattr(self._dag, "_actors", {}).values()
            if h._actor_id.hex() in failed]
        self._dag.teardown()
        if self._recover_cb is not None:
            # algorithm-level restart: respawn replacements from specs,
            # wait for GCS restarts, re-push current state (weights)
            self._recover_cb(dict(failed))
        else:
            self._await_restarts(dead_handles)
        self._epoch += 1
        self._dag = self._compile(epoch=self._epoch,
                                  recovered_from=old_id)
        # resume: replay every unconsumed tick input, submission order
        for ent in self._inflight:
            ent["ref"] = self._dag.execute(*ent["args"], **ent["kwargs"])
        took = time.monotonic() - t0
        self._last_recovery_s = took
        logger.warning(
            "dag %s epoch %d: recovered as dag %s in %.2fs "
            "(%d in-flight ticks resubmitted)", old_id, self._epoch,
            self.dag_id, took, len(self._inflight))
        emit_cluster_event(
            source="dag", kind="dag_recovered", severity="WARNING",
            message=(f"dag {old_id} recovered as {self.dag_id} "
                     f"(epoch {self._epoch}) in {took:.2f}s; "
                     f"{len(self._inflight)} in-flight ticks "
                     "resubmitted"),
            dag_id=self.dag_id, recovered_from=old_id,
            epoch=self._epoch, recovery_s=took,
            resubmitted=len(self._inflight))

    def _await_restarts(self, dead_handles: list):
        """Default restart policy: the GCS auto-restarts actors with
        restarts remaining (core/gcs.py _handle_actor_failure); wait for
        each dead peer to come back ALIVE. A peer that stays dead means
        the ring cannot be rebuilt over the same actor set — without a
        recover_cb to respawn replacements, that is fatal."""
        budget = self._cfg.dag_recovery_restart_timeout_s
        deadline = time.monotonic() + budget
        for h in dead_handles:
            state = wait_actor_alive(
                h, max(0.0, deadline - time.monotonic()))
            if state != "ALIVE":
                raise DagRecoveryError(
                    f"dag peer {h._actor_id.hex()} did not return to "
                    f"ALIVE within {budget:.0f}s (state {state}); pass "
                    "a recover_cb that respawns a replacement")
