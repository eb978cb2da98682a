"""Autoscaler v2: event-sourced reconciler over the instance manager
(ref analogs: autoscaler/v2/autoscaler.py:42 `Autoscaler` +
instance_manager/reconciler.py — converge desired demand, provider
state, and GCS node state through explicit instance lifecycle events;
_private/autoscaler.py:171 for idle termination).

Slice-granular by design: demand is satisfied by whole slices
(NodeTypeConfig.hosts node processes at once: one GPU host, or a gang of
them launched together), and idle scale-down only retires a slice when
EVERY host in it has been idle past the timeout — you cannot shrink a
slice by one host.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

from ray_tpu_torch._internal.logging_utils import setup_logger
from ray_tpu_torch.autoscaler.instance_manager import (InstanceManager,
                                                       InstanceStatus)
from ray_tpu_torch.autoscaler.node_provider import (NodeProvider,
                                                    NodeTypeConfig)

logger = setup_logger("autoscaler")


class Autoscaler:
    def __init__(self, gcs_server, provider: NodeProvider,
                 node_types: list[NodeTypeConfig],
                 idle_timeout_s: float = 60.0,
                 reconcile_interval_s: float = 1.0):
        self.gcs = gcs_server            # in-process (monitor-in-head)
        self.provider = provider
        self.node_types = {t.name: t for t in node_types}
        self.idle_timeout_s = idle_timeout_s
        self.reconcile_interval_s = reconcile_interval_s
        self._idle_since: dict[str, float] = {}   # slice_id -> ts
        self._task: Optional[asyncio.Task] = None
        self.instance_manager = InstanceManager()
        # cloud provisioning can take minutes; a REQUESTED slice absent
        # from the provider listing is only failed past this deadline
        self.request_timeout_s = 600.0
        # one provider snapshot per tick: reused by every pass AND by
        # stats(), so `rayt status` never blocks on a cloud API call
        self._last_slices: dict[str, dict] = {}
        self.num_scale_ups = 0
        self.num_scale_downs = 0

    def _event(self, kind: str, message: str, severity: str = "INFO",
               **data):
        """Scaling decisions land in the GCS cluster event log
        (monitor-in-head: the event manager is in-process)."""
        record = getattr(self.gcs, "record_event", None)
        if record is not None:
            record(source="autoscaler", kind=kind, message=message,
                   severity=severity, **data)

    def start(self):
        self._task = asyncio.ensure_future(self._loop())

    def stop(self):
        if self._task is not None:
            self._task.cancel()
        shutdown = getattr(self.provider, "shutdown", None)
        if shutdown is not None:
            shutdown()

    async def _loop(self):
        while True:
            try:
                await self.reconcile()
            except Exception:
                logger.exception("reconcile failed")
            await asyncio.sleep(self.reconcile_interval_s)

    # ------------------------------------------------------------ reconcile
    async def reconcile(self):
        """One convergence tick over the three views (ref:
        reconciler.py): observe provider + GCS into instance events, turn
        unmet demand into QUEUED instances, launch QUEUED, retire idle."""
        loop = asyncio.get_running_loop()
        self._last_slices = await loop.run_in_executor(
            None, self.provider.non_terminated_slices)
        self._observe_provider(self._last_slices)
        self._observe_gcs()
        demand = self._unmet_demand()
        if demand:
            self._queue_for_demand(demand, self._last_slices)
        self._ensure_min_slices(self._last_slices)
        await self._launch_queued()
        self._scale_down_idle()
        self.instance_manager.prune_terminal()

    # --------------------------------------------------- observation passes
    def _observe_provider(self, live: dict):
        """Provider state -> instance events: REQUESTED instances whose
        slice appeared become ALLOCATED; ALLOCATED/RUNNING instances
        whose slice VANISHED (preempted, crashed) become FAILED — the
        demand pass then re-queues capacity if still needed. A REQUESTED
        slice not yet visible is normal (cloud provisioning takes
        minutes) until request_timeout_s."""
        im = self.instance_manager
        now = time.time()
        for inst in im.instances(InstanceStatus.REQUESTED):
            if inst.slice_id in live:
                im.transition(
                    inst.instance_id, InstanceStatus.ALLOCATED,
                    "provider reports slice",
                    node_ids=list(live[inst.slice_id].get("node_ids", [])))
            elif inst.slice_id is not None and \
                    now - inst.updated_at > self.request_timeout_s:
                im.transition(inst.instance_id, InstanceStatus.FAILED,
                              "request timed out")
        for inst in im.instances(InstanceStatus.ALLOCATED,
                                 InstanceStatus.RUNNING):
            if inst.slice_id not in live:
                im.transition(inst.instance_id, InstanceStatus.FAILED,
                              "slice vanished from provider")
        for inst in im.instances(InstanceStatus.STOPPING):
            if inst.slice_id not in live:
                im.transition(inst.instance_id, InstanceStatus.TERMINATED,
                              "terminate confirmed")

    def _observe_gcs(self):
        """GCS node state -> instance events: an ALLOCATED instance
        becomes RUNNING when its whole slice registered alive. Matching
        is by the `slice` NODE LABEL (every autoscaled host advertises
        it; provider-agnostic — GCP hosts self-label via the startup
        script) with a node-id fallback for providers that report GCS
        ids directly."""
        im = self.instance_manager
        alive_ids = set()
        by_slice: dict[str, int] = {}
        for nid, info in self.gcs.nodes.items():
            if not info.alive:
                continue
            alive_ids.add(nid.hex())
            label = getattr(info, "labels", {}).get("slice")
            if label:
                by_slice[label] = by_slice.get(label, 0) + 1
        for inst in im.instances(InstanceStatus.ALLOCATED):
            t = self.node_types.get(inst.node_type)
            expected = t.hosts if t is not None else 1
            if by_slice.get(inst.slice_id, 0) >= expected or (
                    inst.node_ids
                    and all(n in alive_ids for n in inst.node_ids)):
                im.transition(inst.instance_id, InstanceStatus.RUNNING,
                              "all hosts registered")

    def _queue_for_demand(self, demands: list[dict], live_slices: dict):
        """Unmet demand -> QUEUED instances, net of capacity already on
        the way (queued/requested/allocated instances count as pending
        supply so one demand doesn't launch a slice per tick)."""
        im = self.instance_manager
        pending: dict[str, int] = {}
        for inst in im.instances(InstanceStatus.QUEUED,
                                 InstanceStatus.REQUESTED,
                                 InstanceStatus.ALLOCATED):
            pending[inst.node_type] = pending.get(inst.node_type, 0) + 1
        for demand in demands:
            t = self._pick_node_type(demand)
            if t is None:
                logger.warning("no node type covers demand %s", demand)
                continue
            if pending.get(t.name, 0) > 0:
                pending[t.name] -= 1   # already on the way
                continue
            live = sum(1 for e in live_slices.values()
                       if e["node_type"] == t.name)
            in_flight = sum(
                1 for i in im.instances(InstanceStatus.QUEUED,
                                        InstanceStatus.REQUESTED)
                if i.node_type == t.name)
            if live + in_flight >= t.max_slices:
                continue
            im.create(t.name)

    def _ensure_min_slices(self, live_slices: dict):
        """Keep each type at its configured floor (min_slices), demand or
        not — `rayt up` pre-warms capacity this way."""
        im = self.instance_manager
        for t in self.node_types.values():
            if t.min_slices <= 0:
                continue
            live = sum(1 for e in live_slices.values()
                       if e["node_type"] == t.name)
            in_flight = sum(
                1 for i in im.instances(InstanceStatus.QUEUED,
                                        InstanceStatus.REQUESTED,
                                        InstanceStatus.ALLOCATED)
                if i.node_type == t.name)
            for _ in range(t.min_slices - live - in_flight):
                im.create(t.name)

    async def _launch_queued(self):
        """QUEUED -> REQUESTED. The instance stays REQUESTED until the
        provider LISTS the slice (next _observe_provider tick): a
        create that returned an id is provisioning, not allocated —
        promoting it here would make slow cloud provisioning read as
        'vanished -> FAILED' and relaunch every tick."""
        im = self.instance_manager
        loop = asyncio.get_running_loop()
        for inst in im.instances(InstanceStatus.QUEUED):
            t = self.node_types.get(inst.node_type)
            if t is None:
                im.transition(inst.instance_id, InstanceStatus.FAILED,
                              "unknown node type")
                continue
            im.transition(inst.instance_id, InstanceStatus.REQUESTED,
                          "launching")
            try:
                slice_id = await loop.run_in_executor(
                    None, self.provider.create_slice, t)
            except Exception as e:
                im.transition(inst.instance_id, InstanceStatus.FAILED,
                              f"create_slice failed: {e}")
                self._event("autoscaler_launch_failed",
                            f"launch of {t.name} failed: {e}",
                            severity="WARNING", node_type=t.name)
                continue
            inst.slice_id = slice_id
            self.num_scale_ups += 1
            self._event("autoscaler_scale_up",
                        f"scale-up: launched slice {slice_id} "
                        f"({t.name}, {t.hosts} host(s)) for unmet "
                        f"demand", node_type=t.name, slice_id=slice_id,
                        hosts=t.hosts)

    def _unmet_demand(self) -> list[dict]:
        """Bundle-shaped demands not satisfiable by current ALIVE nodes.

        STRICT_PACK PGs collapse to one summed bundle (must fit on one
        host); other strategies contribute their bundles individually.
        Pending actors contribute their resource demand.
        """
        pending = self.gcs.rpc_get_pending_demand(None)
        demands: list[dict] = []
        for pg in pending["placement_groups"]:
            if pg["strategy"] == "STRICT_PACK":
                total: dict = {}
                for b in pg["bundles"]:
                    for r, amt in b.items():
                        total[r] = total.get(r, 0.0) + amt
                demands.append(total)
            else:
                demands.extend(dict(b) for b in pg["bundles"])
        demands.extend(pending["actors"])
        demands.extend(pending.get("tasks", []))
        # a DRAINING node's in-use load counts as pending demand: its
        # workloads are migrating off, so replacement capacity must
        # launch before the node is torn down, not after
        demands.extend(pending.get("draining", []))
        # filter out demands some live node could already satisfy in full
        unmet = []
        for d in demands:
            if not self._fits_on_alive_node(d):
                unmet.append(d)
        return unmet

    def _fits_on_alive_node(self, demand: dict) -> bool:
        for nid, info in self.gcs.nodes.items():
            if not info.alive:
                continue
            if (getattr(info, "labels", None) or {}).get("draining"):
                continue  # scheduler won't place there; neither do we
            avail = self.gcs.node_resources_available.get(nid, {})
            if all(avail.get(r, 0.0) >= amt for r, amt in demand.items()):
                return True
        return False

    def _pick_node_type(self, demand: dict) -> Optional[NodeTypeConfig]:
        candidates = []
        for t in self.node_types.values():
            res = dict(t.resources_per_host)
            res.setdefault("CPU", 1.0)
            res[t.head_resource()] = 1.0
            if all(res.get(r, 0.0) >= amt for r, amt in demand.items()):
                candidates.append(t)
        if not candidates:
            return None
        # smallest adequate host (by total resource volume)
        return min(candidates,
                   key=lambda t: sum(t.resources_per_host.values()))

    def _scale_down_idle(self):
        """Terminate slices whose EVERY host has been fully idle (all
        resources available == total) past the idle timeout."""
        now = time.monotonic()
        id_to_info = {nid.hex(): info for nid, info in self.gcs.nodes.items()}
        for slice_id, entry in list(self._last_slices.items()):
            idle = True
            for nid_hex in entry["node_ids"]:
                info = id_to_info.get(nid_hex)
                if info is None or not info.alive:
                    continue  # dead host doesn't block scale-down
                from ray_tpu_torch._internal.ids import NodeID

                avail = self.gcs.node_resources_available.get(
                    NodeID.from_hex(nid_hex), {})
                if any(avail.get(r, 0.0) < amt - 1e-9
                       for r, amt in info.resources_total.items()
                       if r != "memory"):
                    idle = False
                    break
            if not idle:
                self._idle_since.pop(slice_id, None)
                continue
            ntype = entry.get("node_type")
            t = self.node_types.get(ntype)
            if t is not None and t.min_slices > 0:
                live = sum(1 for e in self._last_slices.values()
                           if e["node_type"] == ntype)
                if live <= t.min_slices:
                    continue   # at the floor: never scale below min
            first = self._idle_since.setdefault(slice_id, now)
            if now - first >= self.idle_timeout_s:
                logger.info("scaling down idle slice %s", slice_id)
                self._idle_since.pop(slice_id, None)
                inst = self.instance_manager.by_slice(slice_id)
                if inst is not None:
                    self.instance_manager.transition(
                        inst.instance_id, InstanceStatus.STOPPING,
                        "idle past timeout")
                self.provider.terminate_slice(slice_id)
                self.num_scale_downs += 1
                self._event("autoscaler_scale_down",
                            f"scale-down: terminating slice {slice_id} "
                            f"(idle > {self.idle_timeout_s:g}s)",
                            slice_id=slice_id,
                            idle_timeout_s=self.idle_timeout_s)

    def stats(self) -> dict:
        # served from the last reconcile snapshot: callable from the GCS
        # event loop without touching the (possibly remote) provider
        return {
            "slices": dict(self._last_slices),
            "num_scale_ups": self.num_scale_ups,
            "num_scale_downs": self.num_scale_downs,
            "instances": self.instance_manager.summary(),
            "instance_events": list(self.instance_manager.event_log)[-50:],
        }
