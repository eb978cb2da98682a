"""Placement plane: topology-aware global scheduling for gang-shaped work.

The per-task policies in scheduling_policy.py are deliberately local —
each lease request sees one node's queue plus the synced resource view
(the paper's bottom-up scheduler has no global view by design). This
module is the complementary GLOBAL half, hosted in the GCS, for the
decisions that are cluster-shaped:

* **Topology labels** — node managers advertise ``ici-slice`` (hosts
  wired into one ICI mesh; extends the slice-head custom-resource
  advertisement) and ``dcn-locality`` (DCN proximity group, e.g. a rack
  or zone). ``node_schedulable`` in scheduling_policy.py applies them as
  hard filters through the same code path as the ``draining`` label.
* **Measured-cost greedy placer** — candidate nodes are ordered by a
  cost model fed from observability the cluster already collects: the
  per-node pending-lease depth and per-shape queue-wait traces
  (gcs_event_manager, PR 11) and, for DAG advice, per-edge bytes/ticks
  (gcs_dag_manager, PR 9). The new ``SLICE_PACK`` strategy places a
  whole gang inside one ICI slice so channel peers get device/shm edges
  instead of the DCN fallback.
* **Ordered gang admission** — placement-group style two-phase
  reservations are serialized through a FIFO admission queue: at any
  instant at most one gang holds partial prepares, so two concurrent
  gangs each needing more than half the cluster can never deadlock —
  one completes, the other backs off whole and retries after it.
* **Per-job fair-share quotas** — weighted shares of one governed
  resource (default CPU, ``RAYT_QUOTA_RESOURCE``). The GCS computes each
  quota'd job's share and live usage; node managers sync that view on
  the heartbeat cadence and park over-share lease requests behind
  under-share ones (work-conserving: with no contention a burst job
  still uses idle capacity).

The placement-quality metric ``rayt_dag_edges_preferred_kind_ratio`` is
defined here: an edge's *preferred* kind is the co-located one (device
for tensor-annotated payloads, shm for host payloads); the ratio is the
fraction of a DAG's edges whose compiled transport avoided the DCN
fallback. A gang placed through the plane onto one slice compiles to
ratio 1.0; a scattered placement shows exactly how many edges pay DCN.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import re
import time
from typing import Any, Callable, Iterable, Optional

# Topology label taxonomy (advertised by node managers, filtered by
# scheduling_policy.node_schedulable, grouped by the placer):
LABEL_SLICE = "ici-slice"        # hosts in one ICI-connected slice
LABEL_LOCALITY = "dcn-locality"  # DCN proximity group (rack / zone)

# strategies handled by the plane's placer; SLICE_PACK is the new
# topology-aware one (whole gang inside one ici-slice group)
PG_STRATEGIES = ("PACK", "STRICT_PACK", "SPREAD", "STRICT_SPREAD",
                 "SLICE_PACK")

_HEAD_RESOURCE = re.compile(r"^(?P<slice>.+)-head$")


def topology_labels(resources: dict[str, float] | None = None,
                    env: dict[str, str] | None = None) -> dict[str, str]:
    """Derive a node's topology labels at startup.

    Explicit env knobs win (``RAYT_ICI_SLICE`` / ``RAYT_DCN_LOCALITY``);
    otherwise the ICI slice is inferred from an already-advertised
    slice-head custom resource (e.g. ``TPU-v5p-16-head`` -> slice
    ``TPU-v5p-16``), which every host of a multi-host slice advertises.
    Hosts with neither stay unlabeled — the placer treats them as one
    shared anonymous slice, so SLICE_PACK degrades to PACK on clusters
    that never configured topology."""
    env = os.environ if env is None else env
    labels: dict[str, str] = {}
    ici = env.get("RAYT_ICI_SLICE", "")
    if not ici:
        for r in sorted(resources or {}):
            m = _HEAD_RESOURCE.match(r)
            if m:
                ici = m.group("slice")
                break
    if ici:
        labels[LABEL_SLICE] = ici
    loc = env.get("RAYT_DCN_LOCALITY", "")
    if loc:
        labels[LABEL_LOCALITY] = loc
    return labels


def slice_of(view: dict) -> str:
    """A node's slice group key ('' = the anonymous unlabeled slice)."""
    return str((view.get("labels") or {}).get(LABEL_SLICE, ""))


def preferred_kind_summary(edges: Iterable[dict]) -> dict:
    """The placement-quality metric, computed over compiled edges.

    Each edge is ``{"transport": "shm"|"dcn", "device": bool}``. Its
    preferred kind is the co-located one — "device" for tensor-annotated
    payloads, "shm" for host payloads; an edge MATCHES when its
    transport avoided the DCN fallback (peers co-located). Returns
    {"ratio": float|None, "matched", "total", "preferred": [kind, ...]}.
    """
    preferred, matched, total = [], 0, 0
    for e in edges:
        total += 1
        preferred.append("device" if e.get("device") else "shm")
        if e.get("transport") != "dcn":
            matched += 1
    return {"ratio": (round(matched / total, 4) if total else None),
            "matched": matched, "total": total, "preferred": preferred}


class GangAdmission:
    """Ordered, serialized all-or-nothing gang admission.

    The two-phase prepare/commit in core/gcs.py is all-or-nothing per
    gang but says nothing about two gangs racing: each could prepare on
    a disjoint subset at partial capacity, fail the remainder, release,
    and collide again (livelock), or — with retries interleaving — hold
    partial reservations that starve both. Admission fixes that with an
    arrival-ordered FIFO ticket queue (asyncio.Lock wakes waiters in
    FIFO order): the gang at the head of the line runs its entire
    place -> prepare -> commit sequence alone, so it either completes or
    backs off WHOLE before the next gang sees the cluster."""

    def __init__(self):
        self._lock = asyncio.Lock()
        self._seq = 0
        self._active: Optional[str] = None
        self._waiting = 0
        self._admitted = 0
        self._placed = 0
        self._backoffs = 0

    @contextlib.asynccontextmanager
    async def admit(self, gang_id: str):
        self._seq += 1
        self._waiting += 1
        try:
            await self._lock.acquire()
        finally:
            self._waiting -= 1
        self._active = gang_id
        self._admitted += 1
        try:
            yield self._seq
        finally:
            self._active = None
            self._lock.release()

    def note_placed(self, gang_id: str):
        self._placed += 1

    def note_backoff(self, gang_id: str):
        self._backoffs += 1

    def stats(self) -> dict:
        return {"admitted": self._admitted, "placed": self._placed,
                "backoffs": self._backoffs, "waiting": self._waiting,
                "active": self._active}


class QuotaManager:
    """Weighted fair shares of one governed resource across jobs.

    A quota'd job's share is ``max(floor, weight / total_weight *
    cluster_total)`` where total_weight counts every ACTIVE job (jobs
    without an explicit quota participate at ``default_weight`` — they
    dilute shares but are never themselves throttled). Enforcement
    happens in the node managers' lease path against the view the GCS
    computes here; see node_manager._quota_throttled."""

    def __init__(self, resource: str | None = None,
                 default_weight: float = 1.0):
        self.resource = resource or os.environ.get(
            "RAYT_QUOTA_RESOURCE", "CPU")
        self.default_weight = default_weight
        # job_hex -> {"weight": w, "floor": f}
        self.quotas: dict[str, dict] = {}

    def set_quota(self, job_hex: str, weight: float,
                  floor: float = 0.0) -> None:
        if weight <= 0 and floor <= 0:
            self.quotas.pop(job_hex, None)
            return
        self.quotas[job_hex] = {"weight": max(0.0, float(weight)),
                                "floor": max(0.0, float(floor))}

    def snapshot(self) -> dict:
        return {j: dict(q) for j, q in self.quotas.items()}

    def restore(self, saved: dict) -> None:
        for j, q in (saved or {}).items():
            self.quotas[j] = {"weight": float(q.get("weight", 1.0)),
                              "floor": float(q.get("floor", 0.0))}

    def view(self, *, cluster_total: float,
             active_jobs: Iterable[str],
             usage: dict[str, dict[str, float]]) -> dict:
        """-> {job_hex: {"resource","weight","floor","share","used"}}
        for quota'd jobs only (the enforcement set)."""
        if not self.quotas:
            return {}
        participants = set(self.quotas) | set(active_jobs)
        total_w = sum(
            self.quotas.get(j, {}).get("weight", self.default_weight)
            for j in participants) or 1.0
        out = {}
        for j, q in self.quotas.items():
            share = max(q["floor"],
                        q["weight"] / total_w * cluster_total)
            out[j] = {
                "resource": self.resource,
                "weight": q["weight"], "floor": q["floor"],
                "share": round(share, 4),
                "used": round(
                    (usage.get(j) or {}).get(self.resource, 0.0), 4),
            }
        return out


class PlacementPlane:
    """GCS-resident global placer: topology-aware gang placement with
    ordered admission and per-job fair-share quotas.

    Wired with callables into the GCS's live stores so it can be unit
    tested against plain dicts:
      views_fn()        -> {node_hex: {"total","available","alive",
                            "labels", ...}}
      pending_fn(hex)   -> pending-lease depth (gcs_event_manager)
      shape_stats_fn(sk)-> per-shape decision trace or None (PR 11)
      job_usage_fn()    -> {job_hex: {resource: amt}} cluster usage
      active_jobs_fn()  -> iterable of RUNNING job hexes
      dag_stats_fn(id)  -> a DAG's record with per-edge bytes (PR 9)
    """

    def __init__(self, *,
                 views_fn: Callable[[], dict],
                 pending_fn: Callable[[str], int] | None = None,
                 shape_stats_fn: Callable[[str], Any] | None = None,
                 job_usage_fn: Callable[[], dict] | None = None,
                 active_jobs_fn: Callable[[], Iterable[str]] | None = None,
                 dag_stats_fn: Callable[[str], Any] | None = None):
        self._views_fn = views_fn
        self._pending_fn = pending_fn or (lambda h: 0)
        self._shape_stats_fn = shape_stats_fn or (lambda sk: None)
        self._job_usage_fn = job_usage_fn or (lambda: {})
        self._active_jobs_fn = active_jobs_fn or (lambda: ())
        self._dag_stats_fn = dag_stats_fn or (lambda dag_id: None)
        self.admission = GangAdmission()
        self.quotas = QuotaManager()
        self._placements = 0
        self._advises = 0

    # ------------------------------------------------------- cost model
    def node_cost(self, node_hex: str, view: dict,
                  demand: dict[str, float]) -> tuple:
        """Measured placement cost, lower is better: live queue pressure
        (pending-lease depth, PR 11), the shape's observed mean queue
        wait on this cluster, then post-placement critical utilization;
        node id breaks ties stably."""
        from ray_tpu_torch.core.gcs_event_manager import shape_key
        from ray_tpu_torch.core.scheduling_policy import critical_utilization

        pending = int(self._pending_fn(node_hex) or 0)
        qwait = 0.0
        stats = self._shape_stats_fn(shape_key(demand))
        if stats:
            qwait = float(stats.get("queue_wait_mean_s") or 0.0)
        util = critical_utilization(view, demand)
        return (pending, round(qwait, 4), round(util, 4), node_hex)

    # ----------------------------------------------------------- placer
    def place_bundles(self, bundles: list[dict], strategy: str,
                      views: dict | None = None, *,
                      exclude: set[str] | None = None
                      ) -> list[str] | None:
        """Greedy all-or-nothing placement of a gang's bundles onto the
        current view: a node-hex per bundle, or None when the gang does
        not fit whole. Pure decision — reservation (two-phase commit)
        stays with the caller, inside the admission window."""
        from ray_tpu_torch.core.scheduling_policy import node_schedulable

        views = self._views_fn() if views is None else views
        cands = {h: v for h, v in views.items()
                 if (not exclude or h not in exclude)
                 and node_schedulable(v)}
        if not cands or not bundles:
            return None if bundles else []
        agg: dict[str, float] = {}
        for b in bundles:
            for r, amt in b.items():
                agg[r] = agg.get(r, 0.0) + amt
        order = sorted(
            cands, key=lambda h: self.node_cost(h, cands[h], agg))
        if strategy == "SLICE_PACK":
            placement = self._slice_pack(bundles, cands, order)
        elif strategy in ("PACK", "STRICT_PACK"):
            placement = self._pack(bundles, cands, order)
            if placement is not None and strategy == "STRICT_PACK" \
                    and len(set(placement)) > 1:
                placement = None
        else:  # SPREAD / STRICT_SPREAD
            placement = self._spread(bundles, cands, order,
                                     strict=(strategy == "STRICT_SPREAD"))
        if placement is not None:
            self._placements += 1
        return placement

    @staticmethod
    def _fits(avail: dict, demand: dict) -> bool:
        return all(avail.get(r, 0.0) >= amt - 1e-9
                   for r, amt in demand.items())

    @staticmethod
    def _take(avail: dict, demand: dict):
        for r, amt in demand.items():
            avail[r] = avail.get(r, 0.0) - amt

    def _pack(self, bundles, cands, order) -> list[str] | None:
        tentative = {h: dict(cands[h].get("available") or {})
                     for h in order}
        placement: list[str] = []
        for demand in bundles:
            placed = False
            # PACK prefers reusing nodes already holding bundles, then
            # the measured-cost order
            for h in sorted(order, key=lambda n: -placement.count(n)):
                if self._fits(tentative[h], demand):
                    self._take(tentative[h], demand)
                    placement.append(h)
                    placed = True
                    break
            if not placed:
                return None
        return placement

    def _spread(self, bundles, cands, order, *,
                strict: bool) -> list[str] | None:
        tentative = {h: dict(cands[h].get("available") or {})
                     for h in order}
        placement: list[str] = []
        for demand in bundles:
            placed = False
            for h in sorted(order, key=lambda n: placement.count(n)):
                if strict and h in placement:
                    continue
                if self._fits(tentative[h], demand):
                    self._take(tentative[h], demand)
                    placement.append(h)
                    placed = True
                    break
            if not placed:
                return None
        return placement

    def _slice_pack(self, bundles, cands, order) -> list[str] | None:
        """All bundles inside ONE ici-slice group (multiple hosts of the
        slice are fine — they share the ICI mesh). Slice groups are
        tried in measured-cost order (cheapest member first); unlabeled
        nodes form one shared anonymous slice, so SLICE_PACK on a
        topology-free cluster behaves like PACK."""
        groups: dict[str, list[str]] = {}
        for h in order:  # order preserved inside each group
            groups.setdefault(slice_of(cands[h]), []).append(h)
        for _slice in sorted(groups, key=lambda s: order.index(
                groups[s][0])):
            members = groups[_slice]
            placement = self._pack(
                bundles, {h: cands[h] for h in members}, members)
            if placement is not None:
                return placement
        return None

    # ------------------------------------------------------- DAG advice
    def advise_dag(self, *, demands: list[dict],
                   edge_nodes: list[tuple[str | None, str | None]],
                   dag_id: str = "",
                   views: dict | None = None) -> dict:
        """The compile-time consult: given a DAG's per-actor demands and
        its edges' CURRENT endpoint nodes (None = the driver), say where
        the plane would put the gang and how many edges that placement
        would co-locate. Edge weights come from the dag manager's
        measured per-edge bytes when `dag_id` names a known ring (a
        recovery recompile), else every edge weighs 1."""
        views = self._views_fn() if views is None else views
        self._advises += 1
        advised = self.place_bundles(demands, "SLICE_PACK", views)
        weights = {}
        rec = self._dag_stats_fn(dag_id) if dag_id else None
        if rec:
            weights = {i: max(1, int(e.get("bytes", 0)))
                       for i, e in enumerate(
                           (rec.get("edges") or {}).values())}
        co, cross, wco, wcross = 0, 0, 0, 0
        advised_slices = {slice_of(views[h]) for h in advised or ()
                          if h in views}
        one_slice = len(advised_slices) <= 1 and advised is not None
        for i, (p, c) in enumerate(edge_nodes):
            w = weights.get(i, 1)
            p_slice = slice_of(views.get(p) or {}) if p else None
            c_slice = slice_of(views.get(c) or {}) if c else None
            if p_slice == c_slice:
                co, wco = co + 1, wco + w
            else:
                cross, wcross = cross + 1, wcross + w
        total = co + cross
        return {
            "advised_nodes": advised,
            "advised_one_slice": one_slice,
            "co_located_edges": co, "cross_slice_edges": cross,
            "co_located_ratio": (round(co / total, 4) if total
                                 else None),
            "cross_slice_bytes_weighted": wcross,
        }

    # ------------------------------------------------------ quota plane
    def cluster_total(self, views: dict | None = None) -> float:
        """Cluster capacity of the governed resource over schedulable
        nodes; PG-scoped reservation keys (``{r}_pg_{hex}_{i}``) are
        aliases of capacity already counted, so they are skipped."""
        from ray_tpu_torch.core.scheduling_policy import node_schedulable

        views = self._views_fn() if views is None else views
        res = self.quotas.resource
        return sum(
            (v.get("total") or {}).get(res, 0.0)
            for v in views.values() if node_schedulable(v))

    def quota_view(self, views: dict | None = None) -> dict:
        if not self.quotas.quotas:
            return {}
        return self.quotas.view(
            cluster_total=self.cluster_total(views),
            active_jobs=self._active_jobs_fn(),
            usage=self._job_usage_fn())

    # ------------------------------------------------------------ state
    def state(self) -> dict:
        """`rayt status` / dashboard surface: quota ledger, gang
        admission counters, and the topology map (slice -> nodes)."""
        views = self._views_fn()
        slices: dict[str, list[str]] = {}
        localities: dict[str, list[str]] = {}
        for h, v in views.items():
            if not v.get("alive"):
                continue
            labels = v.get("labels") or {}
            slices.setdefault(
                str(labels.get(LABEL_SLICE, "")), []).append(h)
            loc = labels.get(LABEL_LOCALITY)
            if loc:
                localities.setdefault(str(loc), []).append(h)
        return {
            "ts": time.time(),
            "resource": self.quotas.resource,
            "cluster_total": self.cluster_total(views),
            "quotas": self.quota_view(views),
            "gangs": self.admission.stats(),
            "placements": self._placements,
            "advises": self._advises,
            "slices": {s: sorted(ns) for s, ns in slices.items()},
            "localities": {s: sorted(ns)
                           for s, ns in localities.items()},
        }
