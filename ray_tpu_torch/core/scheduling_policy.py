"""Cluster scheduling policies, shared by the GCS actor scheduler and the
node managers' task spillback.

Ref analogs: src/ray/raylet/scheduling/policy/ —
hybrid_scheduling_policy.h:85 (top-k critical-resource scoring),
spread_scheduling_policy.cc (round-robin over feasible nodes),
node_affinity / node_label policies, plus the "draining" filter.

Every policy consumes the same view shape the GCS broadcasts
(`get_cluster_resources`): {node_hex: {"total", "available", "alive",
"address", "labels"}}.
"""

from __future__ import annotations

import random
from typing import Any

from ray_tpu_torch.core.common import (NodeAffinitySchedulingStrategy,
                                       NodeLabelSchedulingStrategy)

# Hybrid policy knobs (ref: RAY_scheduler_top_k_fraction /
# scheduler_spread_threshold in ray_config_def.h)
TOP_K = 3
SPREAD_THRESHOLD = 0.5


def node_schedulable(view: dict,
                     topology: dict[str, str] | None = None) -> bool:
    """THE shared liveness/label filter every policy (and the placement
    plane) routes through: a node takes new work only if it is alive and
    not draining, and — when a topology constraint is given — its
    topology labels (``ici-slice`` / ``dcn-locality``, advertised by the
    node manager; see core/placement.py) match exactly."""
    if not view.get("alive"):
        return False
    labels = view.get("labels") or {}
    if labels.get("draining"):
        return False
    if topology:
        for k, v in topology.items():
            if labels.get(k) != v:
                return False
    return True


def feasible(view: dict, demand: dict[str, float],
             topology: dict[str, str] | None = None) -> bool:
    if not node_schedulable(view, topology):
        return False
    avail = view.get("available", {})
    return all(avail.get(r, 0.0) >= amt - 1e-9 for r, amt in demand.items())


def capacity_feasible(view: dict, demand: dict[str, float],
                      topology: dict[str, str] | None = None) -> bool:
    """Could this node EVER run the demand (total capacity, ignoring
    current usage)? Used to route constrained tasks to a busy-but-matching
    node's lease queue instead of declaring them infeasible."""
    if not node_schedulable(view, topology):
        return False
    total = view.get("total", {})
    return all(total.get(r, 0.0) >= amt - 1e-9 for r, amt in demand.items())


def critical_utilization(view: dict, demand: dict[str, float]) -> float:
    """Max over resources of (used + demand) / total AFTER placing the
    demand — the reference's 'critical resource utilization' score."""
    total = view.get("total", {})
    avail = view.get("available", {})
    worst = 0.0
    for r, cap in total.items():
        if cap <= 0:
            continue
        used = cap - avail.get(r, 0.0) + demand.get(r, 0.0)
        worst = max(worst, used / cap)
    return worst


def _label_groups(candidates: list[tuple[str, dict]],
                  strategy: NodeLabelSchedulingStrategy | None):
    """Apply hard label filtering; return (preferred, rest) by soft
    labels."""
    if strategy is None:
        return candidates, []
    if strategy.hard:
        candidates = [
            (nid, v) for nid, v in candidates
            if all(v.get("labels", {}).get(k) == val
                   for k, val in strategy.hard.items())]
    if not strategy.soft:
        return candidates, []
    preferred = [
        (nid, v) for nid, v in candidates
        if all(v.get("labels", {}).get(k) == val
               for k, val in strategy.soft.items())]
    rest = [c for c in candidates if c not in preferred]
    return preferred, rest


def hybrid_pick(views: dict[str, dict], demand: dict[str, float],
                *, exclude: set[str] | None = None,
                label_strategy: NodeLabelSchedulingStrategy | None = None,
                top_k: int = TOP_K, rng: random.Random | None = None,
                by_capacity: bool = False) -> str | None:
    """The default policy (ref hybrid_scheduling_policy.h:85): among
    feasible nodes, prefer those whose post-placement critical-resource
    utilization stays under SPREAD_THRESHOLD (packing up to the threshold,
    spreading past it), then pick uniformly among the best `top_k` to
    avoid herd behavior when many callers schedule concurrently."""
    rng = rng or random
    fit = capacity_feasible if by_capacity else feasible
    cands = [(nid, v) for nid, v in views.items()
             if (exclude is None or nid not in exclude)
             and fit(v, demand)]
    for group in _label_groups(cands, label_strategy):
        if not group:
            continue
        # under-threshold nodes TIE (score 0) and pack in stable id order
        # — the reference's semantics: pack until the threshold, spread by
        # utilization past it (hybrid_scheduling_policy.h:85)
        scored = sorted(
            ((critical_utilization(v, demand), nid) for nid, v in group),
            key=lambda t: ((t[0] if t[0] >= SPREAD_THRESHOLD else 0.0),
                           t[1]))
        top = scored[:max(1, top_k)]
        return rng.choice(top)[1]
    return None


def spread_pick(views: dict[str, dict], demand: dict[str, float],
                counter: int, *,
                label_strategy: NodeLabelSchedulingStrategy | None = None,
                by_capacity: bool = False) -> str | None:
    """SPREAD strategy: round-robin over feasible nodes in stable (id)
    order — `counter` is the caller's monotonically increasing pick
    count (ref: spread_scheduling_policy.cc)."""
    fit = capacity_feasible if by_capacity else feasible
    cands = [(nid, v) for nid, v in sorted(views.items())
             if fit(v, demand)]
    for group in _label_groups(cands, label_strategy):
        if group:
            return group[counter % len(group)][0]
    return None


def pick_node(views: dict[str, dict], demand: dict[str, float],
              strategy: Any = None, *, exclude: set[str] | None = None,
              spread_counter: int = 0,
              rng: random.Random | None = None,
              by_capacity: bool = False) -> str | None:
    """Strategy dispatch. Returns a node id hex or None.

    strategy: None (hybrid) | "SPREAD" | NodeAffinitySchedulingStrategy |
    NodeLabelSchedulingStrategy. PG strategies never reach here — their
    demands are rewritten onto reserved bundle resources upstream
    (core_worker._demand_for)."""
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        nid = strategy.node_id.hex()
        view = views.get(nid)
        if view is not None and feasible(view, demand):
            return nid
        if not strategy.soft:
            return None
        return hybrid_pick(views, demand, exclude=exclude, rng=rng)
    label = strategy if isinstance(strategy,
                                   NodeLabelSchedulingStrategy) else None
    if strategy == "SPREAD":
        return spread_pick(views, demand, spread_counter,
                           label_strategy=label)
    return hybrid_pick(views, demand, exclude=exclude,
                       label_strategy=label, rng=rng,
                       by_capacity=by_capacity)
