"""Logical-plan optimizer: rewrite rules over a Dataset's stage list
(ref analogs: python/ray/data/_internal/plan.py + logical/rules/ —
OperatorFusionRule, limit pushdown, redundant-op elimination).

Rules (applied to fixpoint, conservative):
 1. fuse_maps      — consecutive task-pool map stages run inside ONE
                     task (no object-store hop between them). Actor-pool
                     stages don't fuse (distinct pools own state).
 2. push_limit     — _Limit moves ahead of row-preserving 1:1 maps, so
                     upstream tasks stop producing blocks sooner.
 3. drop_shuffles  — a shuffle/sort immediately destroyed by a later
                     shuffle or sort is removed.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ray_tpu_torch.data.executor import MapSpec


def _is_task_map(stage: Any) -> bool:
    return isinstance(stage, MapSpec) and stage.compute is None \
        and stage.kind != "fused"


def fuse_maps(stages: list) -> list:
    out: list = []
    for stage in stages:
        if _is_task_map(stage) and out and (
                _is_task_map(out[-1]) or
                (isinstance(out[-1], MapSpec)
                 and out[-1].kind == "fused")):
            prev = out.pop()
            subs = list(prev.fn) if prev.kind == "fused" else [prev]
            out.append(MapSpec("fused", subs + [stage]))
        else:
            out.append(stage)
    return out


def push_limit(stages: list) -> list:
    from ray_tpu_torch.data.dataset import _Limit

    out = list(stages)
    changed = True
    while changed:
        changed = False
        for i in range(1, len(out)):
            prev, cur = out[i - 1], out[i]
            if isinstance(cur, _Limit) and isinstance(prev, MapSpec) \
                    and prev.kind == "map":
                # plain map is 1:1 on rows: limiting first is equivalent
                # and stops upstream work sooner
                out[i - 1], out[i] = cur, prev
                changed = True
    return out


def drop_shuffles(stages: list) -> list:
    from ray_tpu_torch.data.dataset import _AllToAll

    out: list = []
    for stage in stages:
        if isinstance(stage, _AllToAll) and stage.kind in ("shuffle",
                                                           "sort"):
            if out and isinstance(out[-1], _AllToAll) and \
                    out[-1].kind in ("shuffle", "sort"):
                out.pop()  # its ordering is destroyed by this stage
        out.append(stage)
    return out


RULES = (drop_shuffles, push_limit, fuse_maps)


def optimize(stages: list) -> list:
    for rule in RULES:
        stages = rule(stages)
    return stages


def describe(stages: list) -> list[str]:
    from ray_tpu_torch.data.dataset import _AllToAll, _Limit

    out = []
    for s in stages:
        if isinstance(s, MapSpec):
            if s.kind == "fused":
                out.append("Fused[" + " -> ".join(
                    sub.kind for sub in s.fn) + "]")
            else:
                pool = f" (actors={s.compute.size})" if s.compute else ""
                out.append(s.kind + pool)
        elif isinstance(s, _AllToAll):
            out.append(f"all_to_all:{s.kind}")
        elif isinstance(s, _Limit):
            out.append(f"limit[{s.n}]")
        else:
            out.append(type(s).__name__)
    return out
