"""Arithmetic the span readers (``metrics/<name>.py``) share, over the
program's hot-path phases (``ray_tpu_torch.util.phase_spans``): the engine
round's parts in the serving cells, the train step's in the training
cells. Each phase holds its host interval (``perf_counter_ns``) and, on
the card, its device span in ms: the time on the stream between a CUDA
event recorded as it opened and one recorded as it closed.

A phase is in the window when its host end is. Every function returns None
where the window holds no such phase, where a device span is unresolved
(the CPU has none), or where the program has no phases at all.
"""

from __future__ import annotations

from benchmark import readers


def phases(ctx: dict, name: str | None = None, window: bool = True):
    """The run's phases (those in the window, or all), or None where the
    program records none."""
    try:
        from ray_tpu_torch.util import phase_spans
    except ImportError:
        return None
    if window:
        return phase_spans(ctx["t_open"], ctx["t_close"], name)
    return phase_spans(name=name)


def device_ms(ctx: dict, name: str):
    """The device spans of the window's phases called ``name``."""
    got = phases(ctx, name)
    if not got or any(p["device_ms"] is None for p in got):
        return None
    return [p["device_ms"] for p in got]


def mean_device_ms(ctx: dict, name: str):
    ms = device_ms(ctx, name)
    return sum(ms) / len(ms) if ms else None


def median_device_ms(ctx: dict, name: str):
    ms = device_ms(ctx, name)
    return readers.percentile(ms, 50) if ms else None


def _children(ctx: dict, parents: list) -> dict:
    """{parent span id: [its child phases]} over every phase of the run
    (a child may close before the window opens)."""
    ids = {p["span_id"] for p in parents}
    out = {i: [] for i in ids}
    for p in phases(ctx, window=False) or []:
        if p["parent_id"] in ids:
            out[p["parent_id"]].append(p)
    return out


def per_step_ms(ctx: dict, child: str):
    """Device ms of ``child`` phases per ``train.step`` in the window."""
    steps = phases(ctx, "train.step")
    if not steps:
        return None
    total = 0.0
    for kids in _children(ctx, steps).values():
        for p in kids:
            if p["name"] == child:
                if p["device_ms"] is None:
                    return None
                total += p["device_ms"]
    return total / len(steps)


ROUND_DEVICE = ("engine.admit", "engine.prefill", "engine.decode")


def round_idle_ms(ctx: dict):
    """Mean over the window's engine rounds of the round's host time less
    the device spans of its admit, prefill and decode phases and less its
    wait for work: card idle while the engine had work."""
    rounds = phases(ctx, "engine.round")
    if not rounds:
        return None
    kids = _children(ctx, rounds)
    idle = []
    for r in rounds:
        left = (r["end_ns"] - r["start_ns"]) / 1e6
        for p in kids[r["span_id"]]:
            if p["name"] == "engine.wait":
                left -= (p["end_ns"] - p["start_ns"]) / 1e6
            elif p["name"] in ROUND_DEVICE:
                if p["device_ms"] is None:
                    return None
                left -= p["device_ms"]
        idle.append(left)
    return sum(idle) / len(idle)
