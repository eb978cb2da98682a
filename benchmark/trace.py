"""A device trace over a slice of the measured window, reduced to what the
per-layer readers and the result's ``breakdown`` need.

The session opens with tiny spin kernels and closes after a short idle,
since kineto drops kernel records it places at a session's edges (the
port's ``tools/profile_step`` opens its sessions alike). The slice itself
is marked by a host span, ``bench.trace_slice``; device time is counted
inside that span only.
"""

from __future__ import annotations

import contextlib
import time

WARMUP_KERNELS = 64
SLACK_S = 0.5
SLICE = "bench.trace_slice"
TOP = 10


class Trace:
    """``with Trace(on) as tr: ... with tr.slice(): <traced work>``; after
    the block, ``tr.summary`` holds the reduction (None when off)."""

    def __init__(self, on: bool):
        self.on = on
        self.summary = None
        self._prof = None

    def __enter__(self):
        if not self.on:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        for _ in range(WARMUP_KERNELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        return self

    @contextlib.contextmanager
    def slice(self):
        if not self.on:
            yield
            return
        from torch.profiler import record_function

        with record_function(SLICE):
            yield

    def __exit__(self, *exc):
        if not self.on:
            return False
        import torch

        torch.cuda.synchronize()
        time.sleep(SLACK_S)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = reduce_events(self._prof.events())
        return False


def _union(intervals: list) -> tuple[float, list]:
    """(covered length, merged intervals) of [start, end) pairs."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def reduce_events(events) -> dict:
    """From profiler events (times in microseconds): the slice's length,
    the device's busy time inside it, device time by kernel name, and the
    longest idle gaps, each named by the host op (not a CUDA runtime call)
    that covered it most."""
    from torch.autograd import DeviceType

    spans = [e for e in events if e.name == SLICE
             and e.device_type == DeviceType.CPU]
    if not spans:
        raise RuntimeError("the trace holds no slice span")
    t0 = min(e.time_range.start for e in spans)
    t1 = max(e.time_range.end for e in spans)
    dev, by_name, host = [], {}, []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or \
                    "spin_kernel" in e.name:
                continue
            a, b = max(a, t0), min(b, t1)
            if b <= a:
                continue
            dev.append((a, b))
            row = by_name.setdefault(e.name, [0.0, 0])
            row[0] += b - a
            row[1] += 1
        elif (e.name != SLICE and not e.name.startswith("cuda")
              and b > t0 and a < t1):
            host.append((a, b, e.name))      # ops, not CUDA runtime calls
    busy, merged = _union(dev)
    gaps = []
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((b - a, a, b))
    gaps.sort(reverse=True)
    idle = []
    for length, a, b in gaps[:TOP]:
        idle.append([_host_label(host, a, b), length / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"window_s": (t1 - t0) / 1e6, "busy_s": busy / 1e6,
            "kernels": {k: {"s": v[0] / 1e6, "n": v[1]}
                        for k, v in by_name.items()},
            "device_ops": [[k[:120], v[0] / 1e6] for k, v in ops[:TOP]],
            "idle_gaps": idle}


def _host_label(host: list, a: float, b: float) -> str:
    """The host op that covers most of [a, b), the shortest among equals;
    "host (no op)" where none does."""
    best, best_key = "host (no op)", None
    for ha, hb, name in host:
        cover = min(b, hb) - max(a, ha)
        if cover <= 0:
            continue
        key = (cover, -(hb - ha))
        if best_key is None or key > best_key:
            best, best_key = name, key
    return best[:120]
