"""On-demand worker profiling (ref analog:
dashboard/modules/reporter/profile_manager.py — the reference attaches
py-spy/memray to live workers via ptrace; here the worker samples
ITSELF on request, no ptrace and no extra dependency).

Two probes, both RPC-triggered against any live worker:

* :func:`sample_cpu` — a sampling wall/CPU profiler: a thread polls
  ``sys._current_frames()`` at `interval_s` for `duration_s`, folding
  stacks into collapsed form ("a;b;c count" — flamegraph.pl /
  speedscope input). Cooperative sampling sees exactly what py-spy's
  GIL-holder view sees for pure-Python work.
* :func:`sample_memory` — tracemalloc window: enables tracing for
  `duration_s` and reports the top allocation sites by net new bytes
  (the memray-lite answer to "what is this worker allocating?").
"""

from __future__ import annotations

import sys
import threading
import time
import traceback


def sample_cpu(duration_s: float = 5.0, interval_s: float = 0.01,
               max_frames: int = 64) -> dict:
    """Collapsed-stack samples of every thread in this process."""
    duration_s = min(float(duration_s), 120.0)
    interval_s = max(float(interval_s), 0.001)
    counts: dict[str, int] = {}
    samples = 0
    me = threading.get_ident()
    deadline = time.monotonic() + duration_s
    while time.monotonic() < deadline:
        t0 = time.monotonic()
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue  # the profiler's own sampling loop
            stack = traceback.extract_stack(frame, limit=max_frames)
            key = names.get(ident, str(ident)) + ";" + ";".join(
                f"{f.name} ({f.filename.rsplit('/', 1)[-1]}:{f.lineno})"
                for f in stack)
            counts[key] = counts.get(key, 0) + 1
        samples += 1
        time.sleep(max(0.0, interval_s - (time.monotonic() - t0)))
    return {
        "type": "cpu_samples",
        "duration_s": duration_s,
        "interval_s": interval_s,
        "num_samples": samples,
        "stacks": counts,  # collapsed-stack -> hit count
    }


def sample_memory(duration_s: float = 5.0, top_n: int = 25) -> dict:
    """Net new allocations over a tracemalloc window, by source line."""
    import tracemalloc

    duration_s = min(float(duration_s), 120.0)
    was_tracing = tracemalloc.is_tracing()
    if not was_tracing:
        tracemalloc.start(16)
    try:
        before = tracemalloc.take_snapshot()
        time.sleep(duration_s)
        after = tracemalloc.take_snapshot()
    finally:
        if not was_tracing:
            tracemalloc.stop()
    stats = after.compare_to(before, "lineno")
    top = [{
        "location": str(st.traceback[0]) if st.traceback else "?",
        "size_diff_bytes": st.size_diff,
        "count_diff": st.count_diff,
        "size_bytes": st.size,
    } for st in stats[:top_n]]
    return {
        "type": "memory_window",
        "duration_s": duration_s,
        "top_allocations": top,
        "total_new_bytes": sum(s.size_diff for s in stats
                               if s.size_diff > 0),
    }


def render_collapsed(result: dict) -> str:
    """cpu_samples result -> flamegraph.pl collapsed-stack text."""
    return "\n".join(f"{stack} {count}"
                     for stack, count in sorted(
                         result.get("stacks", {}).items(),
                         key=lambda kv: -kv[1]))


def render_top(result: dict, n: int = 15) -> str:
    """Human summary: hottest leaf functions by inclusive samples."""
    leaf_counts: dict[str, int] = {}
    for stack, count in result.get("stacks", {}).items():
        leaf = stack.rsplit(";", 1)[-1]
        leaf_counts[leaf] = leaf_counts.get(leaf, 0) + count
    total = max(1, sum(leaf_counts.values()))
    lines = [f"{result.get('num_samples', 0)} samples over "
             f"{result.get('duration_s', 0)}s"]
    for leaf, count in sorted(leaf_counts.items(),
                              key=lambda kv: -kv[1])[:n]:
        lines.append(f"{100 * count / total:5.1f}%  {leaf}")
    return "\n".join(lines)
