"""Fast process spawning for cluster daemons and workers.

The interpreter's `site` import can be arbitrarily expensive (a
sitecustomize hook may import heavy packages). Daemons and workers must
boot in ~100ms for lease latency to be sane (ref analog: raylet
pre-forked worker pool exists for the same reason, worker_pool.h:212), so
we spawn children with ``python -S`` and put the site-packages dirs on
PYTHONPATH explicitly. Nothing is replayed after boot: torch and CUDA need
no site hook, and a task that uses them imports torch itself (``.pth``
files are not read under ``-S``; the site-packages dirs on PYTHONPATH are
what makes torch importable there).
"""

from __future__ import annotations

import os
import sys
import sysconfig


def fast_python_argv(module: str) -> list[str]:
    return [sys.executable, "-S", "-m", module]


def child_env(pkg_root: str, base: dict | None = None) -> dict:
    env = dict(base if base is not None else os.environ)
    paths = [pkg_root]
    for key in ("purelib", "platlib"):
        p = sysconfig.get_paths().get(key)
        if p and p not in paths:
            paths.append(p)
    # any extra dirs site added (e.g. .pth expansions) that hold importable
    # top-level modules like sitecustomize itself
    for p in sys.path:
        if p and p.endswith(("site-packages", "dist-packages")) \
                and p not in paths:
            paths.append(p)
    if base is None or "PYTHONPATH" in env:
        existing = env.get("PYTHONPATH", "")
        if existing:
            paths.append(existing)
    env["PYTHONPATH"] = os.pathsep.join(paths)
    return env

