"""What every run shares: the spec (``BENCHMARK.json``), a cell's files
found by name, the metric readers, the comparison with the cell's limits,
and the result line.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); its limits are in ``cells/<cell>.json``. A
metric is read by ``metrics/<metric>.py``, whose ``read(ctx)`` returns a
number, or None where the run holds nothing to read (the metric is then
left out of the line). The mix's ``kind`` picks the driver (``serve.py``
or ``train.py``). So a later cell or metric is new files and new entries
in ``BENCHMARK.json``, and no edit.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "ray_tpu")


class Layout:
    """Where the spec and the benchmark's data files are."""

    def __init__(self, root: Path | None = None, data: Path | None = None):
        self.root = Path(root) if root else HERE.parent
        self.data = Path(data) if data else self.root / HERE.name

    @property
    def spec_path(self) -> Path:
        return self.root / "BENCHMARK.json"

    def spec(self) -> dict:
        return json.loads(self.spec_path.read_text())

    def file(self, kind: str, name: str, suffix: str = ".json") -> Path:
        path = self.data / kind / f"{name}{suffix}"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind[:-1]} file {path}")
        return path

    def json(self, kind: str, name: str) -> dict:
        return json.loads(self.file(kind, name).read_text())


def cell_of(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in spec['workloads']]}")


def metrics_of(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: with ``trace`` its per-layer metrics,
    else its end-to-end ones (``setup_s`` among them)."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def read_metric(layout: Layout, metric: dict, ctx: dict):
    """The metric's reader's number, or None."""
    path = layout.file("metrics", metric["name"], ".py")
    modname = "bench_metric_" + "".join(
        c if c.isalnum() else "_" for c in metric["name"])
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(ctx)
    return None if value is None else float(value)


def compare_limits(checks: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): each reading at or under its
    limit, every limit read, and no problem reported."""
    out, ok = {}, not checks.get("problems")
    readings = checks.get("readings", {})
    for name, limit in limits.items():
        value = readings.get(name)
        out[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            ok = False
    return ok, out


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BANNED)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown: dict | None) -> str:
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks          # last: each number beside its limit
    return json.dumps(line)


def check_lines(checks: dict, problems: list) -> list[str]:
    lines = [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
             for name, c in checks.items()]
    lines += [f"check problem: {p}" for p in problems]
    return lines
