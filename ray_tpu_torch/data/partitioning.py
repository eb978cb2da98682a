"""Partition scheme <-> path mapping for partitioned file reads/writes
(ref analog: python/ray/data/datasource/partitioning.py —
`Partitioning`, `PathPartitionEncoder/Parser`).

Hive style encodes every field as ``col=value`` path segments
(``base/country=us/year=2024/part-....parquet``); directory style
encodes bare values in field order (``base/us/2024/...``). Values are
stringified on encode; parse best-effort casts numeric-looking values
back to int/float (standard hive-reader inference — note a zero-padded
string like ``"007"`` comes back as ``7``; use non-numeric values when
the spelling matters), everything else stays a string.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional
from urllib.parse import quote, unquote

from ray_tpu_torch.data.block import Block, iter_rows


@dataclasses.dataclass(frozen=True)
class Partitioning:
    """A partition scheme: which columns key the directory tree and how
    they are spelled into it."""

    field_names: tuple
    style: str = "hive"  # "hive" (col=value) | "dir" (bare values)

    def __post_init__(self):
        object.__setattr__(self, "field_names", tuple(self.field_names))
        if self.style not in ("hive", "dir"):
            raise ValueError(f"unknown partition style {self.style!r}")
        if not self.field_names:
            raise ValueError("Partitioning requires at least one field")

    # ------------------------------------------------------------- encode
    def relpath(self, values: dict) -> str:
        """The partition directory (relative) for one field-value set."""
        parts = []
        for f in self.field_names:
            if f not in values:
                raise KeyError(f"partition field {f!r} missing from row")
            v = quote(str(values[f]), safe="")
            parts.append(f"{quote(str(f), safe='')}={v}"
                         if self.style == "hive" else v)
        return os.path.join(*parts)

    # -------------------------------------------------------------- parse
    def parse(self, path: str, base_dir: Optional[str] = None) -> dict:
        """Partition field values encoded in ``path`` (a file or dir path,
        absolute or relative to ``base_dir``). Unmatched fields are
        simply absent, so callers can detect non-partitioned files."""
        rel = os.path.relpath(path, base_dir) if base_dir else path
        segments = [s for s in rel.split(os.sep)
                    if s not in ("", ".", "..")]
        # drop a trailing FILENAME segment. Hive partition segments
        # always carry "=", so a dotted value dir ("ratio=0.5") is
        # never mistaken for a file; dir style has no such marker and
        # keeps the dotted-name heuristic.
        if segments and "." in segments[-1] and (
                self.style == "dir" or "=" not in segments[-1]):
            segments = segments[:-1]
        out: dict = {}
        if self.style == "hive":
            for seg in segments:
                if "=" not in seg:
                    continue
                k, _, v = seg.partition("=")
                k = unquote(k)
                if k in self.field_names:
                    out[k] = _auto_cast(unquote(v))
        else:
            # dir style: the LAST len(fields) segments are the values
            tail = segments[-len(self.field_names):]
            if len(tail) == len(self.field_names):
                for f, seg in zip(self.field_names, tail):
                    out[f] = _auto_cast(unquote(seg))
        return out


def _auto_cast(v: str):
    """Best-effort cast of a path-encoded partition value back to a
    scalar (hive readers do the same; strings stay strings)."""
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def split_by_partition(block: Block,
                       partitioning: Partitioning) -> dict[str, list]:
    """Group a block's rows by their partition directory. Returns
    {relative partition dir -> rows with the partition fields REMOVED}
    (hive semantics: the path carries the values, the file doesn't)."""
    fields = set(partitioning.field_names)
    groups: dict[str, list] = {}
    for row in iter_rows(block):
        rel = partitioning.relpath(row)
        kept = {k: v for k, v in row.items() if k not in fields}
        groups.setdefault(rel, []).append(kept)
    return groups
