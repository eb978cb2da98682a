"""Checkpoint directory abstraction + top-k manager (ref analogs:
train/_internal/framework_checkpoint.py `Checkpoint`,
train/_internal/checkpoint_manager.py, _internal/storage.py).

The port of ray_tpu/train/checkpoint.py. `save_pytree`/`load_pytree`
write the JAX package's fallback format, a pickle of host numpy copies
(``pytree.pkl``), so either package reads the other's checkpoints; there
is no orbax (it is jax's), and a directory holding an orbax checkpoint
raises ``ValueError``.
"""

from __future__ import annotations

import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
from contextlib import contextmanager
from typing import Any, Optional

import numpy as np


class Checkpoint:
    """A directory of framework-agnostic checkpoint data."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_dict(cls, data: dict) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="rayt-ckpt-")
        with open(os.path.join(d, "dict_checkpoint.pkl"), "wb") as f:
            pickle.dump(data, f)
        return cls(d)

    def to_dict(self) -> dict:
        with open(os.path.join(self.path, "dict_checkpoint.pkl"), "rb") as f:
            return pickle.load(f)

    def to_directory(self, target: Optional[str] = None) -> str:
        if target is None:
            return self.path
        os.makedirs(target, exist_ok=True)
        shutil.copytree(self.path, target, dirs_exist_ok=True)
        return target

    @contextmanager
    def as_directory(self):
        yield self.path

    def subdir(self, name: str) -> "Checkpoint":
        return Checkpoint(os.path.join(self.path, name))

    def exists(self) -> bool:
        return os.path.isdir(self.path)

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))


# ------------------------------------------------------------- pytree io
_PICKLE = "pytree.pkl"
# a bf16 leaf travels as its bits: a uint16 array under a one-field
# structured dtype whose field name is the tag (numpy alone can read it)
_BF16 = np.dtype([("bfloat16", "<u2")])


def _host_leaf(x):
    """One leaf as a host copy: a torch tensor (any device) becomes a
    numpy array, bf16 as its bits under the ``_BF16`` tag; anything else
    goes through ``np.asarray``, as the JAX package maps every leaf. torch
    is only consulted when the caller already imported it."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().copy().view(_BF16)
        return t.numpy().copy()
    return np.asarray(x)


def _map(fn, tree):
    """Map over the leaves of dicts, lists and tuples (None stays None,
    as an empty subtree in jax.tree)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def _restore_leaf(x):
    if isinstance(x, np.ndarray) and x.dtype == _BF16:
        import torch

        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return x


def _check_format(path: str) -> None:
    if os.path.isdir(os.path.join(path, "pytree")):
        raise ValueError(
            f"{path} holds an orbax checkpoint (a 'pytree/' directory), "
            "which the JAX package writes when orbax is importable; this "
            f"package reads the pickle format ({_PICKLE}) only")


def save_pytree(state: Any, path: str) -> None:
    """Write a pytree (dicts, lists, tuples) of tensors, arrays and
    scalars to ``path/pytree.pkl``: a pickle (protocol 5) of host numpy
    copies, the JAX package's fallback format, so its ``load_pytree``
    reads what this one writes. bf16 leaves keep their bits (``_BF16``)."""
    os.makedirs(path, exist_ok=True)
    host_state = _map(_host_leaf, state)
    with open(os.path.join(path, _PICKLE), "wb") as f:
        pickle.dump(host_state, f, protocol=5)


class AsyncSave:
    """Handle for an in-flight async checkpoint save: ``block_s`` is the
    synchronous slice the caller paid (device->host staging — the
    ``ckpt_block_s`` waterfall stage), ``wait()`` joins the background
    commit and returns its duration (``ckpt_commit_s``). The next train
    step runs while the commit streams to storage."""

    def __init__(self, block_s: float, waiter, commit_t0: float):
        self.block_s = block_s
        self._waiter = waiter
        self._t0 = commit_t0
        self._commit_s: Optional[float] = None
        self._lock = threading.Lock()

    @property
    def done(self) -> bool:
        return self._commit_s is not None

    @property
    def commit_s(self) -> Optional[float]:
        return self._commit_s

    def wait(self) -> float:
        """Join the background commit (idempotent). Returns the commit
        duration in seconds, measured from the moment the staging slice
        returned — the overlap the async path buys is this minus
        whatever compute ran in the meantime."""
        with self._lock:
            if self._commit_s is None:
                self._waiter()
                self._commit_s = time.perf_counter() - self._t0
            return self._commit_s


def save_pytree_async(state: Any, path: str) -> AsyncSave:
    """Async variant of save_pytree: stage synchronously (the host copy
    of every leaf, device -> host), pickle it on a daemon thread, return
    an :class:`AsyncSave`. Callers MUST ``wait()`` before treating the
    checkpoint as durable (session.report's marker protocol, or the next
    save into the same directory)."""
    os.makedirs(path, exist_ok=True)
    t0 = time.perf_counter()
    host_state = _map(_host_leaf, state)
    staged = time.perf_counter()

    def _commit():
        with open(os.path.join(path, _PICKLE), "wb") as f:
            pickle.dump(host_state, f, protocol=5)

    th = threading.Thread(target=_commit, name="rayt-ckpt-commit",
                          daemon=True)
    th.start()
    return AsyncSave(staged - t0, th.join, staged)


def load_pytree(path: str, target: Any = None) -> Any:
    """Load a pytree saved by save_pytree (by this package or the JAX
    package's pickle fallback). Leaves come back as numpy arrays, but
    bf16 ones, which numpy cannot hold here: those come back as CPU
    ``torch.bfloat16`` tensors with the saved bits. ``target`` (the
    reference's sharded restore) has no meaning on one device and is
    ignored. An orbax directory raises ``ValueError``."""
    _check_format(path)
    with open(os.path.join(path, _PICKLE), "rb") as f:
        return _map(_restore_leaf, pickle.load(f))


class _TrackedCheckpoint:
    __slots__ = ("checkpoint", "metrics", "index")

    def __init__(self, checkpoint: Checkpoint, metrics: dict, index: int):
        self.checkpoint = checkpoint
        self.metrics = metrics
        self.index = index


class CheckpointManager:
    """Keeps the top-k checkpoints by a score attribute (ref:
    train/_internal/checkpoint_manager.py)."""

    def __init__(self, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None,
                 score_order: str = "max"):
        assert score_order in ("max", "min")
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._tracked: list[_TrackedCheckpoint] = []
        self._index = 0
        self.latest: Optional[Checkpoint] = None

    def register(self, checkpoint: Checkpoint, metrics: dict) -> None:
        self.latest = checkpoint
        existing = next((t for t in self._tracked
                         if t.checkpoint.path == checkpoint.path), None)
        if existing is not None:
            # same directory re-reported (e.g. a fixed user path): update
            # in place instead of tracking duplicates forever
            existing.metrics = dict(metrics)
            existing.index = self._index
            self._index += 1
            return
        self._tracked.append(
            _TrackedCheckpoint(checkpoint, dict(metrics), self._index))
        self._index += 1
        if self.num_to_keep is None or len(self._tracked) <= self.num_to_keep:
            return
        # evict the worst NON-latest entry (the latest stays tracked until
        # superseded, so its directory is never orphaned on disk)
        for candidate in sorted(self._tracked, key=self._rank):
            if candidate.checkpoint.path != self.latest.path:
                self._tracked.remove(candidate)
                shutil.rmtree(candidate.checkpoint.path, ignore_errors=True)
                return

    def _rank(self, t: _TrackedCheckpoint):
        if self.score_attribute and self.score_attribute in t.metrics:
            score = float(t.metrics[self.score_attribute])
            return (score, t.index) if self.score_order == "max" else (
                -score, t.index)
        return (float("-inf"), t.index)  # unscored: evict oldest first

    @property
    def best(self) -> Optional[Checkpoint]:
        if not self._tracked:
            return None
        return sorted(self._tracked, key=self._rank)[-1].checkpoint

    @property
    def best_with_metrics(self) -> list[tuple[Checkpoint, dict]]:
        return [(t.checkpoint, t.metrics)
                for t in sorted(self._tracked, key=self._rank, reverse=True)]
