"""Device-resident channels for compiled DAGs — the third per-edge kind.

Ref analog: python/ray/experimental/channel/torch_tensor_nccl_channel.py
(compiled-graph GPU channels: tensors move producer→consumer without a
host pickle bounce). The split (core/device_objects.py):

* **Same-process** producer/consumer (``DeviceChannel``): a tick hands
  the tensor OBJECT over — no serialize, no copy, no host staging (the
  consumer reads the very tensor written: same object, same
  ``data_ptr()``). Writing transfers ownership (the donation contract
  below), so the consumer may update the value in place.
* **Cross-process** edges (``DeviceTransportChannel``): the payload
  rides the EXISTING shm-ring / DCN framing, but tensor leaves are
  re-framed as raw host bytes + dtype/shape metadata
  (``pack_device_tree``): one host view of the tensor (a CUDA tensor is
  copied to host memory once, a CPU tensor viewed in place; bf16 rides as
  its uint16 bits — ``device_objects.host_shard_view``) travels as a
  pickle-5 OUT-OF-BAND buffer, scatter-written into the ring slot — the
  pickle stream itself never contains the tensor's storage. The consumer
  rebuilds the tensor on its own device (the CUDA card when it has one)
  DURING deserialize, so the value is resident there the moment ``read``
  returns.

Donation contract: a tensor written to a device edge is RELINQUISHED by
the producer — it must not read or mutate it afterwards. The
same-process handoff relies on it (no copy is made), and it is what
makes it legal for the consumer to update an edge-supplied tensor in
place (``donating_jit`` keeps the reference's helper and records the
donation vector derived from the edge arity; torch has no buffer
donation). Holding a read value ACROSS ticks:

* same process: safe — ownership transferred with the object;
* cross-process: the read copies the slot out before rebuilding, so the
  rebuilt tensor never aliases the ring; it may alias that private copy
  on the CPU. Clone anything held for many ticks that a later tick's
  producer could race with — the same copy-on-hold discipline as host
  edges.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass
from typing import Any

from ray_tpu_torch.core.device_objects import is_device_value
from ray_tpu_torch.dag.channel import ChannelClosed, ChannelStats


@dataclass(frozen=True)
class DeviceChannelSpec:
    """Serializable descriptor for a device edge. ``name`` is the stable
    wire identity (the inner channel's, so both ends' dag-state reports
    coalesce onto one edge); ``inner`` is the transport spec (shm ring
    or DCN endpoint) — None marks a same-process-only channel resolved
    through the in-process registry."""
    name: str
    inner: Any = None


# ------------------------------------------------- device payload framing

class _DeviceLeaf:
    """One tensor leaf crossing a device edge. ``__reduce__`` emits raw
    host bytes + metadata — never a pickle of the tensor: the host view
    goes OUT OF BAND (pickle-5 buffer, scatter-written by the transport),
    only dtype/shape enter the stream, and unpickling runs
    ``device_objects.rebuild_tensor`` INSIDE the consumer's deserialize,
    landing the value on the consumer's device."""

    __slots__ = ("arr",)

    def __init__(self, arr):
        self.arr = arr

    def __reduce__(self):
        from ray_tpu_torch.core.device_objects import (dtype_name,
                                                       host_shard_view,
                                                       rebuild_tensor)

        np_val = host_shard_view(self.arr)
        return (rebuild_tensor, (np_val, dtype_name(self.arr),
                                 tuple(self.arr.shape)))


def pack_device_tree(value) -> tuple[Any, int]:
    """Replace every tensor leaf of a dict/list/tuple pytree with a
    ``_DeviceLeaf`` so serialization ships raw host bytes instead of a
    pickle of the tensor. Returns ``(packed, n_arrays)`` —
    ``n_arrays == 0`` means the payload had no device leaves and the
    packed value is the original. Pre-wrapped ``_DeviceLeaf`` values
    (``wrap_host_arrays``) count as packed. The walk covers the
    containers DAG payloads are built from; a tensor nested inside an
    opaque object would fall back to its own (host-copy) reducer."""
    n = 0

    def walk(v):
        nonlocal n
        if isinstance(v, _DeviceLeaf):
            n += 1
            return v
        if is_device_value(v):
            n += 1
            return _DeviceLeaf(v)
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(walk(x) for x in v)
        return v

    packed = walk(value)
    return (packed if n else value), n


def wrap_host_arrays(tree) -> tuple[Any, int]:
    """Mark a HOST numpy pytree for the device framing without staging
    it onto the producer's devices first: each np.ndarray leaf becomes
    a ``_DeviceLeaf`` (its bytes already live on host — shipping pays
    zero extra copies) and the consumer's read rebuilds it as a tensor on
    ITS device. This is the weight-broadcast producer path for drivers
    that hold host weights: moving them to the card and packing would do
    a wasted H2D+D2H round trip of every leaf per broadcast."""
    import numpy as np

    n = 0

    def walk(v):
        nonlocal n
        if isinstance(v, np.ndarray):
            n += 1
            return _DeviceLeaf(v)
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(walk(x) for x in v)
        return v

    wrapped = walk(tree)
    return (wrapped if n else tree), n


def tree_nbytes(value) -> int:
    """Raw array bytes in a payload (tensor + numpy leaves) — the
    same-process channel's bytes accounting."""
    if isinstance(value, dict):
        return sum(tree_nbytes(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(tree_nbytes(v) for v in value)
    return int(getattr(value, "nbytes", 0) or 0)


def count_device_leaves(value) -> int:
    """Tensor leaves in a payload (same-process stats accounting)."""
    if isinstance(value, dict):
        return sum(count_device_leaves(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(count_device_leaves(v) for v in value)
    return 1 if is_device_value(value) else 0


# ------------------------------------------------------- donation helpers

def donation_argnums_for(n_edge_args: int, offset: int = 0) -> tuple:
    """Donation vector derived from edge arity: the consumer's compute
    takes its device-edge inputs as ``offset..offset+n-1`` and may donate
    (update in place) exactly those (the producer relinquished them on
    write)."""
    return tuple(range(offset, offset + n_edge_args))


def donating_jit(fn, n_edge_args: int, offset: int = 0,
                 extra_donate: tuple = ()):
    """The reference's ``jax.jit`` with a donation vector, kept by name
    and signature: the vector is derived from the edge arity (plus any
    explicitly-owned extra args, e.g. an optimizer state that never leaves
    the process) and recorded as ``donate_argnums`` on the returned
    callable, which calls `fn` unchanged. Torch has no buffer donation
    and eager code needs no trace, so nothing is compiled; the vector
    names the arguments `fn` may update in place."""
    import functools

    donate = tuple(sorted(set(donation_argnums_for(n_edge_args, offset))
                          | set(extra_donate)))

    @functools.wraps(fn)
    def donating(*args, **kwargs):
        return fn(*args, **kwargs)

    donating.donate_argnums = donate
    return donating


# -------------------------------------------- same process (one handoff)

_local_lock = threading.Lock()
_local_handoffs: dict[str, "_LocalHandoff"] = {}


class _LocalHandoff:
    """The shared state behind a same-process channel: a bounded SPSC
    deque of tensor payloads (objects, not bytes)."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.items: deque = deque()
        self.cv = threading.Condition()
        self.closed = False


class DeviceChannel:
    """Same-process device channel: producer and consumer share one
    process, so a tick hands the tensor OBJECT over — no serialize, no
    deserialize, no copy on the hot path. Ownership transfers with the
    write (donation contract), which is what lets the consumer update the
    value in place. SPSC by usage, same as the shm ring."""

    is_device = True

    def __init__(self, handoff: _LocalHandoff, spec: DeviceChannelSpec):
        self._handoff = handoff
        self.spec = spec
        self._closed_locally = False
        self.stats = ChannelStats()
        self.device_arrays = 0

    @classmethod
    def create(cls, n_slots: int = 8,
               name: str | None = None) -> "DeviceChannel":
        token = name or f"devchan-{uuid.uuid4().hex[:16]}"
        handoff = _LocalHandoff(max(2, n_slots))
        with _local_lock:
            _local_handoffs[token] = handoff
        return cls(handoff, DeviceChannelSpec(name=token, inner=None))

    # ------------------------------------------------------------ protocol
    def write(self, value, timeout: float | None = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        h = self._handoff
        st = self.stats
        with h.cv:
            while len(h.items) >= h.n_slots:
                if h.closed:
                    st.end_write_block()
                    raise ChannelClosed()
                if st.write_blocked_since is None:
                    st.write_blocked_since = time.monotonic()
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    st.end_write_block()
                    raise TimeoutError(
                        "device channel write timed out (handoff full)")
                h.cv.wait(timeout=(remaining if remaining is not None
                                   else 1.0))
            if h.closed:
                st.end_write_block()
                raise ChannelClosed()
            st.end_write_block()
            h.items.append(value)
            h.cv.notify_all()
        st.writes += 1
        st.bytes_written += tree_nbytes(value)
        self.device_arrays += count_device_leaves(value)

    def read(self, timeout: float | None = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        h = self._handoff
        st = self.stats
        with h.cv:
            while not h.items:
                if h.closed:
                    st.end_read_block()
                    raise ChannelClosed()
                if st.read_blocked_since is None:
                    st.read_blocked_since = time.monotonic()
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    st.end_read_block()
                    raise TimeoutError(
                        "device channel read timed out (handoff empty)")
                h.cv.wait(timeout=(remaining if remaining is not None
                                   else 1.0))
            st.end_read_block()
            value = h.items.popleft()
            h.cv.notify_all()
        st.reads += 1
        st.bytes_read += tree_nbytes(value)
        return value

    # ------------------------------------------------------ observability
    def occupancy(self) -> int:
        return len(self._handoff.items)

    def cursor_state(self) -> tuple[int, int]:
        st = self.stats
        return st.reads, st.reads + len(self._handoff.items)

    def snapshot(self) -> dict:
        snap = self.stats.snapshot()
        snap["occupancy"] = self.occupancy()
        snap["pinned_slots"] = 0
        snap["n_slots"] = self._handoff.n_slots
        snap["device_arrays"] = self.device_arrays
        return snap

    def close(self):
        if self._closed_locally:
            return  # idempotent: closed exactly once per holder
        self._closed_locally = True
        with _local_lock:
            if _local_handoffs.get(self.spec.name) is self._handoff:
                _local_handoffs.pop(self.spec.name, None)
        h = self._handoff
        with h.cv:
            h.closed = True
            h.cv.notify_all()


# --------------------------------------------- cross-process transport

class DeviceTransportChannel:
    """Device edge over an existing host transport (shm ring or DCN
    channel): values are re-framed by ``pack_device_tree`` on write so
    tensor leaves ride as raw host bytes, and rebuilt on the consumer's
    device during the inner channel's deserialize. All flow
    control, blocking, close and stats semantics are the inner
    channel's — this wrapper only swaps the payload framing."""

    is_device = True

    def __init__(self, inner, spec: DeviceChannelSpec | None = None):
        self._inner = inner
        inner_spec = inner.spec
        self.spec = spec or DeviceChannelSpec(
            name=(getattr(inner_spec, "name", None)
                  or getattr(inner_spec, "token", "")),
            inner=inner_spec)
        self.device_arrays = 0   # producer-side packed leaf count
        self._closed_locally = False

    # ------------------------------------------------------------ protocol
    def write(self, value, timeout: float | None = None):
        # the actor loop hands us the (possibly epoch- and/or
        # trace-enveloped) tick payload; pack the value inside so the
        # envelopes stay intact (_EpochTick outermost, then _TraceTick)
        from ray_tpu_torch.dag.channel_exec import _EpochTick, _TraceTick

        epoch = None
        if type(value) is _EpochTick:
            epoch, value = value.epoch, value.value
        if type(value) is _TraceTick:
            packed, n = pack_device_tree(value.value)
            if n:
                value = _TraceTick(value.carrier, value.tick, packed)
        else:
            value, n = pack_device_tree(value)
        if epoch is not None:
            value = _EpochTick(epoch, value)
        self.device_arrays += n
        self._inner.write(value, timeout=timeout)

    def write_chunks(self, chunks: list, total: int | None = None,
                     timeout: float | None = None):
        """Pre-packed broadcast path (the driver serializes a packed
        payload ONCE and scatters it; it accounts device_arrays via
        add_device_arrays)."""
        self._inner.write_chunks(chunks, total, timeout=timeout)

    def add_device_arrays(self, n: int):
        self.device_arrays += n

    def read(self, timeout: float | None = None):
        # Shm ring inner: COPY the slot payload out (read_bytes — the
        # slot releases deterministically) into a private writable buffer
        # and rebuild over it. The zero-copy slot view is deliberately
        # NOT used here: a CPU tensor built over it would alias the ring
        # (pinning the slot for as long as the tensor lives, and handing
        # the consumer a tensor the producer's next tick overwrites), and
        # a copy to the card is only safe from memory that no later tick
        # reuses. DCN inners already deserialize over a private receive
        # buffer, so they keep their native read.
        if hasattr(self._inner, "read_bytes"):
            from ray_tpu_torch._internal.serialization import deserialize

            return deserialize(self._inner.read_bytes(timeout=timeout))
        return self._inner.read(timeout=timeout)

    # ------------------------------------------------------ observability
    @property
    def stats(self) -> ChannelStats:
        return self._inner.stats

    def occupancy(self) -> int:
        return self._inner.occupancy()

    def cursor_state(self) -> tuple[int, int]:
        return self._inner.cursor_state()

    def snapshot(self) -> dict:
        snap = self._inner.snapshot()
        snap["device_arrays"] = self.device_arrays
        return snap

    def close(self):
        if self._closed_locally:
            return
        self._closed_locally = True
        self._inner.close()


def attach_device(spec: DeviceChannelSpec):
    """Attach a device channel from its spec: the process holding the
    same-process handoff gets the direct side; everyone else attaches
    the inner transport and gets the raw-bytes framing."""
    with _local_lock:
        handoff = _local_handoffs.get(spec.name)
    if handoff is not None:
        return DeviceChannel(handoff, spec)
    if spec.inner is None:
        raise ChannelClosed(
            f"same-process device channel {spec.name!r} is not registered "
            "in this process and has no transport spec")
    from ray_tpu_torch.dag.dcn_channel import attach_channel

    return DeviceTransportChannel(attach_channel(spec.inner), spec)
