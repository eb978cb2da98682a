"""Pre-allocated mutable channels for compiled DAGs.

Ref analog: python/ray/experimental/channel/ — shared_memory_channel.py
(mutable shm ring written per-tick), intra_process_channel.py. The point
of the compiled-DAG fast path is that per-tick values move through
pre-negotiated fixed buffers instead of the task-submission control plane
(ref compiled_dag_node.py:757): no task spec, no lease, no object-store
churn per call.

`ShmChannel` is a single-producer single-consumer ring over POSIX shared
memory (multiprocessing.shared_memory). Cross-process visibility relies
on the SPSC discipline: the producer writes the payload bytes first and
publishes by bumping ``write_seq`` last; the consumer reads ``write_seq``
before the payload and releases the slot by bumping ``read_seq`` last.

Memory ordering: when the `_native` lib is loadable (it is wherever the
arena store runs), every seq bump is an ``__ATOMIC_RELEASE`` store and
every seq read an ``__ATOMIC_ACQUIRE`` load
(shm_store.cpp rayt_atomic_{store_release,load_acquire}_u64 — the same
primitives the arena uses to publish its init magic), so the protocol is
correct on weakly ordered ISAs (ARM64), not just x86-TSO. Without the
native lib the channel falls back to plain struct stores, which rely on
x86-64 total store order; in CPython each store is surrounded by
interpreter bookkeeping spanning many nanoseconds and each seq has
exactly one writer, so the fallback window is practically unobservable —
but only the native path is *specified* for ARM hosts.

Capacity gives pipelining: a ring of N slots lets N ticks be in flight
between two stages before the producer blocks (GPipe-style microbatch
overlap over host edges).

Zero-copy ticks: ``write`` serializes with pickle-5 out-of-band buffers
and scatter-writes each chunk straight into the ring slot (no
intermediate ``bytes`` join); ``read`` deserializes over a memoryview of
the slot, so large numpy payloads come back as views ALIASING the ring.
The slot-pin rule makes that safe: a slot's ``read_seq`` release is
deferred until no deserialized view aliases it (weakref finalizers feed
a release deque drained from the consumer's read/close paths, the same
GC-reentrancy-safe shape as the object plane's ``_ShmGetPin``). Slots
release in ring order, so a long-held view eventually backpressures the
producer — hold at most ``n_slots - 1`` live views per ring, or copy out
(``np.array(v)``).
"""

from __future__ import annotations

import collections
import ctypes
import struct
import sys
import threading
import time
import weakref
from dataclasses import dataclass
from multiprocessing import shared_memory

from ray_tpu_torch._internal.serialization import (deserialize, serialize,
                                                   serialized_size)

_HDR = struct.Struct("<QQQQB")  # write_seq, read_seq, slot_size, n_slots, closed
_LEN = struct.Struct("<Q")      # per-slot payload length prefix
_HDR_SIZE = 64                  # one cache line; header never shares a slot

# serializes the resource_tracker monkeypatch below: without it, two
# threads opening channels concurrently can save the no-op lambda as
# `orig` and restore it last, permanently disabling tracker registration
# for every later SharedMemory user in the process
_TRACKER_PATCH_LOCK = threading.Lock()


def _open_untracked(**kwargs) -> shared_memory.SharedMemory:
    """Open a SharedMemory segment WITHOUT resource_tracker registration:
    the channel owner unlinks deterministically in close()/teardown(),
    and 3.12's unconditional registration would otherwise let an exiting
    attacher's tracker unlink a live ring (or double-unlink noise when
    several attachers share one tracker)."""
    if sys.version_info >= (3, 13):
        return shared_memory.SharedMemory(track=False, **kwargs)
    from multiprocessing import resource_tracker

    with _TRACKER_PATCH_LOCK:
        orig = resource_tracker.register
        resource_tracker.register = lambda *a, **k: None
        try:
            return shared_memory.SharedMemory(**kwargs)
        finally:
            resource_tracker.register = orig


def _atomics_lib():
    """The native release/acquire helpers, or None (pure-Python
    fallback). Import is lazy and failure-tolerant: channels must work
    in minimal environments with no toolchain."""
    try:
        from ray_tpu_torch._native import load_shm_lib

        lib = load_shm_lib()
        if lib is not None and hasattr(lib, "rayt_atomic_store_release_u64"):
            return lib
    except Exception:
        pass
    return None


class ChannelClosed(Exception):
    pass


class ChannelStats:
    """Per-channel-instance counters for the DAG-plane observability
    pipeline (producer and consumer symmetric: these feed the `dag_state`
    pubsub reports and the `rayt_dag_*` Prometheus family).

    Hot-path cost is a couple of attribute increments per tick; the
    block-time fields are only touched when a read/write actually
    parks. Read concurrently by the per-process reporter thread —
    plain int/float attribute reads, no lock needed (GIL-consistent,
    and a torn read is at worst one tick stale)."""

    __slots__ = ("writes", "reads", "bytes_written", "bytes_read",
                 "write_block_s", "read_block_s", "pins_sealed",
                 "gc_nudges", "write_blocked_since", "read_blocked_since")

    def __init__(self):
        self.writes = 0
        self.reads = 0
        self.bytes_written = 0
        self.bytes_read = 0
        self.write_block_s = 0.0     # cumulative seconds parked on full
        self.read_block_s = 0.0      # cumulative seconds parked on empty
        self.pins_sealed = 0         # reads whose views aliased the slot
        self.gc_nudges = 0           # collector kicks for cycle-trapped views
        # monotonic timestamps while CURRENTLY parked (None otherwise);
        # the reporter turns these into live blocked-durations so the
        # stall watchdog sees a block that never returns
        self.write_blocked_since: float | None = None
        self.read_blocked_since: float | None = None

    def end_write_block(self):
        if self.write_blocked_since is not None:
            self.write_block_s += time.monotonic() - self.write_blocked_since
            self.write_blocked_since = None

    def end_read_block(self):
        if self.read_blocked_since is not None:
            self.read_block_s += time.monotonic() - self.read_blocked_since
            self.read_blocked_since = None

    def blocked_now(self) -> tuple[float, float]:
        """(write_blocked_s, read_blocked_s) of any IN-PROGRESS park."""
        now = time.monotonic()
        wb = self.write_blocked_since
        rb = self.read_blocked_since
        return (now - wb if wb is not None else 0.0,
                now - rb if rb is not None else 0.0)

    def snapshot(self) -> dict:
        wb_now, rb_now = self.blocked_now()
        return {
            "writes": self.writes, "reads": self.reads,
            "bytes_written": self.bytes_written,
            "bytes_read": self.bytes_read,
            "write_block_s": self.write_block_s + wb_now,
            "read_block_s": self.read_block_s + rb_now,
            "pins_sealed": self.pins_sealed,
            "gc_nudges": self.gc_nudges,
            "write_blocked_s_now": wb_now,
            "read_blocked_s_now": rb_now,
        }


class _SlotPin:
    """Tracks the deserialized out-of-band views aliasing ONE ring slot.

    Same reentrancy discipline as the object plane's ``_ShmGetPin``
    (core_worker.py): wrapper finalizers only ever append to the
    consumer's release deque — every read_seq mutation happens on the
    consumer's read path, which drains the deque. Wrappers are held by
    strong refs until ``seal()`` arms their finalizers, so no release
    event can fire before the pin's count is final."""

    __slots__ = ("seq", "_events", "_wrappers", "_count")

    def __init__(self, seq: int, events: collections.deque):
        self.seq = seq
        self._events = events
        self._wrappers: list = []
        self._count = 0

    def wrap(self, view: memoryview):
        """buffer_wrapper for deserialize(): interpose a weakref-able
        read-only holder between pickle and the raw slot view."""
        import numpy as np

        w = np.frombuffer(view.toreadonly(), dtype=np.uint8)
        self._wrappers.append(w)  # strong ref: finalizer armed at seal()
        return w

    def seal(self) -> bool:
        """Arm the finalizers. True => nothing aliases the slot: the
        caller releases its read_seq immediately."""
        wrappers, self._wrappers = self._wrappers, []
        if not wrappers:
            return True
        self._count = len(wrappers)
        for w in wrappers:
            weakref.finalize(w, self._events.append, self)
        return False

    def dec(self) -> bool:
        """One view died (drained on the consumer thread). True => last
        view: release the slot."""
        self._count -= 1
        return self._count == 0


@dataclass(frozen=True)
class ChannelSpec:
    """Serializable descriptor shipped to actors inside the DAG schedule."""
    name: str
    slot_size: int
    n_slots: int


class ShmChannel:
    """SPSC mutable ring channel. One side calls create(), the schedule
    carries the ChannelSpec, the other side attach()es."""

    def __init__(self, shm: shared_memory.SharedMemory, spec: ChannelSpec,
                 owner: bool):
        self._shm = shm
        self.spec = spec
        self._owner = owner
        self._buf = shm.buf
        self._closed_locally = False
        self._atomics = _atomics_lib()
        self._base_addr = 0
        if self._atomics is not None:
            # raw mapping address for the seq words; keep only the int so
            # no exported pointer blocks shm.close() later
            anchor = ctypes.c_char.from_buffer(shm.buf)
            self._base_addr = ctypes.addressof(anchor)
            del anchor
        # consumer-side zero-copy state: the local read cursor may run
        # ahead of the PUBLISHED read_seq, which lags at the oldest slot
        # still aliased by a live deserialized view (slot-pin rule)
        _, r, _ = self._seqs()
        self._cursor = r          # next seq this consumer will read
        self._read_pub = r        # last published read_seq
        self._unreleased: set[int] = set()   # read but still pinned
        self._pin_events: collections.deque = collections.deque()
        self.stats = ChannelStats()

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def create(cls, slot_size: int = 1 << 20, n_slots: int = 8,
               name: str | None = None) -> "ShmChannel":
        size = _HDR_SIZE + n_slots * (_LEN.size + slot_size)
        shm = _open_untracked(create=True, size=size, name=name)
        _HDR.pack_into(shm.buf, 0, 0, 0, slot_size, n_slots, 0)
        spec = ChannelSpec(shm.name, slot_size, n_slots)
        return cls(shm, spec, owner=True)

    @classmethod
    def attach(cls, spec: ChannelSpec) -> "ShmChannel":
        shm = _open_untracked(name=spec.name)
        return cls(shm, spec, owner=False)

    def close(self):
        if self._closed_locally:
            return  # idempotent: a ring is closed exactly once per holder
        self._closed_locally = True
        try:
            self._mark_closed()
        except Exception:
            pass
        # drop the native-atomics path FIRST: after shm.close() the
        # mapping is gone and a raw load/store on _base_addr would
        # SIGSEGV, where the struct-on-_buf path raises catchably
        self._atomics = None
        self._base_addr = 0
        try:
            self._buf = None
            self._shm.close()
        except BufferError:
            # live deserialized views still alias the ring (slot-pin
            # rule): the mapping stays until they die. Neutralize this
            # instance's close so __del__ doesn't spew 'Exception
            # ignored ... BufferError' — the map dies with the views or
            # the process (same idiom as the object store's zombies).
            self._shm.close = lambda: None  # type: ignore[method-assign]
        except Exception:
            pass
        if self._owner:
            try:
                self._shm.unlink()
            except Exception:
                pass

    # -------------------------------------------------------------- protocol
    def _seqs(self) -> tuple[int, int, bool]:
        if self._atomics is not None:
            # acquire loads: everything the publisher wrote before its
            # release store (the payload) is visible after these
            w = self._atomics.rayt_atomic_load_acquire_u64(
                ctypes.c_void_p(self._base_addr))
            r = self._atomics.rayt_atomic_load_acquire_u64(
                ctypes.c_void_p(self._base_addr + 8))
            (closed,) = struct.unpack_from("<B", self._buf, 32)
            return w, r, bool(closed)
        w, r, _, _, closed = _HDR.unpack_from(self._buf, 0)
        return w, r, bool(closed)

    def _set_write_seq(self, w: int):
        if self._atomics is not None:
            self._atomics.rayt_atomic_store_release_u64(
                ctypes.c_void_p(self._base_addr), w)
            return
        struct.pack_into("<Q", self._buf, 0, w)

    def _set_read_seq(self, r: int):
        if self._atomics is not None:
            self._atomics.rayt_atomic_store_release_u64(
                ctypes.c_void_p(self._base_addr + 8), r)
            return
        struct.pack_into("<Q", self._buf, 8, r)

    def _mark_closed(self):
        if self._buf is not None:
            struct.pack_into("<B", self._buf, 32, 1)

    def _slot_off(self, seq: int) -> int:
        i = seq % self.spec.n_slots
        return _HDR_SIZE + i * (_LEN.size + self.spec.slot_size)

    # -------------------------------------------------------- observability
    def occupancy(self) -> int:
        """Items published but not yet released (ring fill level).
        Counts slots still pinned by live views — from the producer's
        point of view they ARE occupied."""
        if self._closed_locally:
            return 0  # never touch the (possibly unmapped) ring
        try:
            w, r, _ = self._seqs()
            return max(0, w - r)
        except Exception:
            return 0  # closed mapping mid-snapshot

    def pinned_slots(self) -> int:
        """Slots this consumer read whose views still alias the ring."""
        return max(0, self._cursor - self._read_pub)

    def cursor_state(self) -> tuple[int, int]:
        """(reads consumed locally, items published by the producer) —
        the per-output-channel positions the _get_tick timeout error
        reports so mid-wave desync is diagnosable from the exception."""
        if self._closed_locally:
            return self._cursor, -1
        try:
            w, _, _ = self._seqs()
        except Exception:
            w = -1
        return self._cursor, w

    def snapshot(self) -> dict:
        snap = self.stats.snapshot()
        snap["occupancy"] = self.occupancy()
        snap["pinned_slots"] = self.pinned_slots()
        snap["n_slots"] = self.spec.n_slots
        return snap

    def write_bytes(self, payload: bytes, timeout: float | None = None):
        if len(payload) > self.spec.slot_size:
            # non-retryable (unlike a transiently-full ring, which blocks)
            raise ValueError(
                f"item of {len(payload)} bytes exceeds the channel slot "
                f"size {self.spec.slot_size}; recompile the DAG with a "
                f"larger buffer_size_bytes")
        w = self._wait_writable(timeout)
        off = self._slot_off(w)
        _LEN.pack_into(self._buf, off, len(payload))
        self._buf[off + _LEN.size:off + _LEN.size + len(payload)] = payload
        self._set_write_seq(w + 1)  # publish LAST
        self.stats.writes += 1
        self.stats.bytes_written += len(payload)

    def read_bytes(self, timeout: float | None = None) -> bytearray:
        """Copy read: materializes the slot payload into a bytearray the
        caller owns (arrays deserialized over it are writable, as tensors
        built on them must be) and releases the slot immediately (shares
        the consumer cursor with read())."""
        deadline = None if timeout is None else time.monotonic() + timeout
        pause = 0.0
        st = self.stats
        while True:
            self._drain_pin_events()
            w, _, closed = self._seqs()
            if w > self._cursor:
                st.end_read_block()
                break
            if closed:
                st.end_read_block()
                raise ChannelClosed()
            if st.read_blocked_since is None:
                st.read_blocked_since = time.monotonic()
            if deadline is not None and time.monotonic() > deadline:
                st.end_read_block()
                raise TimeoutError("channel read timed out (ring empty)")
            time.sleep(pause)
            pause = min(0.001, pause + 0.00005)
        off = self._slot_off(self._cursor)
        (length,) = _LEN.unpack_from(self._buf, off)
        payload = bytearray(
            self._buf[off + _LEN.size:off + _LEN.size + length])
        seq, self._cursor = self._cursor, self._cursor + 1
        self._release_seq(seq)
        st.reads += 1
        st.bytes_read += length
        return payload

    # ----------------------------------------------------------- object api
    # write()/read() are the zero-copy tick path: pickle-5 chunks scatter
    # straight into the slot, reads deserialize over a slot view under
    # the slot-pin rule. write_bytes()/read_bytes() above remain the raw
    # copy path (also the bench baseline the zero-copy numbers gate
    # against).

    def write(self, value, timeout: float | None = None):
        self.write_chunks(serialize(value), timeout=timeout)

    def write_chunks(self, chunks: list, total: int | None = None,
                     timeout: float | None = None):
        """Scatter-write a serialize() chunk list into the next slot: one
        memcpy per chunk into shared memory, no intermediate join."""
        if total is None:
            total = serialized_size(chunks)
        if total > self.spec.slot_size:
            # non-retryable (unlike a transiently-full ring, which blocks)
            raise ValueError(
                f"item of {total} bytes exceeds the channel slot size "
                f"{self.spec.slot_size}; recompile the DAG with a larger "
                f"buffer_size_bytes")
        w = self._wait_writable(timeout)
        off = self._slot_off(w)
        _LEN.pack_into(self._buf, off, total)
        pos = off + _LEN.size
        for c in chunks:
            n = len(c) if isinstance(c, bytes) else c.nbytes
            self._buf[pos:pos + n] = c
            pos += n
        self._set_write_seq(w + 1)  # publish LAST
        self.stats.writes += 1
        self.stats.bytes_written += total

    def read(self, timeout: float | None = None):
        """Zero-copy read: deserializes over a memoryview of the slot.
        Out-of-band buffers (numpy payloads) alias the ring; the slot is
        not reused while any such view is alive (slot-pin rule)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        pause = 0.0
        gc_nudge = time.monotonic() + 0.05
        st = self.stats
        while True:
            self._drain_pin_events()
            w, _, closed = self._seqs()
            if w > self._cursor:
                st.end_read_block()
                break
            if closed:
                st.end_read_block()
                raise ChannelClosed()
            if st.read_blocked_since is None:
                st.read_blocked_since = time.monotonic()
            if deadline is not None and time.monotonic() > deadline:
                st.end_read_block()
                raise TimeoutError("channel read timed out (ring empty)")
            if self._read_pub < self._cursor and not self._pin_events \
                    and time.monotonic() > gc_nudge:
                # Unpublished slots + an empty ring can mean the producer
                # is parked on OUR unreleased slots, while the views that
                # pin them sit in a reference CYCLE (observed: a jitted
                # learner's first trace) that only the cyclic collector
                # will break — and this quiet spin allocates too little
                # to ever trigger it. Nudge the collector so finalizers
                # fire and the ring drains itself.
                import gc

                gc.collect()
                st.gc_nudges += 1
                gc_nudge = time.monotonic() + 0.5
            time.sleep(pause)
            pause = min(0.001, pause + 0.00005)
        off = self._slot_off(self._cursor)
        (length,) = _LEN.unpack_from(self._buf, off)
        payload = self._buf[off + _LEN.size:off + _LEN.size + length]
        pin = _SlotPin(self._cursor, self._pin_events)
        self._cursor += 1
        try:
            value = deserialize(payload, buffer_wrapper=pin.wrap)
        except Exception:
            self._release_seq(pin.seq)
            raise
        if pin.seal():
            self._release_seq(pin.seq)
        else:
            st.pins_sealed += 1
        # on the pinned branch the slot releases via the pin's finalizer
        # events ONLY — it must NOT enter _unreleased yet, or an earlier
        # slot's release walk would publish read_seq past this
        # still-pinned slot and the producer would overwrite memory a
        # live view aliases
        st.reads += 1
        st.bytes_read += length
        return value

    # ------------------------------------------------------- slot pinning
    def _wait_writable(self, timeout: float | None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        pause = 0.0
        st = self.stats
        while True:
            w, r, closed = self._seqs()
            if closed:
                st.end_write_block()
                raise ChannelClosed()
            if w - r < self.spec.n_slots:
                st.end_write_block()
                return w
            if st.write_blocked_since is None:
                st.write_blocked_since = time.monotonic()
            if deadline is not None and time.monotonic() > deadline:
                st.end_write_block()
                raise TimeoutError("channel write timed out (ring full)")
            time.sleep(pause)
            pause = min(0.001, pause + 0.00005)

    def _release_seq(self, seq: int):
        """Mark one read slot RELEASABLE (its views are all dead);
        publish read_seq up to the first still-pinned slot (in ring
        order — the producer's free-slot math needs a contiguous
        prefix). ``_unreleased`` holds only releasable slots parked
        behind a pinned predecessor — never still-pinned ones."""
        self._unreleased.add(seq)
        if seq != self._read_pub:
            return
        pub = self._read_pub
        while pub in self._unreleased:
            self._unreleased.discard(pub)
            pub += 1
        self._read_pub = pub
        if self._buf is not None:
            self._set_read_seq(pub)

    def _drain_pin_events(self):
        """Apply view-death events queued by wrapper finalizers. Runs only
        on the consumer's read path (single consumer), so no lock."""
        events = self._pin_events
        while events:
            pin = events.popleft()
            if pin.dec():
                self._release_seq(pin.seq)
