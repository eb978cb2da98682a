"""Object storage: per-process memory store + per-node shared-memory store.

Ref analogs:
 * MemoryStore — src/ray/core_worker/store_provider/memory_store/
   memory_store.h:42 (small objects live in the owner process; waiters are
   async futures).
 * ShmObjectStore — the plasma store
   (src/ray/object_manager/plasma/store.h:55) redesigned host-side: every
   sealed object is one named POSIX shm segment (mmap'd by any process on
   the node, zero-copy reads via pickle-5 buffer views). The directory +
   pinning + eviction live in the node manager; this class is the
   per-process mapping cache. A C++ arena allocator can replace the
   per-object segments without changing this interface.

Device arrays (jax.Array) do NOT pass through here — they stay in HBM and
move over ICI via the mesh/collective layer. This store is for host objects.
"""

from __future__ import annotations

import asyncio
import os
import threading
from multiprocessing import shared_memory, resource_tracker
from typing import Any

from ray_tpu_torch._internal.ids import ObjectID
from ray_tpu_torch._internal.serialization import deserialize, serialize, serialized_size

_logger = None


def _log():
    # lazy: setup_logger pulls config; this module is imported by every
    # process before config is necessarily finalized
    global _logger
    if _logger is None:
        from ray_tpu_torch._internal.logging_utils import setup_logger

        _logger = setup_logger("object_store")
    return _logger


class _StoredObject:
    __slots__ = ("value", "is_exception")

    def __init__(self, value: Any, is_exception: bool = False):
        self.value = value
        self.is_exception = is_exception


class MemoryStore:
    """In-process store for small objects owned by this worker."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self._objects: dict[ObjectID, _StoredObject] = {}
        self._waiters: dict[ObjectID, list[asyncio.Future]] = {}

    def put(self, object_id: ObjectID, value: Any, is_exception: bool = False):
        obj = _StoredObject(value, is_exception)
        self._objects[object_id] = obj
        # no registered async waiter (the common case: getters are on
        # the sync fast lane or haven't arrived): skip the loop wake —
        # an off-loop put otherwise costs a self-pipe write + a loop
        # iteration PER completion. Safe against the register race:
        # wait_for re-checks the store AFTER appending its future.
        if object_id not in self._waiters:
            return

        def _wake():
            for fut in self._waiters.pop(object_id, []):
                if not fut.done():
                    fut.set_result(obj)
        # loop-affine fast path: puts from the completion path run on the
        # store's loop — waking inline skips a self-pipe write + handle
        if asyncio._get_running_loop() is self._loop:
            _wake()
        else:
            self._loop.call_soon_threadsafe(_wake)

    def contains(self, object_id: ObjectID) -> bool:
        return object_id in self._objects

    def get_if_exists(self, object_id: ObjectID) -> _StoredObject | None:
        return self._objects.get(object_id)

    async def wait_for(self, object_id: ObjectID) -> _StoredObject:
        obj = self._objects.get(object_id)
        if obj is not None:
            return obj
        fut = self._loop.create_future()
        self._waiters.setdefault(object_id, []).append(fut)
        # re-check: an off-loop put between the first check and the
        # append saw no waiter and skipped its wake
        obj = self._objects.get(object_id)
        if obj is not None:
            for fut in self._waiters.pop(object_id, []):
                if not fut.done():
                    fut.set_result(obj)
            return obj
        return await fut

    def delete(self, object_id: ObjectID):
        self._objects.pop(object_id, None)

    def __len__(self):
        return len(self._objects)


def _shm_name(object_id: ObjectID) -> str:
    # FULL hex (53 chars incl. prefix, well under shm NAME_MAX): return
    # ids of one task differ only in the trailing index suffix, so any
    # truncation collapses every return/stream item of a task onto ONE
    # segment (duplicate-create dedup then silently serves item 0's
    # payload for item N)
    return "rayt_" + object_id.hex()


def _unregister_tracker(shm: shared_memory.SharedMemory):
    # The resource tracker would unlink segments when *any* process exits;
    # lifetime is owned by the node manager instead (like plasma).
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # type: ignore[attr-defined]
    except Exception:
        pass


class ShmObjectStore:
    """Create/open node-local shared-memory objects by ObjectID."""

    def __init__(self):
        self._open: dict[ObjectID, shared_memory.SharedMemory] = {}
        # objects allocated but still being written (streamed pulls,
        # restores): hidden from contains_locally until seal
        self._unsealed: set[ObjectID] = set()
        # unlinked/released segments whose mappings are still pinned by
        # live zero-copy views: kept referenced (not in the cache) so the
        # mapping survives until the views die, then swept closed
        self._zombies: list[shared_memory.SharedMemory] = []
        # guards the _open cache: pin-driven release() now runs from
        # other threads concurrently with get_view/_mapping. RLock — a
        # GC firing ObjectRef.__del__ can re-enter the release path on
        # the same thread mid-critical-section
        self._map_lock = threading.RLock()
        # zombie lifecycle accounting for the observability layer:
        # parked = close() refused by live views, swept = later reclaimed
        self._zombies_parked = 0
        self._zombies_swept = 0

    def create_and_seal(self, object_id: ObjectID, value: Any) -> int:
        chunks = serialize(value)
        size = serialized_size(chunks)
        shm = shared_memory.SharedMemory(
            name=_shm_name(object_id), create=True, size=max(size, 1))
        _unregister_tracker(shm)
        off = 0
        buf = shm.buf
        for c in chunks:
            n = len(c) if isinstance(c, bytes) else c.nbytes
            buf[off:off + n] = bytes(c) if isinstance(c, bytes) else c
            off += n
        with self._map_lock:
            self._open[object_id] = shm
        return size

    def create_from_bytes(self, object_id: ObjectID, data: bytes,
                          hold: bool = False) -> int:
        """Seal a pre-serialized payload (used by node-to-node transfer).
        `hold` is a no-op here: per-object segments are never evicted.
        Duplicate creates (concurrent restores of the same object) keep
        the existing segment, matching the native arena's rc==-1."""
        return self.create_from_chunks(object_id, [data], len(data),
                                       hold=hold)

    def create_from_chunks(self, object_id: ObjectID, chunks, size: int,
                           hold: bool = False) -> int:
        if not self.create_unsealed(object_id, size):
            return size
        off = 0
        for c in chunks:
            n = len(c)
            self.write_at(object_id, off, c)
            off += n
        self.seal(object_id)
        return size

    # --------------------------------------------------- streaming creates
    @staticmethod
    def _unsealed_marker(object_id: ObjectID) -> str:
        # cross-process visibility: the native arena keeps kCreating state
        # in the shared header; this fallback store marks in-progress
        # writes with a sibling file so OTHER processes' contains_locally
        # can't attach a half-written segment by name
        return f"/dev/shm/{_shm_name(object_id)}.unsealed"

    def create_unsealed(self, object_id: ObjectID, size: int) -> bool:
        """Allocate an object to be filled by write_at + seal. False if
        the object already exists (created or being created elsewhere).

        The marker file is the CREATION LOCK (O_EXCL, written before the
        segment exists) so no other process can attach a half-written
        segment; it carries the writer pid so a crashed writer's stale
        marker is detected and cleaned instead of hiding the id forever.
        """
        marker = self._unsealed_marker(object_id)
        try:
            with open(marker, "x") as f:
                f.write(str(os.getpid()))
        except FileExistsError:
            return False  # another creator owns it (or stale: see below)
        try:
            shm = shared_memory.SharedMemory(
                name=_shm_name(object_id), create=True, size=max(size, 1))
        except FileExistsError:
            # sealed object already existed: our marker must not hide it
            try:
                os.remove(marker)
            except OSError:
                pass
            return False
        _unregister_tracker(shm)
        self._unsealed.add(object_id)
        with self._map_lock:
            self._open[object_id] = shm
        return True

    @staticmethod
    def _marker_stale(marker: str) -> bool:
        """True when the writer recorded in the marker is dead."""
        try:
            with open(marker) as f:
                pid = int(f.read().strip() or "0")
        except (OSError, ValueError):
            return False
        if pid <= 0:
            return True
        try:
            os.kill(pid, 0)
            return False
        except ProcessLookupError:
            return True
        except OSError:
            return False

    def write_at(self, object_id: ObjectID, offset: int, data):
        with self._map_lock:
            shm = self._open[object_id]
        n = len(data)
        shm.buf[offset:offset + n] = data

    def seal(self, object_id: ObjectID, hold: bool = False):
        self._unsealed.discard(object_id)
        try:
            os.remove(self._unsealed_marker(object_id))
        except OSError:
            pass

    def abort_unsealed(self, object_id: ObjectID):
        self._unsealed.discard(object_id)
        try:
            os.remove(self._unsealed_marker(object_id))
        except OSError:
            pass
        with self._map_lock:
            shm = self._open.pop(object_id, None)
        if shm is not None:
            try:
                shm.close()
                shm.unlink()
            except Exception:
                pass

    def release_create_ref(self, object_id: ObjectID):
        """Drop the creation mapping cached by create_from_chunks(
        hold=True): the segment is sealed and announced by now, and an
        executor keeping it would (a) leak the mapping until process
        exit and (b) read as a get-pin to the leak watchdog — every shm
        task return would be falsely flagged once the grace window
        passed, since the SUBMITTER owns the ref, not the executor. A
        later local get simply reopens the still-named segment."""
        self.release(object_id)

    def pin(self, object_id: ObjectID) -> bool:
        return True

    def unpin(self, object_id: ObjectID):
        pass

    def contains_locally(self, object_id: ObjectID) -> bool:
        if object_id in self._unsealed:
            return False
        if object_id in self._open:
            return True
        marker = self._unsealed_marker(object_id)
        if os.path.exists(marker):
            if not self._marker_stale(marker):
                return False  # another process is still writing it
            # the writer died mid-write: drop the partial so a re-pull
            # can recreate the object
            try:
                os.remove(marker)
            except OSError:
                pass
            try:
                stale = shared_memory.SharedMemory(
                    name=_shm_name(object_id))
                _unregister_tracker(stale)
                stale.close()
                stale.unlink()
            except FileNotFoundError:
                pass
            return False
        # probe WITHOUT caching: a cached mapping counts as a get-pin
        # (get_ref_counts), so a mere existence check — rt.wait from a
        # borrower that never gets the value — would otherwise hold the
        # segment forever and read as a watchdog leak. The probe handle
        # closes immediately (no view can have been exported from it,
        # so no orphan; actual reads cache via _mapping under the lock).
        try:
            shm = shared_memory.SharedMemory(name=_shm_name(object_id))
        except FileNotFoundError:
            return False
        _unregister_tracker(shm)
        shm.close()
        return True

    def _mapping(self, object_id: ObjectID) -> shared_memory.SharedMemory:
        with self._map_lock:
            shm = self._open.get(object_id)
            if shm is None:
                # open inside the lock: two threads double-opening would
                # orphan the loser's mapping (unclosable once views
                # export from it)
                shm = shared_memory.SharedMemory(name=_shm_name(object_id))
                _unregister_tracker(shm)
                self._open[object_id] = shm
            return shm

    def get_view(self, object_id: ObjectID, size: int) -> memoryview:
        """Zero-copy view of the sealed payload. The mapping is cached
        (the pin): it stays open until release(), and release() keeps it
        open for as long as any exported view is alive (BufferError
        tolerance). Raises FileNotFoundError if the segment is gone.

        The slice happens under _map_lock: release_create_ref (announce
        path) can release the creator's mapping concurrently with a
        get, and a close between _mapping() returning and .buf being
        sliced would hand back a dead buffer. Under the lock either the
        slice lands first (close then BufferError-parks as a zombie) or
        the release landed first and _mapping reopens fresh."""
        with self._map_lock:
            return self._mapping(object_id).buf[:size]

    def get(self, object_id: ObjectID, size: int) -> Any:
        """Zero-copy deserialize; the mapping stays cached so buffer views
        remain valid while this process holds the ref."""
        return deserialize(self.get_view(object_id, size))

    def read_bytes(self, object_id: ObjectID, size: int) -> bytes:
        with self._map_lock:  # see get_view: slice races release paths
            view = self._mapping(object_id).buf[:size]
        return bytes(view)

    def read_range_view(self, object_id: ObjectID, size: int, offset: int,
                        length: int):
        """(view, release_cb) for the push side of chunked transfer: the
        chunk aliases the cached mapping, no copy. release_cb is None —
        the mapping stays cached (same lifetime as every other read) and
        unlink's BufferError tolerance covers views still in flight."""
        with self._map_lock:  # see get_view: slice races release paths
            return (self._mapping(object_id).buf[offset:offset + length],
                    None)

    @staticmethod
    def _silence_del(shm: shared_memory.SharedMemory):
        """A mapping with live exported views cannot close; neutralize the
        instance's close so __del__ at interpreter shutdown doesn't spew
        'Exception ignored ... BufferError' (the map dies with the
        process either way). Only applied at store close() — while the
        store lives, zombies keep their real close so the sweep can
        reclaim them once their views die."""
        shm.close = lambda: None  # type: ignore[method-assign]

    def _park_zombie(self, shm: shared_memory.SharedMemory):
        """Record a mapping whose close() was refused by live views; the
        sweep reclaims it once they die. Counted + named at DEBUG so a
        store that accumulates zombies is diagnosable from logs and the
        rayt_object_store_zombie_* gauges instead of failing silently."""
        with self._map_lock:
            self._zombies.append(shm)
            self._zombies_parked += 1
        _log().debug("segment %s parked as zombie (live views pin the "
                     "mapping past its unlink)", shm.name)

    def _sweep_zombies(self):
        """Retry closing unlinked-but-pinned mappings: views that were
        in flight at unlink time (RawView pushes, spill writes) die
        shortly after, and the mapping must actually be reclaimed then —
        not accumulate until process exit."""
        if not self._zombies:
            return
        with self._map_lock:  # appends race this sweep from other threads
            zombies, self._zombies = self._zombies, []
            alive = []
            swept = []
            for shm in zombies:
                try:
                    shm.close()
                except BufferError:
                    alive.append(shm)
                else:
                    swept.append(shm.name)
                    self._zombies_swept += 1
            self._zombies.extend(alive)
        for name in swept:
            _log().debug("zombie segment %s reclaimed (views died)", name)

    def release(self, object_id: ObjectID):
        self._sweep_zombies()
        with self._map_lock:
            shm = self._open.pop(object_id, None)
        if shm is not None:
            try:
                shm.close()
            except BufferError:
                # Views alive. close() already dropped shm._buf before
                # the mmap refused to unmap, so this instance can never
                # serve another read — park it as a zombie (mapping
                # survives until the views die); a later get reopens the
                # still-named segment fresh. Re-caching it would poison
                # every subsequent access with _buf=None.
                self._park_zombie(shm)

    def unlink(self, object_id: ObjectID):
        """Destroy the segment (node-manager only, when refcount hits 0).

        Order matters for the zero-copy contract: the NAME is unlinked
        first (new opens fail immediately; existing mappings — live
        views — stay valid until their holders drop, plasma's delete
        semantics), and only then is the local mapping closed. A
        BufferError on close (views alive) must never skip the unlink,
        or the segment would leak on /dev/shm for the node's lifetime."""
        self._sweep_zombies()
        with self._map_lock:
            shm = self._open.pop(object_id, None)
        if shm is None:
            try:
                shm = shared_memory.SharedMemory(name=_shm_name(object_id))
            except FileNotFoundError:
                return
            _unregister_tracker(shm)
        # shm.unlink() sends an unregister; balance the one we already
        # sent at open/create time by re-registering first.
        try:
            resource_tracker.register(shm._name, "shared_memory")  # type: ignore[attr-defined]
        except Exception:
            pass
        try:
            shm.unlink()
        except FileNotFoundError:
            _unregister_tracker(shm)
        try:
            shm.close()
        except BufferError:
            # live zero-copy views: keep the (now anonymous) mapping
            # referenced so it survives until the views die; swept (and
            # actually closed) by the next release/unlink once they do
            self._park_zombie(shm)

    def drop_cached_mapping(self, object_id: ObjectID):
        """Release the cached mapping when the owner frees the object.
        The create path caches a mapping that no get-pin tracks; without
        this the creating process keeps the (already-unlinked) segment
        mapped until exit. Live views are safe: release() parks a
        view-pinned mapping as a zombie instead of unmapping it."""
        self.release(object_id)

    # ------------------------------------------------------ observability
    def get_ref_counts(self) -> dict[ObjectID, int]:
        """Live get-pin view for the object-state report / leak
        watchdog: in this store the cached mapping IS the pin, so every
        sealed entry in the cache counts as one held ref."""
        with self._map_lock:
            return {oid: 1 for oid in self._open
                    if oid not in self._unsealed}

    def stats(self) -> dict:
        """Segment-level snapshot for the rayt_object_store_* gauges and
        node object reports (mirrors NativeArenaStore.stats())."""
        with self._map_lock:
            zombie_bytes = 0
            for shm in self._zombies:
                try:
                    zombie_bytes += shm.size
                except Exception:
                    pass
            return {
                "segments": len(self._open),
                "unsealed": len(self._unsealed),
                "zombie_segments": len(self._zombies),
                "zombie_bytes": zombie_bytes,
                "zombies_parked_total": self._zombies_parked,
                "zombies_swept_total": self._zombies_swept,
                "fallback_objects": 0,
                "fallback_bytes": 0,
            }

    def close(self):
        with self._map_lock:
            oids = list(self._open)
        for oid in oids:
            self.release(oid)  # view-pinned mappings become zombies
        self._sweep_zombies()
        for shm in self._zombies:
            self._silence_del(shm)  # still pinned at shutdown: quiet exit
        self._zombies.clear()


def make_shm_store(node_id):
    """Node-scoped store factory: the C++ arena store (plasma-equivalent,
    ray_tpu_torch/_native/shm_store.cpp) when the toolchain can build it, else
    the per-object-segment fallback. All processes on a node derive the
    same arena name from the node id."""
    import os

    from ray_tpu_torch._internal.config import get_config
    from ray_tpu_torch._internal.logging_utils import setup_logger

    logger = setup_logger("object_store")
    mode = os.environ.get("RAYT_SHM_MODE", "")
    if mode != "segments" and not os.environ.get("RAYT_DISABLE_NATIVE_SHM"):
        try:
            from ray_tpu_torch._native import NativeArenaStore

            capacity = get_config().object_store_memory
            if not capacity:
                try:
                    import psutil

                    capacity = int(psutil.virtual_memory().total * 0.2)
                except Exception:
                    capacity = 2 << 30
                capacity = min(capacity, 8 << 30)
            return NativeArenaStore("raytshm_" + node_id.hex()[:16],
                                    capacity)
        except Exception as e:
            if mode == "native":
                # the node manager opened the arena: a per-segment fallback
                # here would silently diverge from every other process on
                # the node — fail loudly instead
                raise RuntimeError(
                    f"node uses the native arena store but this process "
                    f"could not open it: {e!r}") from e
            logger.warning(
                "native shm arena unavailable (%r); falling back to "
                "per-object segments", e)
    return ShmObjectStore()
