"""Native components, built on demand with the system toolchain.

The shm arena store (shm_store.cpp) is the plasma-equivalent C++ data
plane: one mmap'd segment per node, boundary-tag allocator, LRU eviction,
process-shared robust mutex. Python binds via ctypes (no pybind11 in the
image) and maps the same segment for zero-copy reads.

Build artifacts cache under ~/.cache/ray_tpu_torch keyed by source hash, so the
first import on a machine pays one g++ invocation (~1s) and every later
process just dlopens.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import subprocess
import threading
from typing import Any, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "shm_store.cpp")

_lib = None
_lib_err: Optional[str] = None
_lib_lock = threading.Lock()


def _build_lib() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    cache_dir = os.path.join(
        os.path.expanduser(os.environ.get("RAYT_CACHE_DIR",
                                          "~/.cache/ray_tpu_torch")))
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, f"libraytshm-{digest}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = so_path + f".tmp{os.getpid()}"
    subprocess.run(
        ["g++", "-O2", "-fPIC", "-shared", "-pthread", "-o", tmp, _SRC,
         "-lrt"],
        check=True, capture_output=True, text=True)
    os.replace(tmp, so_path)
    return so_path


def _fallback_dir(name: str) -> str:
    # under $TMPDIR (every process of a node inherits the same one), and
    # named apart from the TPU build's /tmp/rayt_fallback_*
    return os.path.join(os.environ.get("TMPDIR") or "/tmp",
                        f"rayt_torch_fallback_{name}")


def load_shm_lib():
    """Load (building if needed) the native store; None when unavailable."""
    global _lib, _lib_err
    with _lib_lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        if os.environ.get("RAYT_DISABLE_NATIVE_SHM"):
            _lib_err = "disabled via RAYT_DISABLE_NATIVE_SHM"
            return None
        try:
            lib = ctypes.CDLL(_build_lib())
        except Exception as e:
            _lib_err = repr(e)
            return None
        lib.rayt_shm_open.restype = ctypes.c_void_p
        lib.rayt_shm_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                      ctypes.c_uint64]
        lib.rayt_shm_arena_offset.restype = ctypes.c_uint64
        lib.rayt_shm_arena_offset.argtypes = [ctypes.c_void_p]
        for name in ("rayt_shm_create",):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                           ctypes.c_uint64,
                           ctypes.POINTER(ctypes.c_uint64)]
        lib.rayt_shm_get.restype = ctypes.c_int
        lib.rayt_shm_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_uint64),
                                     ctypes.POINTER(ctypes.c_uint64)]
        for name in ("rayt_shm_seal", "rayt_shm_release",
                     "rayt_shm_contains", "rayt_shm_delete"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        for name in ("rayt_shm_used", "rayt_shm_capacity",
                     "rayt_shm_num_objects", "rayt_shm_evictions"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_uint64
            fn.argtypes = [ctypes.c_void_p]
        lib.rayt_shm_close.restype = None
        lib.rayt_shm_close.argtypes = [ctypes.c_void_p]
        lib.rayt_shm_unlink.restype = ctypes.c_int
        lib.rayt_shm_unlink.argtypes = [ctypes.c_char_p]
        # release/acquire atomics for the SPSC channel seq words
        lib.rayt_atomic_store_release_u64.restype = None
        lib.rayt_atomic_store_release_u64.argtypes = [ctypes.c_void_p,
                                                      ctypes.c_uint64]
        lib.rayt_atomic_load_acquire_u64.restype = ctypes.c_uint64
        lib.rayt_atomic_load_acquire_u64.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_unavailable_reason() -> Optional[str]:
    return _lib_err


class NativeArenaStore:
    """ctypes wrapper over one node-scoped arena (plasma-client analog).

    Interface mirrors object_store.ShmObjectStore so the core worker and
    node manager can use either transparently.
    """

    DEFAULT_SLOTS = 1 << 16

    def __init__(self, name: str, capacity: int):
        lib = load_shm_lib()
        if lib is None:
            raise RuntimeError(
                f"native shm store unavailable: {native_unavailable_reason()}")
        self._lib = lib
        self._name = name.encode()
        self._handle = lib.rayt_shm_open(self._name, capacity,
                                         self.DEFAULT_SLOTS)
        if not self._handle:
            raise RuntimeError(f"rayt_shm_open({name!r}) failed")
        # map the same segment for zero-copy python-side reads/writes
        fd = os.open(f"/dev/shm/{name}", os.O_RDWR)
        try:
            total = os.fstat(fd).st_size
            self._map = mmap.mmap(fd, total)
        finally:
            os.close(fd)
        self._mv = memoryview(self._map)
        self._arena_off = lib.rayt_shm_arena_offset(self._handle)
        self._held: dict[Any, int] = {}   # oid -> get-refcount
        self._pending: dict[Any, int] = {}  # unsealed oid -> abs offset
        # RLock: release() can re-enter on the SAME thread via a GC
        # firing ObjectRef.__del__ -> pin drain -> release while this
        # thread is already inside a locked section
        self._lock = threading.RLock()
        # fallback-to-disk allocation (ref: plasma_allocator.cc fallback
        # mmaps): objects that don't fit the arena land in per-node files,
        # named by object id so every worker process sees them
        self._fallback_dir = _fallback_dir(name)
        self._pending_fb: dict[Any, str] = {}  # unsealed oid -> tmp path

    # ------------------------------------------------------------- helpers
    def _payload(self, offset: int, size: int) -> memoryview:
        start = self._arena_off + offset
        return self._mv[start:start + size]

    # ----------------------------------------------------- store interface
    def create_and_seal(self, object_id, value) -> int:
        from ray_tpu_torch._internal.serialization import serialize, serialized_size

        chunks = serialize(value)
        size = serialized_size(chunks)
        self._write_sealed(object_id, chunks, size)
        return size

    def create_from_bytes(self, object_id, data: bytes,
                          hold: bool = False) -> int:
        self._write_sealed(object_id, [data], len(data), hold=hold)
        return len(data)

    def create_from_chunks(self, object_id, chunks, size: int,
                           hold: bool = False) -> int:
        """Seal a payload assembled from transfer chunks without first
        joining them into one host buffer."""
        self._write_sealed(object_id, chunks, size, hold=hold)
        return size

    def _write_sealed(self, object_id, chunks, size: int,
                      hold: bool = False):
        if not self.create_unsealed(object_id, size):
            return  # already present (duplicate transfer): keep existing
        pos = 0
        for c in chunks:
            n = len(c) if isinstance(c, bytes) else c.nbytes
            self.write_at(object_id, pos,
                          bytes(c) if not isinstance(
                              c, (bytes, bytearray, memoryview)) else c)
            pos += n
        self.seal(object_id, hold=hold)

    # --------------------------------------------------- streaming creates
    # ------------------------------------------------- fallback-to-disk
    def _fb_path(self, object_id) -> str:
        return os.path.join(self._fallback_dir, object_id.hex())

    def _fb_exists(self, object_id) -> bool:
        return os.path.exists(self._fb_path(object_id))

    def create_unsealed(self, object_id, size: int) -> bool:
        """Allocate an entry to be filled by write_at + seal. The object
        is invisible to contains/get until sealed (state kCreating).
        False if it already exists. When the arena cannot fit it even
        after eviction, allocation FALLS BACK to a per-node file (ref:
        plasma fallback allocation) instead of raising."""
        if self._fb_exists(object_id):
            return False
        off = ctypes.c_uint64()
        rc = self._lib.rayt_shm_create(self._handle, object_id.binary(),
                                       size, ctypes.byref(off))
        if rc == -1:
            return False
        if rc != 0:
            # arena full: file-backed allocation, sealed via rename.
            # O_EXCL serializes concurrent creators across processes —
            # the loser sees the .creating file and treats the object as
            # already-in-progress (duplicate-transfer semantics).
            os.makedirs(self._fallback_dir, exist_ok=True)
            tmp = self._fb_path(object_id) + ".creating"
            try:
                fd = os.open(tmp, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                return False
            try:
                os.ftruncate(fd, size)
            finally:
                os.close(fd)
            with self._lock:
                self._pending_fb[object_id] = tmp
            return True
        with self._lock:
            self._pending[object_id] = self._arena_off + off.value
        return True

    def write_at(self, object_id, offset: int, data):
        with self._lock:
            base = self._pending.get(object_id)
            fb = self._pending_fb.get(object_id)
        if base is None and fb is not None:
            with open(fb, "r+b") as f:
                f.seek(offset)
                f.write(bytes(data) if not isinstance(
                    data, (bytes, bytearray)) else data)
            return
        n = len(data)
        self._mv[base + offset:base + offset + n] = data

    def seal(self, object_id, hold: bool = False):
        with self._lock:
            fb = self._pending_fb.pop(object_id, None)
        if fb is not None:
            os.replace(fb, self._fb_path(object_id))  # atomic seal
            return
        self._lib.rayt_shm_seal(self._handle, object_id.binary())
        with self._lock:
            self._pending.pop(object_id, None)
        if not hold:
            # with hold=True the creator keeps its create-ref so the LRU
            # can't evict the object before the node manager pins it;
            # the creator calls release_create_ref() afterwards
            self._lib.rayt_shm_release(self._handle, object_id.binary())

    def abort_unsealed(self, object_id):
        """Drop a half-written entry (failed/cancelled pull)."""
        with self._lock:
            fb = self._pending_fb.pop(object_id, None)
            self._pending.pop(object_id, None)
        if fb is not None:
            try:
                os.remove(fb)
            except OSError:
                pass
            return
        # creator still holds its create-ref: delete tombstones the entry,
        # release drops the last ref and frees the block
        self._lib.rayt_shm_delete(self._handle, object_id.binary())
        self._lib.rayt_shm_release(self._handle, object_id.binary())

    def contains_locally(self, object_id) -> bool:
        return bool(self._lib.rayt_shm_contains(
            self._handle, object_id.binary())) or self._fb_exists(object_id)

    def _get_view(self, object_id, size: int) -> memoryview:
        off = ctypes.c_uint64()
        sz = ctypes.c_uint64()
        rc = self._lib.rayt_shm_get(self._handle, object_id.binary(),
                                    ctypes.byref(off), ctypes.byref(sz))
        if rc != 0:
            if self._fb_exists(object_id):
                with open(self._fb_path(object_id), "rb") as f:
                    return memoryview(f.read())
            raise KeyError(f"object {object_id} not in shm store (rc={rc})")
        with self._lock:
            self._held[object_id] = self._held.get(object_id, 0) + 1
        return self._payload(off.value, sz.value)

    def get_view(self, object_id, size: int) -> memoryview:
        """Zero-copy view of the sealed payload. Takes a get-ref (the
        pin: LRU eviction cannot reclaim the block) that the caller must
        balance with release() once no deserialized view aliases it. The
        fallback-file branch returns an owned copy — release() is then a
        harmless no-op (no ref was taken)."""
        return self._get_view(object_id, size)

    def get(self, object_id, size: int):
        from ray_tpu_torch._internal.serialization import deserialize

        return deserialize(self._get_view(object_id, size))

    def read_bytes(self, object_id, size: int) -> bytes:
        view = self._get_view(object_id, size)
        try:
            return bytes(view)
        finally:
            self.release(object_id)

    def read_range_view(self, object_id, size: int, offset: int,
                        length: int):
        """One transfer chunk: (view, release_cb) for the push side of
        chunked transfer (ref: object_buffer_pool chunked reads) — the
        chunk aliases the arena mapping with a get-ref held, zero copy.
        The caller MUST invoke release_cb (when not None) after the bytes
        have been handed to the transport, or the block stays pinned."""
        if not self._lib.rayt_shm_contains(self._handle,
                                           object_id.binary()) \
                and self._fb_exists(object_id):
            with open(self._fb_path(object_id), "rb") as f:
                f.seek(offset)
                return f.read(length), None
        view = self._get_view(object_id, size)
        return (view[offset:offset + length],
                lambda: self.release(object_id))

    def release(self, object_id):
        with self._lock:
            # NULL-handle guard: a zero-copy get-pin can drain AFTER
            # store close (an ObjectRef GC'd past rt.shutdown()); the C
            # side has no guard and would segfault on a NULL arena
            if self._handle is None:
                return
            n = self._held.get(object_id, 0)
            if n <= 0:
                return
            self._held[object_id] = n - 1
            if self._held[object_id] == 0:
                del self._held[object_id]
            # C call inside the lock: close() also nulls the handle
            # under it, so the handle can't be torn down mid-call
            self._lib.rayt_shm_release(self._handle, object_id.binary())

    def release_create_ref(self, object_id):
        """Drop the ref held by create_from_bytes(hold=True)."""
        self._lib.rayt_shm_release(self._handle, object_id.binary())

    def pin(self, object_id) -> bool:
        """Node-manager primary-copy pin (ref: plasma primary copies are
        pinned by the raylet; spilling is the only reclaim path)."""
        off = ctypes.c_uint64()
        sz = ctypes.c_uint64()
        return self._lib.rayt_shm_get(self._handle, object_id.binary(),
                                      ctypes.byref(off),
                                      ctypes.byref(sz)) == 0

    def unpin(self, object_id):
        self._lib.rayt_shm_release(self._handle, object_id.binary())

    def unlink(self, object_id):
        self._lib.rayt_shm_delete(self._handle, object_id.binary())
        if self._fb_exists(object_id):
            try:
                os.remove(self._fb_path(object_id))
            except OSError:
                pass

    def used(self) -> int:
        # NULL-handle guard: stats on a closed store must return 0, not
        # dereference a dangling arena pointer in C
        return self._lib.rayt_shm_used(self._handle) if self._handle else 0

    def capacity(self) -> int:
        return (self._lib.rayt_shm_capacity(self._handle)
                if self._handle else 0)

    def num_objects(self) -> int:
        return (self._lib.rayt_shm_num_objects(self._handle)
                if self._handle else 0)

    def evictions(self) -> int:
        return (self._lib.rayt_shm_evictions(self._handle)
                if self._handle else 0)

    # ------------------------------------------------------ observability
    def get_ref_counts(self) -> dict:
        """Outstanding zero-copy get-refs held by THIS process (the pins
        the leak watchdog inspects): oid -> refcount snapshot."""
        with self._lock:
            return dict(self._held)

    def stats(self) -> dict:
        """Arena snapshot for the rayt_object_store_* gauges and node
        object reports. Reads only the C getters (shared-header counters)
        plus a fallback-dir scan — no allocator lock taken, safe on the
        hot path. Mirrors ShmObjectStore.stats() keys; arena "zombies"
        are get-ref-held blocks whose entry was already deleted, which
        the C side frees on the last release — reported via held_refs."""
        fb_objects = 0
        fb_bytes = 0
        try:
            with os.scandir(self._fallback_dir) as it:
                for e in it:
                    if e.name.endswith(".creating"):
                        continue
                    try:
                        fb_bytes += e.stat().st_size
                        fb_objects += 1
                    except OSError:
                        pass
        except OSError:
            pass
        with self._lock:
            held = len(self._held)
            unsealed = len(self._pending) + len(self._pending_fb)
        return {
            "segments": 1,  # one node-scoped arena segment
            "unsealed": unsealed,
            "zombie_segments": 0,
            "zombie_bytes": 0,
            "zombies_parked_total": 0,
            "zombies_swept_total": 0,
            "fallback_objects": fb_objects,
            "fallback_bytes": fb_bytes,
            "arena_used_bytes": self.used(),
            "arena_capacity_bytes": self.capacity(),
            "arena_objects": self.num_objects(),
            "arena_evictions_total": self.evictions(),
            "held_refs": held,
        }

    def close(self):
        with self._lock:
            if self._handle:
                try:
                    self._mv.release()
                    self._map.close()
                except (BufferError, ValueError):
                    pass  # zero-copy views alive; mapping stays until exit
                else:
                    self._lib.rayt_shm_close(self._handle)
                    self._handle = None

    def destroy_self(self):
        """Unlink the arena segment (node-manager only, at shutdown)."""
        self.close()
        NativeArenaStore.destroy(self._name.decode())

    @staticmethod
    def destroy(name: str):
        lib = load_shm_lib()
        if lib is not None:
            lib.rayt_shm_unlink(name.encode())
        import shutil

        shutil.rmtree(_fallback_dir(name),
                      ignore_errors=True)
