"""Object serialization: cloudpickle + pickle5 out-of-band buffers.

TPU-native analog of the reference's serialization stack
(ref: python/ray/_private/serialization.py and the cloudpickle fork):
we use stock cloudpickle (protocol 5) with a ``buffer_callback`` so large
contiguous payloads (numpy arrays, jax host arrays, arrow buffers) are
extracted zero-copy into a separate buffer list. The wire/shm format is::

    [8-byte header: n_buffers (u32) | pickled_len (u32)]
    [pickled bytes]
    [for each buffer: 8-byte length][buffer bytes, 8-byte aligned]

which lets the shared-memory store hand workers read-only memoryviews over
the buffers without copying (the plasma idea, ref:
src/ray/object_manager/plasma/protocol.cc, re-done host-side only — device
arrays never pass through here, they ride the mesh as jax.Array).
"""

from __future__ import annotations

import os
import pickle
import struct
from typing import Any, Callable

import cloudpickle

_HEADER = struct.Struct("<II")
_BUFLEN = struct.Struct("<Q")
_ALIGN = 8


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class _NeedCloudpickle(Exception):
    """The object graph needs cloudpickle's by-value semantics (a plain
    pickle save_global would succeed but emit a reference the unpickling
    worker cannot import)."""


def _fast_payload_hazard(payload: bytes) -> bool:
    """Did the C pickler emit a by-reference global that cloudpickle
    would have shipped by value? save_global always writes the module
    name as a verbatim string, so a stream free of ``__main__`` (and of
    every ship_code_by_value-registered module name) cannot reference
    them. False positives (a user STRING containing "__main__") merely
    fall back to cloudpickle — slower, never wrong."""
    if payload.find(b"__main__") != -1:
        return True
    for mod_name in _by_value_registered:
        if payload.find(mod_name.encode()) != -1:
            return True
    return False


def serialize(obj: Any) -> list[bytes | memoryview]:
    """Serialize to a list of chunks (zero-copy for out-of-band buffers).

    The caller concatenates (for sockets, writev-style) or copies into a
    single shm allocation.

    Fast path: the stdlib C pickler (~5-10x cheaper per control message
    than CloudPickler, byte-compatible with pickle.loads). Anything it
    cannot pickle (lambdas, closures, dynamic classes) falls back to
    cloudpickle, as does any stream that references __main__ or a
    registered driver-local module (see _fast_payload_hazard).
    """
    buffers: list[pickle.PickleBuffer] = []
    try:
        payload = pickle.dumps(obj, protocol=5,
                               buffer_callback=buffers.append)
        if _fast_payload_hazard(payload):
            raise _NeedCloudpickle
    except Exception:
        buffers = []  # drop buffers extracted before the abort
        payload = cloudpickle.dumps(obj, protocol=5,
                                    buffer_callback=buffers.append)
    chunks: list[bytes | memoryview] = [
        _HEADER.pack(len(buffers), len(payload)),
        payload,
    ]
    pad = _pad(len(payload)) - len(payload)
    if pad:
        chunks.append(b"\x00" * pad)
    for pb in buffers:
        raw = pb.raw()
        chunks.append(_BUFLEN.pack(raw.nbytes))
        chunks.append(raw)
        pad = _pad(raw.nbytes) - raw.nbytes
        if pad:
            chunks.append(b"\x00" * pad)
    return chunks


def serialized_size(chunks: list[bytes | memoryview]) -> int:
    return sum(len(c) if isinstance(c, bytes) else c.nbytes for c in chunks)


def chunks_to_bytes(chunks: list[bytes | memoryview]) -> bytes:
    """Join a serialize() chunk list into one contiguous blob with exactly
    one copy (``bytes.join`` consumes memoryviews directly — no per-chunk
    ``bytes()`` materialization)."""
    if len(chunks) == 1 and isinstance(chunks[0], bytes):
        return chunks[0]
    return b"".join(chunks)


def serialize_to_bytes(obj: Any) -> bytes:
    return chunks_to_bytes(serialize(obj))


def deserialize(data: bytes | memoryview, *, buffer_wrapper=None) -> Any:
    """Deserialize from a contiguous buffer, zero-copy for buffers.

    When ``data`` is a memoryview over shared memory, the out-of-band
    buffers alias that memory: the resulting numpy arrays are views, not
    copies (callers must keep the mapping alive; ObjectRef holders do).

    ``buffer_wrapper``, when given, is applied to each out-of-band buffer
    view before it is handed to pickle — the zero-copy get path uses it
    to interpose weakref-able pin holders so the shm segment stays mapped
    exactly as long as any reconstructed array aliases it.
    """
    mv = memoryview(data)
    n_buffers, plen = _HEADER.unpack_from(mv, 0)
    off = _HEADER.size
    payload = mv[off:off + plen]
    off += _pad(plen)
    buffers = []
    for _ in range(n_buffers):
        (blen,) = _BUFLEN.unpack_from(mv, off)
        off += _BUFLEN.size
        view = mv[off:off + blen]
        buffers.append(view if buffer_wrapper is None else buffer_wrapper(view))
        off += _pad(blen)
    return pickle.loads(payload, buffers=buffers)


class SerializationContext:
    """Pluggable reducers, mirroring ref _private/serialization.py's
    custom-serializer registry (ray.util.register_serializer)."""

    def __init__(self):
        self._custom: dict[type, tuple[Callable, Callable]] = {}

    def register(self, typ: type, serializer: Callable, deserializer: Callable):
        self._custom[typ] = (serializer, deserializer)
        # cloudpickle honors copyreg-style dispatch via __reduce__; simplest
        # robust hook is a pickle-by-value wrapper:
        import copyreg

        def _reduce(obj, _ser=serializer, _de=deserializer):
            return (_de, (_ser(obj),))

        copyreg.pickle(typ, _reduce)

    def deregister(self, typ: type):
        self._custom.pop(typ, None)


_context = SerializationContext()


def get_context() -> SerializationContext:
    return _context


# ------------------------------------------------- driver-local code shipping
_by_value_registered: set[str] = set()
_scanned_modules: set[str] = set()
# the directory holding the ray_tpu_torch package: spawn.child_env puts it
# on every worker's import path, so a module found there under its own name
# is imported by the worker and ships by reference
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def ship_code_by_value(fn: Any) -> None:
    """Make cloudpickle serialize `fn`'s defining module by value when that
    module is driver-local (not installed in site/dist-packages), so workers
    without the driver's sys.path can still unpickle it. Walks the module's
    globals transitively so sibling driver-local modules it imports ship
    too.

    Ref analog: the function table ships pickled definitions through GCS KV
    (python/ray/_private/function_manager.py:58); here the definition rides
    inside the task spec instead, and by-value registration covers
    module-level functions (closures/lambdas/__main__ are by-value already).
    """
    _register_module_tree(getattr(fn, "__module__", None))


def _is_driver_local(mod) -> bool:
    """True for a module that workers cannot import by its name: not in
    site/dist-packages, not in the interpreter's prefix, and not found in
    the checkout under its name (as the JAX package's modules are, when a
    test module that ships code imports them). Registering a module that
    workers import by name would pickle its classes by value in this whole
    process: another runtime driven from it would then hand its workers
    copies of its own classes that their isinstance checks reject."""
    import sys

    mod_file = getattr(mod, "__file__", None)
    if mod_file is None:
        return False
    path = mod_file.replace("\\", "/")
    if "/site-packages/" in path or "/dist-packages/" in path:
        return False
    base = os.path.join(_CHECKOUT, *mod.__name__.split("."))
    if os.path.abspath(mod_file) in (base + ".py",
                                     os.path.join(base, "__init__.py")):
        return False
    return not path.startswith(getattr(sys, "base_prefix", "\0"))


def _register_module_tree(mod_name: str | None) -> None:
    import sys
    import types

    if not mod_name or mod_name in ("__main__", "builtins"):
        return
    if mod_name.split(".")[0] == "ray_tpu_torch" or mod_name in _scanned_modules:
        return
    _scanned_modules.add(mod_name)
    mod = sys.modules.get(mod_name)
    if mod is None or not _is_driver_local(mod):
        return
    try:
        cloudpickle.register_pickle_by_value(mod)
        _by_value_registered.add(mod_name)
    except Exception:
        return
    for value in list(vars(mod).values()):
        if isinstance(value, types.ModuleType):
            _register_module_tree(value.__name__)
        else:
            sub = getattr(value, "__module__", None)
            if isinstance(sub, str):
                _register_module_tree(sub)


def dumps_code(fn: Any) -> bytes:
    """Pickle a function/class for remote execution, shipping driver-local
    module trees by value first. If by-value capture hits an unpicklable
    module-level global (open connections, locks), fall back to
    by-reference for that tree — same-host workers can import it via
    PYTHONPATH."""
    ship_code_by_value(fn)
    try:
        return cloudpickle.dumps(fn)
    except Exception:
        _unregister_module_tree(getattr(fn, "__module__", None))
        return cloudpickle.dumps(fn)


def _unregister_module_tree(mod_name: str | None) -> None:
    import sys

    if not mod_name:
        return
    for name in list(_by_value_registered):
        mod = sys.modules.get(name)
        if mod is None:
            continue
        try:
            cloudpickle.unregister_pickle_by_value(mod)
            _by_value_registered.discard(name)
            _scanned_modules.discard(name)
        except Exception:
            pass
