"""Direct call channel: the control-plane fastpath for task pushes.

Ref analog: the reference's *direct task submission* — callers push
tasks straight to leased/actor workers over a dedicated channel instead
of through any intermediary (core_worker.h direct actor/task transport).

Why a second transport exists: the asyncio RPC stack costs one event
loop iteration, several Task objects, and 2+ cross-thread wakeups per
message — ~0.5 ms of pure CPU per task round-trip on a small host.
That is fine for the management plane (leases, heartbeats, pubsub,
bulk object transfer) but dominates the submit→execute→reply cycle of
sub-millisecond tasks. This module runs exactly that cycle over plain
blocking sockets serviced by dedicated threads:

* :class:`DirectServer` (worker side) — one listener thread + one
  thread per connection. Requests execute through the worker's normal
  executor (so cancel, actor ordering, and the single-execution
  invariant are shared with the asyncio path) and the reply is written
  straight back from the connection thread — no event loop in the
  round-trip at all.
* :class:`DirectClient` (owner side) — serializes on the calling
  thread, sends under a lock, and a reader thread dispatches replies to
  per-call callbacks. The driver's submit path uses it two ways: actor
  calls complete entirely on caller+reader threads (the sync fast
  lane), normal-task pushes bridge the reply back to the IO loop where
  lease recycling lives.

Wire format: identical to _internal/rpc.py frames (u32 length +
msgpack ``[msgid, kind, method, payload]``, payload = serialize()
bytes), so a DirectServer speaks to anything that frames messages the
same way. Only REQUEST/RESPONSE/ERROR kinds travel here; large
payloads (>= ``DIRECT_MAX_BYTES``) stay on the asyncio path with its
scatter-gather framing.
"""

from __future__ import annotations

import itertools
import socket
import struct
import threading
import traceback
from typing import Any, Callable

import msgpack

from ray_tpu_torch._internal.logging_utils import setup_logger
from ray_tpu_torch._internal.rpc import (ERROR, REQUEST, RESPONSE, ConnectionLost,
                                         RemoteError)
from ray_tpu_torch._internal.serialization import (chunks_to_bytes, deserialize,
                                                   serialize)

logger = setup_logger("direct")

_LEN = struct.Struct("<I")

# control messages larger than this fall back to the asyncio path (its
# scatter-gather framing handles bulk payloads without extra copies).
# The cap also bounds sender-side blocking: pushes go out with a plain
# sendall — from user threads, reader threads, and (on the lease-grant
# path) the owner's IO loop — so with SNDBUF below and pipeline depth 2
# a busy worker's unread requests always fit the send buffer and
# sendall never parks the caller
DIRECT_MAX_BYTES = 128 * 1024

# explicit send-buffer size on both ends (the kernel default can start
# as low as ~16KB before autotuning; see DIRECT_MAX_BYTES)
_SNDBUF = 1 << 20


class DirectConnectionLost(ConnectionLost):
    """Direct-channel connection loss — a ConnectionLost subtype so every
    existing retry/failover clause treats both transports identically."""


def _encode(msgid: int, kind: int, method: str, value: Any) -> bytes | None:
    """One wire message, or None when the payload belongs on the asyncio
    path (too large)."""
    payload = chunks_to_bytes(serialize(value))
    if len(payload) > DIRECT_MAX_BYTES:
        return None
    body = msgpack.packb([msgid, kind, method, payload], use_bin_type=True)
    return _LEN.pack(len(body)) + body


def _encode_reply(msgid: int, kind: int, method: str, value: Any) -> bytes:
    """Replies always encode (the server already committed to this
    channel); oversized results are legal, just rare."""
    payload = chunks_to_bytes(serialize(value))
    body = msgpack.packb([msgid, kind, method, payload], use_bin_type=True)
    return _LEN.pack(len(body)) + body


class _FrameReader:
    """Blocking frame parser over a socket (recv-buffered). ``poll``
    mode checks readability with select() before every recv and raises
    BlockingIOError when the socket has nothing — WITHOUT touching the
    socket's timeout, which is shared state a concurrent sender on
    another thread would also see (a sendall running while a reader
    flips settimeout(0) would go non-blocking mid-frame and corrupt
    the stream). Partial frames stay buffered across calls."""

    __slots__ = ("sock", "_buf")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._buf = bytearray()

    def _fill(self, need: int, poll: bool = False):
        import select

        while len(self._buf) < need:
            if poll:
                ready, _, _ = select.select([self.sock], [], [], 0)
                if not ready:
                    raise BlockingIOError
            chunk = self.sock.recv(1 << 18)
            if not chunk:
                raise DirectConnectionLost("peer closed")
            self._buf.extend(chunk)

    def read_msg(self, poll: bool = False):
        self._fill(_LEN.size, poll)
        (length,) = _LEN.unpack_from(self._buf, 0)
        self._fill(_LEN.size + length, poll)
        body = bytes(memoryview(self._buf)[_LEN.size:_LEN.size + length])
        del self._buf[:_LEN.size + length]
        return msgpack.unpackb(body, raw=False, use_list=True)


class DirectServer:
    """Worker-side direct-call endpoint. ``handlers`` maps method name
    to a plain function ``fn(arg) -> result`` executed ON the connection
    thread (handlers bridge into the worker's executor themselves)."""

    def __init__(self, handlers: dict[str, Callable[[Any], Any]]):
        self.handlers = handlers
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._closed = False
        self._conns: list[socket.socket] = []
        t = threading.Thread(target=self._accept_loop,
                             name="rayt-direct-accept", daemon=True)
        t.start()

    def _accept_loop(self):
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                _SNDBUF)
            except OSError:
                pass
            self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             name="rayt-direct-serve", daemon=True).start()

    def _serve(self, conn: socket.socket):
        reader = _FrameReader(conn)
        try:
            while True:
                msgid, kind, method, payload = reader.read_msg()
                if kind != REQUEST:
                    continue
                try:
                    handler = self.handlers.get(method)
                    if handler is None:
                        raise RuntimeError(
                            f"no direct handler for {method!r}")
                    result = handler(deserialize(payload))
                    out = _encode_reply(msgid, RESPONSE, method, result)
                except Exception as e:
                    out = _encode_reply(
                        msgid, ERROR, method,
                        (f"{type(e).__name__}: {e}",
                         traceback.format_exc()))
                conn.sendall(out)
        except (DirectConnectionLost, ConnectionError, OSError):
            pass
        except Exception:
            logger.exception("direct serve loop died")
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self):
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass


class DirectClient:
    """Owner-side direct connection to one worker.

    ``try_call`` serializes on the calling thread and registers a
    callback pair; the reader thread invokes exactly one of them per
    call — ``on_reply(result)`` for RESPONSE frames, ``on_error(exc)``
    for ERROR frames and connection loss. Callbacks run ON the reader
    thread; everything they touch must be thread-safe (CoreWorker's
    completion paths are)."""

    def __init__(self, host: str, port: int, reader: bool = True):
        self.sock = socket.create_connection((host, port), timeout=10)
        self.sock.settimeout(None)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                 _SNDBUF)
        except OSError:
            pass
        self._wlock = threading.Lock()
        self._msgid = itertools.count(1)
        self._plock = threading.Lock()
        self._pending: dict[int, tuple[Callable, Callable]] = {}
        self.closed = False
        # connection-scoped peer state (e.g. function-table push-once
        # bookkeeping rides here, mirroring Connection._fn_pushed)
        self.fn_pushed: set[str] = set()
        # held across mark-blob-sent + send by normal-task pushers so
        # the frame CARRYING a function blob reaches the wire before
        # any blob-less frame for the same function id (two threads
        # pushing to one worker would otherwise race attach vs send)
        self.push_lock = threading.Lock()
        self._frames = _FrameReader(self.sock)
        # ``reader=False`` makes a SYNC-mode client: no reader thread —
        # replies are pumped by caller threads via drive() (the getter
        # blocked on a result reads it off the socket itself: one less
        # thread wake per round-trip, and a pipelined burst's replies
        # all dispatch on the getting thread). A low-rate reaper covers
        # fire-and-forget callers so un-driven completions still land.
        self.read_lock = threading.Lock()
        if reader:
            self._reader = threading.Thread(target=self._read_loop,
                                            name="rayt-direct-read",
                                            daemon=True)
            self._reader.start()
        else:
            self._reader = None
            threading.Thread(target=self._reap_loop,
                             name="rayt-direct-reap",
                             daemon=True).start()

    def try_call(self, method: str, arg: Any,
                 on_reply: Callable[[Any], None],
                 on_error: Callable[[Exception], None]) -> bool:
        """False => not sent (closed, or payload too large): the caller
        must fall back to the asyncio path. True => exactly one callback
        will fire."""
        if self.closed:
            return False
        msgid = next(self._msgid)
        msg = _encode(msgid, REQUEST, method, arg)
        if msg is None:
            return False
        with self._plock:
            if self.closed:
                return False
            self._pending[msgid] = (on_reply, on_error)
        try:
            with self._wlock:
                self.sock.sendall(msg)
        except OSError as e:
            self._teardown(e)
        return True

    def _dispatch_frame(self, msg):
        msgid, kind, method, payload = msg
        with self._plock:
            cbs = self._pending.pop(msgid, None)
        if cbs is None:
            return
        on_reply, on_error = cbs
        try:
            if kind == RESPONSE:
                on_reply(deserialize(payload))
            elif kind == ERROR:
                err, tb = deserialize(payload)
                on_error(RemoteError(err, tb))
        except Exception:
            logger.exception("direct reply callback failed")

    def _read_loop(self):
        try:
            while True:
                self._dispatch_frame(self._frames.read_msg())
        except (DirectConnectionLost, ConnectionError, OSError) as e:
            self._teardown(e)
        except Exception as e:
            logger.exception("direct read loop died")
            self._teardown(e)

    def read_available(self) -> list:
        """Drain whole frames already available on the socket WITHOUT
        blocking (select-polled reads — the socket's shared timeout is
        never touched; partial frames stay buffered for the next pump).
        The caller must hold ``read_lock`` and dispatch the returned
        messages AFTER releasing it. Connection failure tears the
        client down (pending callbacks fire with the error)."""
        msgs: list = []
        try:
            while self._pending:
                try:
                    msgs.append(self._frames.read_msg(poll=True))
                except (BlockingIOError, InterruptedError):
                    break
        except (DirectConnectionLost, ConnectionError, OSError) as e:
            self._teardown(e)
        return msgs

    def dispatch_all(self, msgs: list):
        for msg in msgs:
            self._dispatch_frame(msg)

    def _reap_loop(self):
        """Sync-mode safety net: completions whose caller never gets
        (fire-and-forget submits) are drained here within ~50ms, so
        bookkeeping (pending-task state, rt.wait) still converges."""
        import time as _time

        while not self.closed:
            _time.sleep(0.05)
            if not self._pending:
                continue
            if not self.read_lock.acquire(blocking=False):
                continue  # an active getter is pumping
            try:
                msgs = self.read_available()
            finally:
                self.read_lock.release()
            self.dispatch_all(msgs)

    def _teardown(self, cause: Exception):
        with self._plock:
            if self.closed:
                return
            self.closed = True
            pending, self._pending = self._pending, {}
        try:
            self.sock.close()
        except OSError:
            pass
        err = DirectConnectionLost(f"direct connection lost: {cause!r}")
        for _, on_error in pending.values():
            try:
                on_error(err)
            except Exception:
                logger.exception("direct error callback failed")

    def close(self):
        self._teardown(DirectConnectionLost("closed"))
