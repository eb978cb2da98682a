"""RPC substrate: length-prefixed msgpack frames over asyncio streams.

TPU-native analog of the reference's L0 (ref: src/ray/rpc/ — gRPC services,
retryable clients, and rpc_chaos fault injection). Design decisions:

* One protocol for everything: ``[u32 length][msgpack [msgid, kind, method,
  payload]]`` where payload is a pickle-5 blob (see serialization.py). This
  replaces the reference's per-service protobufs — the control plane here is
  a single-digit number of services, and pickled dataclasses keep the
  schemas in one language while staying introspectable.
* Server-push NOTIFY frames on long-lived connections replace the
  reference's long-poll pubsub (ref: src/ray/pubsub/publisher.h:297) — an
  asyncio stream is already a persistent channel, so the publisher just
  writes frames.
* Chaos hooks (drop request / drop reply with configured probability)
  mirror RAY_testing_rpc_failure (ref: src/ray/rpc/rpc_chaos.h:23).
"""

from __future__ import annotations

import asyncio
import itertools
import os
import random
import struct
import sys
import threading
import traceback
from typing import Any, Awaitable, Callable

import msgpack

from ray_tpu_torch._internal.config import get_config
from ray_tpu_torch._internal.logging_utils import setup_logger

logger = setup_logger("rpc")
from ray_tpu_torch._internal.serialization import (chunks_to_bytes, deserialize,
                                                   serialize, serialized_size)

REQUEST, RESPONSE, ERROR, NOTIFY = 0, 1, 2, 3
_LEN = struct.Struct("<I")
MAX_FRAME = 1 << 31
# Stream buffer limit for asyncio readers: the default 64 KiB causes
# transport pause/resume thrash on multi-MiB frames (each readexactly
# wakes dozens of times), collapsing pipelined bulk-transfer throughput.
STREAM_LIMIT = 32 * 1024 * 1024


class RpcError(Exception):
    pass


class RemoteError(RpcError):
    """An exception raised inside a remote handler, re-raised locally."""

    def __init__(self, message: str, remote_traceback: str = ""):
        super().__init__(message)
        self.remote_traceback = remote_traceback

    def __str__(self):
        s = super().__str__()
        if self.remote_traceback:
            s += "\n--- remote traceback ---\n" + self.remote_traceback
        return s


class ConnectionLost(RpcError):
    pass


class _Chaos:
    """Probabilistic request/reply dropping for chaos tests."""

    def __init__(self):
        cfg = get_config()
        self.prob = cfg.testing_rpc_failure_prob
        self.rng = random.Random(cfg.testing_chaos_seed or None)

    def should_drop(self) -> bool:
        return self.prob > 0 and self.rng.random() < self.prob


async def _read_frame(reader: asyncio.StreamReader):
    """Returns (msgid, kind, method, value, is_raw). A 5-element header
    marks an out-of-band payload of `rawlen` bytes: when the tag (4th
    element) is None the bytes are the value verbatim (RAW bulk-transfer
    fast path, is_raw=True); when the tag is truthy the bytes are a
    serialized payload the sender handed to the transport as the raw
    serialize() chunk list — semantically identical to a 4-element
    pickled frame, so is_raw=False and callers deserialize."""
    header = await reader.readexactly(_LEN.size)
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise RpcError(f"frame too large: {length}")
    data = await reader.readexactly(length)
    frame = msgpack.unpackb(data, raw=False, use_list=True)
    if len(frame) == 5:
        msgid, kind, method, tag, rawlen = frame
        if rawlen > MAX_FRAME:
            raise RpcError(f"raw frame too large: {rawlen}")
        raw = await reader.readexactly(rawlen)
        return msgid, kind, method, raw, tag is None
    msgid, kind, method, payload = frame
    return msgid, kind, method, payload, False


# bytes values at least this large skip pickle+msgpack re-framing and go
# on the wire verbatim (object-transfer chunks are the main rider); the
# receiver hands the bytes straight to the caller. Serialized payloads
# whose total size crosses the same threshold ride out-of-band too, as
# the raw serialize() chunk list: the pickle header and each pickle-5
# buffer reach the transport as separate buffers, cutting the copy count
# to the transport's single writelines join (a sendmsg-capable transport
# would make it true writev) — vs. the joined blob being copied AGAIN
# into the msgpack body on the old path.
RAW_THRESHOLD = 256 * 1024

# tag marking an out-of-band SERIALIZED payload (vs None = verbatim raw)
_SG_TAG = 1

# Pre-3.12 selector transports JOIN writelines buffers (a userspace copy),
# so once writelines returns, the caller's memoryviews are no longer
# referenced and a RawView's mapping pin can drop after drain(). 3.12+
# writelines is sendmsg-based zero-copy: the transport may queue the view
# itself, so releasing the pin after drain() could let eviction overwrite
# bytes still in flight — materialize RawView payloads to bytes there
# (one copy, exactly what the pre-3.12 join costs anyway).
_WRITELINES_JOINS = sys.version_info < (3, 12)


class RawView:
    """A raw response payload that aliases long-lived memory (e.g. a shm
    mapping) plus a completion callback. The rpc layer sends ``data``
    verbatim on the RAW path regardless of size and invokes ``on_sent``
    once the buffer has been handed to the transport — the push side of
    object transfer uses this to keep the source mapping pinned until
    the write drains, then drop its get-ref (no ``bytes()`` copy)."""

    __slots__ = ("data", "on_sent")

    def __init__(self, data, on_sent=None):
        self.data = data
        self.on_sent = on_sent

    def done(self):
        cb, self.on_sent = self.on_sent, None
        if cb is not None:
            try:
                cb()
            except Exception:
                pass


class Serialized:
    """A value the CALLER already passed through serialize(): the rpc
    layer frames the chunk list verbatim instead of re-serializing —
    large payloads ride the scatter-gather path (each pickle-5 buffer
    reaches the transport as its own buffer), small ones join once into
    an inline frame. The DCN channel uses this to serialize on the
    producer's tick thread and keep the event loop to pure framing."""

    __slots__ = ("chunks", "total")

    def __init__(self, chunks: list):
        self.chunks = chunks
        self.total = serialized_size(chunks)


# Coalesced small-frame writes flush once the per-tick buffer holds this
# many bytes (bounds the latency/copy cost of the join for bursty ticks).
COALESCE_MAX_BYTES = 256 * 1024


def _frames(msgid: int, kind: int, method: str, value) -> list:
    """Encode one message as a list of wire buffers (header [+ payload
    chunks]), handed to ``writer.writelines`` verbatim — at most one
    copy (the transport's join) between the value's buffers and the
    socket."""
    if isinstance(value, RawView):
        data = value.data
        if not _WRITELINES_JOINS and not isinstance(data, bytes):
            data = bytes(data)  # see _WRITELINES_JOINS
        head = msgpack.packb([msgid, kind, method, None, len(data)],
                             use_bin_type=True)
        return [_LEN.pack(len(head)) + head, data]
    if isinstance(value, (bytes, bytearray, memoryview)) \
            and len(value) >= RAW_THRESHOLD:
        head = msgpack.packb([msgid, kind, method, None, len(value)],
                             use_bin_type=True)
        return [_LEN.pack(len(head)) + head, value]
    if isinstance(value, Serialized):
        chunks, total = value.chunks, value.total
    else:
        chunks = serialize(value)
        total = serialized_size(chunks)
    if total >= RAW_THRESHOLD:
        head = msgpack.packb([msgid, kind, method, _SG_TAG, total],
                             use_bin_type=True)
        return [_LEN.pack(len(head)) + head, *chunks]
    body = msgpack.packb([msgid, kind, method, chunks_to_bytes(chunks)],
                         use_bin_type=True)
    return [_LEN.pack(len(body)) + body]


class Connection:
    """One live peer connection (either direction). Thread-unsafe; use from
    the owning event loop only."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        sock = writer.get_extra_info("socket")
        if sock is not None:
            try:
                import socket as _socket

                sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            except OSError:
                pass
        try:
            # default write high-water mark is 64 KiB: concurrent bulk
            # responses then thrash drain()/resume cycles; let multi-MiB
            # frames buffer before back-pressuring the writers
            writer.transport.set_write_buffer_limits(high=STREAM_LIMIT)
        except Exception:
            pass
        self._msgid = itertools.count(1)
        self.close_reason = ""
        self._pending: dict[int, asyncio.Future] = {}
        self._notify_handlers: dict[str, Callable[[Any], None]] = {}
        self._closed = asyncio.Event()
        self._chaos = _Chaos()
        self._read_task: asyncio.Task | None = None
        # small-frame coalescing: control frames queued in the same
        # event-loop tick are flushed with ONE writelines (one transport
        # join + one send syscall) instead of a syscall per message
        self._wbuf: list = []
        self._wbuf_bytes = 0
        self._flush_scheduled = False
        # Set by RpcServer for inbound connections:
        self.server_handlers: dict[str, Callable] | None = None
        self.on_close: list[Callable[["Connection"], None]] = []

    def start(self):
        self._read_task = asyncio.ensure_future(self._read_loop())

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def peername(self):
        try:
            return self.writer.get_extra_info("peername")
        except Exception:
            return None

    # ------------------------------------------------- coalesced writes
    def _send_frames(self, frames: list):
        """Queue one encoded message for the wire. Small control frames
        (single pre-joined buffer from _frames) coalesce into a per-tick
        batch; multi-buffer messages (RAW / scatter-gather payloads) keep
        the immediate writelines path — their buffers may alias shm
        mappings whose pin lifetime is tied to the write (see RawView),
        and they are exactly the frames big enough that batching buys
        nothing."""
        if len(frames) == 1:
            buf = frames[0]
            self._wbuf.append(buf)
            self._wbuf_bytes += len(buf)
            if self._wbuf_bytes >= COALESCE_MAX_BYTES:
                self._flush_wbuf()
            elif not self._flush_scheduled:
                self._flush_scheduled = True
                asyncio.get_running_loop().call_soon(self._flush_wbuf)
            return
        # large path: pending small frames first (wire order), then the
        # scatter-gather chunk list verbatim
        if self._wbuf:
            self._flush_wbuf()
        self._writelines(frames)

    def _flush_wbuf(self):
        self._flush_scheduled = False
        if not self._wbuf:
            return
        buf, self._wbuf = self._wbuf, []
        self._wbuf_bytes = 0
        if self.closed:
            return  # pending futures already failed by _teardown
        try:
            self._writelines(buf)
        except Exception:
            pass  # the read loop notices the dead transport

    def _writelines(self, bufs: list):
        """Hand buffers to the transport unless it is closing. A fatal
        send error (the peer reset the connection) closes the transport
        at once but its socket only on the next loop pass, and 3.12's
        selector transport `writelines` does not check for that: it
        queues the bytes and registers a writer for the fd, a selector
        key the socket's close then leaves behind. The next socket given
        that fd number never reads (its reader's register raises
        FileNotFoundError from epoll's modify)."""
        if self.writer.transport.is_closing():
            return  # the read loop notices the dead transport
        self.writer.writelines(bufs)

    async def _maybe_drain(self):
        """Back-pressure check: only await drain() once the transport's
        buffer is past its high-water mark — the common small-frame case
        never blocks (the reply/ack the caller awaits paces it)."""
        try:
            if self.writer.transport.get_write_buffer_size() > STREAM_LIMIT:
                await self.writer.drain()
        except (ConnectionError, OSError, AttributeError):
            pass

    async def _read_loop(self):
        try:
            while True:
                msgid, kind, method, payload, is_raw = \
                    await _read_frame(self.reader)
                if kind == REQUEST:
                    self._dispatch_request(msgid, method, payload, is_raw)
                elif kind in (RESPONSE, ERROR):
                    fut = self._pending.pop(msgid, None)
                    if fut is not None and not fut.done():
                        if kind == RESPONSE:
                            fut.set_result(
                                payload if is_raw else deserialize(payload))
                        else:
                            msg, tb = deserialize(payload)
                            fut.set_exception(RemoteError(msg, tb))
                elif kind == NOTIFY:
                    handler = self._notify_handlers.get(method)
                    if handler is not None:
                        try:
                            res = handler(
                                payload if is_raw else deserialize(payload))
                            if asyncio.iscoroutine(res):
                                asyncio.ensure_future(res)
                        except Exception:
                            traceback.print_exc()
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            self.close_reason = self.close_reason or repr(e)
        except asyncio.CancelledError:
            self.close_reason = self.close_reason or "cancelled"
        except BaseException as e:  # diagnosis: NEVER silently drop a conn
            self.close_reason = f"unexpected {type(e).__name__}: {e}"
            logger.warning("rpc read loop died (%s): %s",
                           self.peername(), self.close_reason)
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                self._teardown()
                raise
        finally:
            self._teardown()

    def _teardown(self):
        if self._closed.is_set():
            return
        # last-gasp flush: messages buffered this tick (e.g. a notify
        # right before close) still reach the transport, which flushes
        # queued bytes before the FIN
        if self._wbuf:
            try:
                self._flush_wbuf()
            except Exception:
                pass
        self._closed.set()
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionLost("connection closed"))
        self._pending.clear()
        try:
            self.writer.close()
        except Exception:
            pass
        for cb in self.on_close:
            try:
                cb(self)
            except Exception:
                traceback.print_exc()

    def _dispatch_request(self, msgid: int, method: str, payload,
                          is_raw: bool):
        """Run a request handler. Sync handlers returning a plain value
        reply inline — no Task object, no scheduling round-trip; only
        handlers that return an awaitable pay for a Task."""
        result = None
        try:
            handler = (self.server_handlers or {}).get(method)
            if handler is None:
                raise RpcError(f"no handler for method {method!r}")
            arg = payload if is_raw else deserialize(payload)
            result = handler(self, arg)
        except Exception as e:
            self._reply(msgid, ERROR, method,
                        (f"{type(e).__name__}: {e}", traceback.format_exc()))
            return
        if asyncio.iscoroutine(result) or isinstance(result, Awaitable):
            asyncio.ensure_future(self._finish_request(msgid, method, result))
            return
        self._reply_result(msgid, method, result)

    async def _finish_request(self, msgid: int, method: str, awaitable):
        result = None
        try:
            try:
                result = await awaitable
            except Exception as e:
                self._reply(msgid, ERROR, method,
                            (f"{type(e).__name__}: {e}",
                             traceback.format_exc()))
                return
            self._reply_result(msgid, method, result)
            await self._maybe_drain()
        finally:
            # after writelines the transport owns the bytes (pre-3.12 it
            # joins; on 3.12+ _frames materialized the view — see
            # _WRITELINES_JOINS); release the handler's mapping pin on
            # every exit path, including chaos drops and encode errors
            if isinstance(result, RawView):
                result.done()

    def _reply_result(self, msgid: int, method: str, result):
        try:
            try:
                if self._chaos.should_drop():
                    return  # drop the reply: client sees a timeout
                self._reply(msgid, RESPONSE, method, result)
            except Exception as e:
                self._reply(msgid, ERROR, method,
                            (f"{type(e).__name__}: {e}",
                             traceback.format_exc()))
        finally:
            if isinstance(result, RawView):
                result.done()

    def _reply(self, msgid: int, kind: int, method: str, value):
        if self.closed:
            return
        try:
            self._send_frames(_frames(msgid, kind, method, value))
        except (ConnectionError, OSError):
            pass

    async def call(self, method: str, arg: Any = None, timeout: float | None = None) -> Any:
        if self.closed:
            raise ConnectionLost("connection closed")
        if timeout is None:
            timeout = get_config().rpc_request_timeout_s
        loop = asyncio.get_running_loop()
        msgid = next(self._msgid)
        fut: asyncio.Future = loop.create_future()
        self._pending[msgid] = fut
        if self._chaos.should_drop():
            pass  # drop the request on the floor: client sees a timeout
        else:
            self._send_frames(_frames(msgid, REQUEST, method, arg))
            await self._maybe_drain()
        # timeout via a plain timer handle on the reply future — cheaper
        # than asyncio.wait_for's wrapper coroutine + waiter future per
        # RPC (this is every control-plane round-trip's hot path)
        timer = loop.call_later(timeout, self._expire_call, msgid, method,
                                timeout)
        try:
            return await fut
        except asyncio.CancelledError:
            self._pending.pop(msgid, None)
            raise
        finally:
            timer.cancel()

    def _expire_call(self, msgid: int, method: str, timeout: float):
        fut = self._pending.pop(msgid, None)
        if fut is not None and not fut.done():
            fut.set_exception(RpcError(
                f"rpc {method!r} timed out after {timeout}s"))

    async def notify(self, method: str, arg: Any = None):
        """One-way message (used for pubsub pushes and fire-and-forget)."""
        if self.closed:
            raise ConnectionLost("connection closed")
        self._send_frames(_frames(0, NOTIFY, method, arg))
        await self._maybe_drain()

    def on_notify(self, method: str, handler: Callable[[Any], None]):
        self._notify_handlers[method] = handler

    async def close(self):
        if not self.close_reason:
            self.close_reason = "closed by:" + "|".join(
                f"{f.name}@{f.filename.rsplit('/', 1)[-1]}:{f.lineno}"
                for f in traceback.extract_stack(limit=6)[:-1])
        if self._read_task is not None:
            self._read_task.cancel()
        self._teardown()

    async def wait_closed(self):
        await self._closed.wait()


class RpcServer:
    """Serves a handler table. Handlers: ``(conn, arg) -> result | awaitable``."""

    def __init__(self, handlers: dict[str, Callable] | None = None):
        self.handlers: dict[str, Callable] = dict(handlers or {})
        self.connections: set[Connection] = set()
        self._server: asyncio.AbstractServer | None = None
        self.port: int | None = None

    def add_handler(self, method: str, fn: Callable):
        self.handlers[method] = fn

    def add_service(self, obj: Any, prefix: str = ""):
        """Register every ``rpc_*`` method of obj as ``<prefix><name>``."""
        for name in dir(obj):
            if name.startswith("rpc_"):
                self.handlers[prefix + name[4:]] = getattr(obj, name)

    async def _on_client(self, reader, writer):
        conn = Connection(reader, writer)
        conn.server_handlers = self.handlers
        conn.on_close.append(lambda c: self.connections.discard(c))
        self.connections.add(conn)
        conn.start()

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(
            self._on_client, host, port, limit=STREAM_LIMIT)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self):
        for conn in list(self.connections):
            await conn.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()


async def connect(
    host: str, port: int, *, handlers: dict[str, Callable] | None = None,
    retries: int | None = None,
) -> Connection:
    """Dial a peer with retry/backoff (ref analog: retryable_grpc_client)."""
    cfg = get_config()
    if retries is None:
        retries = cfg.rpc_max_retries
    delay = cfg.rpc_retry_delay_s
    last: Exception | None = None
    for _ in range(retries + 1):
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, port, limit=STREAM_LIMIT),
                cfg.rpc_connect_timeout_s)
            conn = Connection(reader, writer)
            if handlers is not None:
                conn.server_handlers = handlers
            conn.start()
            return conn
        except (ConnectionError, OSError, asyncio.TimeoutError) as e:
            last = e
            await asyncio.sleep(delay)
            delay = min(delay * 2, 2.0)
    raise ConnectionLost(f"could not connect to {host}:{port}: {last}")


def log_loop_exceptions(loop: asyncio.AbstractEventLoop) -> None:
    """Log what the loop's callbacks and tasks raise uncaught with this
    process's pid (asyncio's default handler names no process: a stale
    selector key then cannot be placed between a worker and the head)."""
    def handler(loop, context):
        exc = context.get("exception")
        logger.error("event loop error in pid %d: %s (%r)", os.getpid(),
                     context.get("message"),
                     context.get("handle") or context.get("future")
                     or context.get("task"), exc_info=exc)

    loop.set_exception_handler(handler)


class EventLoopThread:
    """A dedicated asyncio loop on a daemon thread.

    The driver and workers are synchronous Python; all their RPC runs on
    this loop (ref analog: the C++ io_service threads under core_worker).
    """

    def __init__(self, name: str = "rayt-io"):
        self.loop = asyncio.new_event_loop()
        log_loop_exceptions(self.loop)
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def run(self, coro, timeout: float | None = None):
        """Run a coroutine on the loop from a foreign thread, blocking."""
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def spawn(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def stop(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=5)
