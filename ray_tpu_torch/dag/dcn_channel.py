"""Cross-node DCN ring channels for compiled DAGs.

Ref analog: the reference's compiled-graph cross-node channels
(python/ray/experimental/channel/ — a shm ring on the reader's node fed
by the object transport). Here the channel is a peer-to-peer stream over
the EXISTING RPC plane: every worker (and the driver) already runs an
``RpcServer`` (core_worker.py `_async_connect`), so the consumer side
registers a sink under a token on its server and the producer dials it
once at attach time — a persistent connection, no per-tick control
plane.

Per-tick cost mirrors the shm ring's contract at DCN distance:

* items travel as NOTIFY frames; payloads the producer pre-serializes on
  its tick thread ride the RPC plane's scatter-gather framing verbatim
  (``rpc.Serialized`` — each pickle-5 buffer reaches the transport as
  its own buffer, one join in the transport), and the consumer
  deserializes over the received contiguous buffer, so large numpy
  payloads alias the receive buffer instead of bouncing through an
  extra copy (bytes are immutable and refcounted — no pin rule needed
  on this side).
* flow control is credit-based, mirroring the ring's ``n_slots``: the
  producer starts with ``n_slots`` credits, each write consumes one,
  and the consumer returns a credit as each item is read — so at most
  ``n_slots`` ticks buffer between the stages, the same pipelining
  window a shm ring gives (GPipe-style microbatch overlap), and a slow
  consumer backpressures the producer instead of ballooning memory.
* close is symmetric: either side closing surfaces ``ChannelClosed`` on
  the peer's next read/write, including while blocked on a full (no
  credits) or empty (no items) channel — same semantics the shm ring's
  ``closed`` header byte provides.

Wire methods (all on the consumer's existing RpcServer / connection):
``dcn_open`` (handshake REQUEST, returns the credit window) and the
per-token ``dcn.item.<t>`` / ``dcn.credit.<t>`` / ``dcn.close.<t>``
NOTIFY frames.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import deque
from dataclasses import dataclass

from ray_tpu_torch._internal.rpc import RpcError, Serialized, connect
from ray_tpu_torch._internal.serialization import serialize, serialized_size
from ray_tpu_torch.dag.channel import ChannelClosed, ChannelStats


@dataclass(frozen=True)
class DcnChannelSpec:
    """Serializable descriptor shipped inside DAG schedules. The holder
    whose process registered ``token`` attaches as the consumer; every
    other attacher dials (host, port) and becomes the producer."""
    token: str
    host: str
    port: int
    n_slots: int
    slot_size: int   # advisory (compile-time buffer_size_bytes)


# process-global endpoint registry: token -> _DcnSink (consumer side)
_registry_lock = threading.Lock()
_sinks: dict[str, "_DcnSink"] = {}


def _core_worker():
    from ray_tpu_torch.core.object_ref import get_core_worker

    cw = get_core_worker()
    if cw is None:
        from ray_tpu_torch.api import _core_worker as api_cw

        cw = api_cw()
    if cw is None:
        raise RuntimeError("DCN channels need an initialized ray_tpu_torch "
                           "worker or driver (rt.init first)")
    return cw


def _rpc_dcn_open(conn, token: str) -> int:
    """Handshake handler on the consumer's RpcServer: bind the producer's
    connection to the token's sink and grant the initial credit window."""
    with _registry_lock:
        sink = _sinks.get(token)
    if sink is None:
        raise RpcError(f"unknown dcn channel {token!r}")
    sink.bind(conn)
    return sink.n_slots


def ensure_dcn_service(cw) -> None:
    """Idempotently register the handshake handler on this process's
    existing RpcServer (the wire path workers already serve leases and
    object transfer on)."""
    if "dcn_open" not in cw.server.handlers:
        cw.server.add_handler("dcn_open", _rpc_dcn_open)


class _DcnSink:
    """Consumer-side endpoint: receives items on the IO loop, hands them
    to the (blocking) DAG loop thread, returns credits as items drain."""

    def __init__(self, token: str, n_slots: int, loop):
        self.token = token
        self.n_slots = n_slots
        self._loop = loop
        self._items: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._conn = None
        self.stats = ChannelStats()

    # ------------------------------------------------ IO-loop callbacks
    def bind(self, conn):
        self._conn = conn
        conn.on_notify(f"dcn.item.{self.token}", self._on_item)
        conn.on_notify(f"dcn.close.{self.token}", self._on_close)
        conn.on_close.append(lambda _c: self._on_close())

    def _on_item(self, value):
        with self._cv:
            self._items.append(value)
            self._cv.notify_all()

    def _on_close(self, _arg=None):
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    # ------------------------------------------- consumer-thread side
    def read(self, timeout: float | None):
        deadline = None if timeout is None else time.monotonic() + timeout
        st = self.stats
        with self._cv:
            while not self._items:
                if self._closed:
                    st.end_read_block()
                    raise ChannelClosed()
                if st.read_blocked_since is None:
                    st.read_blocked_since = time.monotonic()
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    st.end_read_block()
                    raise TimeoutError("dcn channel read timed out")
                self._cv.wait(timeout=(remaining if remaining is not None
                                       else 1.0))
            st.end_read_block()
            value = self._items.popleft()
        st.reads += 1
        self._grant_credit(1)
        return value

    def _grant_credit(self, n: int):
        conn = self._conn
        if conn is None or conn.closed:
            return
        try:
            asyncio.run_coroutine_threadsafe(
                conn.notify(f"dcn.credit.{self.token}", n), self._loop)
        except RuntimeError:
            pass  # loop shut down mid-teardown

    def close(self):
        with _registry_lock:
            _sinks.pop(self.token, None)
        conn = self._conn
        if conn is not None and not conn.closed:
            try:
                asyncio.run_coroutine_threadsafe(conn.close(), self._loop)
            except RuntimeError:
                pass
        self._on_close()


class DcnConsumerChannel:
    """Read side of a DCN channel (the endpoint owner)."""

    def __init__(self, sink: _DcnSink, spec: DcnChannelSpec):
        self._sink = sink
        self.spec = spec
        self._closed = False

    def read(self, timeout: float | None = None):
        return self._sink.read(timeout)

    def write(self, value, timeout: float | None = None):
        raise RuntimeError("consumer side of a DCN channel cannot write")

    # ---------------------------------------------------- observability
    @property
    def stats(self) -> ChannelStats:
        return self._sink.stats

    def occupancy(self) -> int:
        return len(self._sink._items)

    def cursor_state(self) -> tuple[int, int]:
        """(items consumed, items received) — the DCN twin of the shm
        ring's (read cursor, write seq) for the _get_tick timeout error."""
        st = self._sink.stats
        return st.reads, st.reads + len(self._sink._items)

    def snapshot(self) -> dict:
        snap = self._sink.stats.snapshot()
        snap["occupancy"] = self.occupancy()
        snap["pinned_slots"] = 0
        snap["n_slots"] = self.spec.n_slots
        return snap

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._sink.close()


class DcnProducerChannel:
    """Write side: dials the consumer's RpcServer once, then streams
    NOTIFY frames under the credit window."""

    def __init__(self, spec: DcnChannelSpec, cw=None):
        cw = cw or _core_worker()
        self.spec = spec
        self._io = cw.io
        self._credits = threading.Semaphore(0)
        # mirror of the semaphore for snapshots; += / -= are LOAD/ADD/
        # STORE sequences hit from two threads (tick thread vs IO-loop
        # credit grants), so the mirror mutates under its own lock — a
        # lost update would skew the credits/occupancy diagnostics
        # permanently, not transiently
        self._credit_avail = 0
        self._credit_lock = threading.Lock()
        self._closed = threading.Event()
        self._item_method = f"dcn.item.{spec.token}"
        self.stats = ChannelStats()
        self._conn = self._io.run(self._open(spec), timeout=60.0)

    async def _open(self, spec: DcnChannelSpec):
        conn = await connect(spec.host, spec.port)
        conn.on_notify(f"dcn.credit.{spec.token}", self._on_credit)
        conn.on_close.append(lambda _c: self._closed.set())
        window = await conn.call("dcn_open", spec.token, timeout=30.0)
        for _ in range(int(window)):
            self._credits.release()
        with self._credit_lock:
            self._credit_avail += int(window)
        return conn

    def _on_credit(self, n):
        for _ in range(int(n)):
            self._credits.release()
        with self._credit_lock:
            self._credit_avail += int(n)

    def write(self, value, timeout: float | None = None):
        self.write_chunks(serialize(value), timeout=timeout)

    def write_chunks(self, chunks: list, total: int | None = None,
                     timeout: float | None = None):
        """Send one pre-serialized item. Fire-and-forget onto the IO
        loop (FIFO per thread); the credit window paces the producer, so
        at most n_slots items are ever in flight past the consumer's
        reads. The chunk buffers are handed to the transport
        asynchronously — treat written values as frozen."""
        deadline = None if timeout is None else time.monotonic() + timeout
        st = self.stats
        while not self._credits.acquire(timeout=0.2):
            if self._closed.is_set():
                st.end_write_block()
                raise ChannelClosed()
            if st.write_blocked_since is None:
                st.write_blocked_since = time.monotonic()
            if deadline is not None and time.monotonic() > deadline:
                st.end_write_block()
                raise TimeoutError(
                    "dcn channel write timed out (no credits: consumer "
                    "is >n_slots ticks behind)")
        st.end_write_block()
        with self._credit_lock:
            self._credit_avail -= 1
        conn = self._conn
        if conn is None or self._closed.is_set():
            raise ChannelClosed()
        payload = Serialized(chunks)
        try:
            fut = asyncio.run_coroutine_threadsafe(
                conn.notify(self._item_method, payload),
                self._io.loop)
            # fire-and-forget: a send on a concurrently-dying connection
            # surfaces via on_close -> ChannelClosed on the NEXT write;
            # consume the future's exception so it never logs unobserved
            fut.add_done_callback(lambda f: f.exception())
        except RuntimeError:
            self._closed.set()
            raise ChannelClosed()
        # count AFTER the frame reached the transport: the ChannelClosed
        # path above must not report a phantom tick to the dag manager
        st.writes += 1
        st.bytes_written += (serialized_size(chunks)
                             if total is None else total)

    def read(self, timeout: float | None = None):
        raise RuntimeError("producer side of a DCN channel cannot read")

    # ---------------------------------------------------- observability
    def occupancy(self) -> int:
        """In-flight items past the consumer's reads = window consumed."""
        return max(0, self.spec.n_slots - self._credit_avail)

    def cursor_state(self) -> tuple[int, int]:
        return self.stats.writes, self.stats.writes

    def snapshot(self) -> dict:
        snap = self.stats.snapshot()
        snap["occupancy"] = self.occupancy()
        snap["pinned_slots"] = 0
        snap["n_slots"] = self.spec.n_slots
        snap["credits"] = self._credit_avail
        return snap

    def close(self):
        conn = self._conn
        if conn is None:
            return  # idempotent
        self._conn = None

        async def _shut():
            try:
                if not conn.closed:
                    await conn.notify(f"dcn.close.{self.spec.token}")
                    await conn.close()
            except Exception:
                pass

        try:
            self._io.run(_shut(), timeout=10.0)
        except Exception:
            pass
        self._closed.set()


def create_endpoint(token: str, n_slots: int, slot_size: int,
                    cw=None) -> DcnConsumerChannel:
    """Create the consumer-side endpoint in THIS process, listening on
    the process's existing RpcServer."""
    cw = cw or _core_worker()
    ensure_dcn_service(cw)
    sink = _DcnSink(token, n_slots, cw.io.loop)
    with _registry_lock:
        _sinks[token] = sink
    addr = cw.worker_info.address
    spec = DcnChannelSpec(token=token, host=addr.host, port=addr.port,
                          n_slots=n_slots, slot_size=slot_size)
    return DcnConsumerChannel(sink, spec)


def attach_channel(spec):
    """Attach any channel flavor from its serializable spec: device
    specs wrap their inner transport in the tensor framing; the
    process that registered a DCN token gets the consumer side, any
    other process the producer side; shm specs attach as before."""
    from ray_tpu_torch.dag.device_channel import DeviceChannelSpec, attach_device

    if isinstance(spec, DeviceChannelSpec):
        return attach_device(spec)
    if isinstance(spec, DcnChannelSpec):
        with _registry_lock:
            sink = _sinks.get(spec.token)
        if sink is not None:
            return DcnConsumerChannel(sink, spec)
        return DcnProducerChannel(spec)
    from ray_tpu_torch.dag.channel import ShmChannel

    return ShmChannel.attach(spec)


def _dcn_create_endpoints(self, reqs: list[tuple[str, int, int]]) -> list:
    """Runs on a consumer ACTOR via ``__rayt_apply__`` at compile time:
    create one endpoint per (token, n_slots, slot_size) request on this
    worker's RpcServer and return the dialable specs."""
    return [create_endpoint(token, n_slots, slot_size).spec
            for (token, n_slots, slot_size) in reqs]
