"""TCP collective store: rank-0-hosted rendezvous/reduction server plus
per-rank peer servers for p2p send/recv.

Ref analog: the reference's Gloo CPU collective group
(python/ray/util/collective/collective_group/gloo_collective_group.py) and
the TCPStore rendezvous used by torch process groups
(train/torch/config.py:115). The *device* data plane is the
torch.distributed collectives inside the mesh (``ray_tpu_torch.parallel``);
this store is the host-side control/data plane — small arrays, rendezvous payloads (the
NCCLUniqueId analog), barriers between workers. A copy of
ray_tpu/util/collective/store.py.

Protocol: one TCP connection per operation; length-prefixed pickled
(kind, key, rank, payload) request; server replies when the collective
condition is met (all world_size participants arrived).
"""

from __future__ import annotations

import collections
import pickle
import socket
import struct
import threading
from typing import Any, Callable

import numpy as np

_LEN = struct.Struct("!Q")


def send_msg(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=5)
    sock.sendall(_LEN.pack(len(data)) + data)


def recv_msg(sock: socket.socket) -> Any:
    header = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(header)
    return pickle.loads(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed during recv")
        buf.extend(chunk)
    return bytes(buf)


# one op table for every reduction path (star server + peer ring)
REDUCE_UFUNCS: dict[str, Callable] = {
    "sum": np.add, "prod": np.multiply,
    "min": np.minimum, "max": np.maximum,
}

REDUCE_OPS: dict[str, Callable] = {
    name: (lambda parts, _u=ufunc: _tree_reduce(_u, parts))
    for name, ufunc in REDUCE_UFUNCS.items()
}


def _tree_reduce(ufunc, parts: list) -> Any:
    out = parts[0]
    for p in parts[1:]:
        out = ufunc(out, p)
    return out


class _PendingOp:
    __slots__ = ("parts", "cond", "result", "done", "replied")

    def __init__(self):
        self.parts: dict[int, Any] = {}
        self.cond = threading.Condition()
        self.result: Any = None
        self.done = False
        self.replied = 0


class StoreServer:
    """Rank-0-hosted collective server. Thread-per-connection; operations
    rendezvous on a key (op kind + name + per-group sequence number)."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._ops: dict[str, _PendingOp] = {}
        self._lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", 0))
        self._sock.listen(256)
        self.port = self._sock.getsockname()[1]
        self._closed = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="collective-store", daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _get_op(self, key: str) -> _PendingOp:
        with self._lock:
            op = self._ops.get(key)
            if op is None:
                op = self._ops[key] = _PendingOp()
            return op

    def _finish_reply(self, key: str, op: _PendingOp):
        with op.cond:
            op.replied += 1
            if op.replied >= self.world_size:
                with self._lock:
                    self._ops.pop(key, None)

    def _handle(self, conn: socket.socket):
        try:
            kind, key, rank, payload = recv_msg(conn)
            op = self._get_op(key)
            with op.cond:
                op.parts[rank] = payload
                if len(op.parts) >= self.world_size:
                    op.result = self._compute(kind, op.parts)
                    op.done = True
                    op.cond.notify_all()
                else:
                    op.cond.wait_for(lambda: op.done or self._closed)
                if not op.done:
                    return      # closed before every rank arrived
                # a computed result is always delivered: rank 0 may close
                # the store the moment its own reply lands (a one-shot
                # group's destroy), before this thread has woken to reply
                reply = self._result_for(kind, rank, op.result)
            send_msg(conn, reply)
            self._finish_reply(key, op)
        except (ConnectionError, OSError, EOFError):
            pass
        finally:
            conn.close()

    def _compute(self, kind: str, parts: dict[int, Any]) -> Any:
        ordered = [parts[r] for r in sorted(parts)]
        if kind == "barrier":
            return True
        if kind == "gather":  # allgather
            return ordered
        if kind.startswith(("allreduce:", "reducescatter:")):
            return REDUCE_OPS[kind.split(":", 1)[1]](
                [p for p in ordered if p is not None])
        if kind == "bcast":
            for p in ordered:
                if p is not None:
                    return p
            raise ValueError("broadcast: no root payload")
        raise ValueError(f"unknown collective kind {kind!r}")

    def _result_for(self, kind: str, rank: int, result: Any) -> Any:
        if kind.startswith("reducescatter:"):
            return np.array_split(result, self.world_size, axis=0)[rank]
        return result

    def close(self):
        self._closed = True
        with self._lock:
            ops = list(self._ops.values())
        for op in ops:
            with op.cond:
                op.cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass


def store_call(addr: tuple[str, int], kind: str, key: str, rank: int,
               payload: Any, timeout: float = 120.0) -> Any:
    sock = socket.create_connection(addr, timeout=timeout)
    try:
        sock.settimeout(timeout)
        send_msg(sock, (kind, key, rank, payload))
        return recv_msg(sock)
    finally:
        sock.close()


class PeerServer:
    """Per-rank inbox for point-to-point send/recv, tagged by (src, tag).
    Messages queue per key: back-to-back sends with the same tag are
    delivered in order, never overwritten."""

    def __init__(self):
        self._inbox: dict[tuple[int, int], collections.deque] = {}
        self._cond = threading.Condition()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", 0))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._closed = False
        threading.Thread(target=self._accept_loop, name="collective-peer",
                         daemon=True).start()

    def _accept_loop(self):
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket):
        try:
            src, tag, payload = recv_msg(conn)
            with self._cond:
                self._inbox.setdefault(
                    (src, tag), collections.deque()).append(payload)
                self._cond.notify_all()
            send_msg(conn, True)
        except (ConnectionError, OSError, EOFError):
            pass
        finally:
            conn.close()

    def recv(self, src: int, tag: int, timeout: float = 120.0) -> Any:
        key = (src, tag)
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._inbox.get(key) or self._closed, timeout)
            if not ok:
                raise TimeoutError(f"recv from rank {src} tag {tag} timed out")
            if self._closed:
                raise ConnectionError("peer server closed")
            q = self._inbox[key]
            payload = q.popleft()
            if not q:
                del self._inbox[key]
            return payload

    def close(self):
        self._closed = True
        with self._cond:
            self._cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass


def peer_send(addr: tuple[str, int], src: int, tag: int, payload: Any,
              timeout: float = 120.0) -> None:
    sock = socket.create_connection(addr, timeout=timeout)
    try:
        sock.settimeout(timeout)
        send_msg(sock, (src, tag, payload))
        recv_msg(sock)  # ack
    finally:
        sock.close()
