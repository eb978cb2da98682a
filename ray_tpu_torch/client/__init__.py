"""Remote-driver client (ref analog: python/ray/util/client/ — the
"ray://" proxy API). A process on ANY host connects to the cluster's
client proxy and gets the task/actor/object API without a local node
manager or shared-memory store; the proxy executes operations as the
owning driver.

    from ray_tpu_torch import client

    ctx = client.connect("head-host:10001")

    @ctx.remote
    def f(x):
        return x * 2

    ctx.get(f.remote(21))  # 42

The client is dependency-light: it needs only the RPC framing and
cloudpickle — no torch, no cluster runtime — so thin CLI boxes and
notebooks can drive GPU clusters.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from ray_tpu_torch.client.server import _ClientRefMarker


class ClientObjectRef:
    def __init__(self, ctx: "ClientContext", ref_id: str):
        self._ctx = ctx
        self._id = ref_id

    def __repr__(self):
        return f"ClientObjectRef({self._id[:12]})"

    def __del__(self):
        try:
            self._ctx._release(self._id)
        except Exception:
            pass


class ClientRemoteFunction:
    def __init__(self, ctx: "ClientContext", fn, options: dict):
        self._ctx = ctx
        self._fn = fn
        self._options = options

    def options(self, **opts) -> "ClientRemoteFunction":
        return ClientRemoteFunction(self._ctx, self._fn,
                                    {**self._options, **opts})

    def remote(self, *args, **kwargs) -> ClientObjectRef:
        import cloudpickle

        rid = self._ctx._call("client_task", (
            cloudpickle.dumps(self._fn),
            self._ctx._encode_args(args),
            self._ctx._encode_args(kwargs),
            self._options))
        return ClientObjectRef(self._ctx, rid)


class ClientActorMethod:
    def __init__(self, ctx, actor_id: str, name: str):
        self._ctx = ctx
        self._actor_id = actor_id
        self._name = name

    def remote(self, *args, **kwargs) -> ClientObjectRef:
        rid = self._ctx._call("client_actor_call", (
            self._actor_id, self._name,
            self._ctx._encode_args(args),
            self._ctx._encode_args(kwargs)))
        return ClientObjectRef(self._ctx, rid)


class ClientActorHandle:
    def __init__(self, ctx, actor_id: str):
        self._ctx = ctx
        self._actor_id = actor_id

    def __getattr__(self, name: str) -> ClientActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ClientActorMethod(self._ctx, self._actor_id, name)


class ClientActorClass:
    def __init__(self, ctx, cls, options: dict):
        self._ctx = ctx
        self._cls = cls
        self._options = options

    def options(self, **opts) -> "ClientActorClass":
        return ClientActorClass(self._ctx, self._cls,
                                {**self._options, **opts})

    def remote(self, *args, **kwargs) -> ClientActorHandle:
        import cloudpickle

        aid = self._ctx._call("client_actor_create", (
            cloudpickle.dumps(self._cls),
            self._ctx._encode_args(args),
            self._ctx._encode_args(kwargs),
            self._options))
        return ClientActorHandle(self._ctx, aid)


class ClientContext:
    """The remote-driver API surface (mirrors the top-level rt API)."""

    def __init__(self, host: str, port: int):
        from ray_tpu_torch._internal.rpc import connect

        self._io = _LoopThread()
        self._conn = self._io.run(connect(host, port))
        assert self._call("client_ping") is True

    # ---------------------------------------------------------- plumbing
    def _call(self, method: str, arg: Any = None, timeout: float = 300.0):
        return self._io.run(self._conn.call(method, arg, timeout=timeout))

    def _encode_args(self, args):
        # recursive: refs nested in containers must become markers too —
        # pickling a ClientObjectRef would drag the context's event-loop
        # thread into the payload
        def enc(a):
            if isinstance(a, ClientObjectRef):
                return _ClientRefMarker(a._id)
            if isinstance(a, dict):
                return {k: enc(v) for k, v in a.items()}
            if isinstance(a, (list, tuple)):
                out = [enc(v) for v in a]
                return tuple(out) if isinstance(a, tuple) else out
            return a

        if isinstance(args, dict):
            return {k: enc(v) for k, v in args.items()}
        return [enc(a) for a in args]

    def _release(self, ref_id: str):
        if not self._io.closed:
            self._io.run_nowait(
                self._conn.call("client_release", [ref_id], timeout=30))

    # --------------------------------------------------------------- api
    def remote(self, *args, **kwargs):
        def wrap(target, options):
            if isinstance(target, type):
                return ClientActorClass(self, target, options)
            return ClientRemoteFunction(self, target, options)

        if len(args) == 1 and not kwargs and callable(args[0]):
            return wrap(args[0], {})
        return lambda target: wrap(target, kwargs)

    def put(self, value: Any) -> ClientObjectRef:
        import cloudpickle

        rid = self._call("client_put", cloudpickle.dumps(value))
        return ClientObjectRef(self, rid)

    def get(self, refs, timeout: Optional[float] = None):
        import cloudpickle

        single = isinstance(refs, ClientObjectRef)
        ids = [refs._id] if single else [r._id for r in refs]
        # indefinite waits poll in BOUNDED wire calls: one long-lived RPC
        # would trip the transport timeout (and strand a proxy executor
        # thread) on any task slower than the wire budget
        ready = self._poll_until(ids, len(ids), timeout)
        if len(ready) < len(ids):
            raise TimeoutError(
                f"get timed out after {timeout}s "
                f"({len(ready)}/{len(ids)} ready)")
        blobs = self._call("client_get", (ids, 30.0), timeout=60)
        values = [cloudpickle.loads(b) for b in blobs]
        return values[0] if single else values

    def _poll_until(self, ids, num_returns: int,
                    timeout: Optional[float]):
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            step = 25.0 if deadline is None else max(
                0.0, min(25.0, deadline - _time.monotonic()))
            ready, _ = self._call("client_wait", (ids, num_returns, step),
                                  timeout=step + 35)
            if len(ready) >= num_returns:
                return ready
            if deadline is not None and _time.monotonic() >= deadline:
                return ready

    def wait(self, refs, *, num_returns: int = 1,
             timeout: Optional[float] = None):
        by_id = {r._id: r for r in refs}
        ready = self._poll_until([r._id for r in refs], num_returns,
                                 timeout)
        ready_set = set(ready)
        return ([by_id[i] for i in ready],
                [r for r in refs if r._id not in ready_set])

    def kill(self, actor: ClientActorHandle):
        return self._call("client_actor_kill", actor._actor_id)

    def disconnect(self):
        self._io.close()


class _LoopThread:
    """Private asyncio loop on a daemon thread for the sync client API."""

    def __init__(self):
        import asyncio

        self._loop = asyncio.new_event_loop()
        self.closed = False
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="rayt-client-io",
            daemon=True)
        self._thread.start()

    def run(self, coro):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self._loop).result()

    def run_nowait(self, coro):
        import asyncio

        asyncio.run_coroutine_threadsafe(coro, self._loop)

    def close(self):
        self.closed = True
        self._loop.call_soon_threadsafe(self._loop.stop)


def connect(address: str) -> ClientContext:
    """Connect to a cluster's client proxy ("host:port" or
    "rayt://host:port")."""
    address = address.replace("rayt://", "")
    host, _, port = address.partition(":")
    return ClientContext(host, int(port or 10001))
