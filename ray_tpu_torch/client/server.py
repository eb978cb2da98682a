"""Client proxy server — the remote-driver ingress (ref analog:
python/ray/util/client/server/ — the gRPC proxy that executes API calls
on behalf of drivers that have no local raylet/object store).

The proxy is itself a driver attached to the cluster: it owns the
ObjectRefs produced by client operations (clients hold opaque ids scoped
to their session) and executes put/get/task/actor calls through its core
worker. Blocking cluster calls run in executor threads so one slow
`get` can't stall the proxy's accept loop.

Run: `python -m ray_tpu_torch.scripts.cli client-server --address <gcs>`.
"""

from __future__ import annotations

import asyncio
from typing import Any

from ray_tpu_torch._internal.logging_utils import setup_logger
from ray_tpu_torch._internal.rpc import RpcServer

logger = setup_logger("client_proxy")


class _ClientRefMarker:
    """Wire form of a client-held ref inside task/actor args."""

    def __init__(self, ref_id: str):
        self.ref_id = ref_id


class ClientProxyService:
    def __init__(self):
        self._refs: dict[str, Any] = {}     # id -> ObjectRef
        self._actors: dict[str, Any] = {}   # id -> ActorHandle

    # ------------------------------------------------------------- helpers
    def _track(self, ref) -> str:
        rid = ref.id.hex()
        self._refs[rid] = ref
        return rid

    def _resolve_args(self, args):
        import ray_tpu_torch as rt  # noqa: F401  (runtime must be initialized)

        def sub(a):
            if isinstance(a, _ClientRefMarker):
                return self._refs[a.ref_id]
            if isinstance(a, dict):
                return {k: sub(v) for k, v in a.items()}
            if isinstance(a, (list, tuple)):
                out = [sub(v) for v in a]
                return tuple(out) if isinstance(a, tuple) else out
            return a

        if isinstance(args, dict):
            return {k: sub(v) for k, v in args.items()}
        return [sub(a) for a in args]

    @staticmethod
    async def _blocking(fn, *args, **kwargs):
        return await asyncio.get_running_loop().run_in_executor(
            None, lambda: fn(*args, **kwargs))

    # ------------------------------------------------------------ handlers
    async def rpc_client_put(self, conn, blob: bytes) -> str:
        import cloudpickle

        import ray_tpu_torch as rt

        value = cloudpickle.loads(blob)
        ref = await self._blocking(rt.put, value)
        return self._track(ref)

    async def rpc_client_get(self, conn, arg):
        import cloudpickle

        ref_ids, timeout = arg
        refs = [self._refs[r] for r in ref_ids]
        import ray_tpu_torch as rt

        values = await self._blocking(rt.get, refs, timeout=timeout)
        return [cloudpickle.dumps(v) for v in values]

    async def rpc_client_task(self, conn, arg) -> str:
        import cloudpickle

        import ray_tpu_torch as rt

        fn_blob, args, kwargs, options = arg
        fn = cloudpickle.loads(fn_blob)
        remote_fn = rt.remote(**options)(fn) if options else rt.remote(fn)
        ref = await self._blocking(
            lambda: remote_fn.remote(*self._resolve_args(args),
                                     **self._resolve_args(kwargs)))
        return self._track(ref)

    async def rpc_client_actor_create(self, conn, arg) -> str:
        import cloudpickle

        import ray_tpu_torch as rt

        cls_blob, args, kwargs, options = arg
        cls = cloudpickle.loads(cls_blob)
        actor_cls = rt.remote(**options)(cls) if options else rt.remote(cls)
        handle = await self._blocking(
            lambda: actor_cls.remote(*self._resolve_args(args),
                                     **self._resolve_args(kwargs)))
        aid = handle._actor_id.hex()
        self._actors[aid] = handle
        return aid

    async def rpc_client_actor_call(self, conn, arg) -> str:
        actor_id, method, args, kwargs = arg
        handle = self._actors[actor_id]
        ref = await self._blocking(
            lambda: getattr(handle, method).remote(
                *self._resolve_args(args), **self._resolve_args(kwargs)))
        return self._track(ref)

    async def rpc_client_actor_kill(self, conn, actor_id: str) -> bool:
        import ray_tpu_torch as rt

        handle = self._actors.pop(actor_id, None)
        if handle is None:
            return False
        await self._blocking(rt.kill, handle)
        return True

    async def rpc_client_wait(self, conn, arg):
        import ray_tpu_torch as rt

        ref_ids, num_returns, timeout = arg
        refs = [self._refs[r] for r in ref_ids]
        ready, rest = await self._blocking(
            rt.wait, refs, num_returns=num_returns, timeout=timeout)
        return ([r.id.hex() for r in ready], [r.id.hex() for r in rest])

    async def rpc_client_release(self, conn, ref_ids) -> bool:
        """Client-side ref went out of scope: drop the proxy's handle so
        the owner can reclaim the object."""
        for r in ref_ids:
            self._refs.pop(r, None)
        return True

    def rpc_client_ping(self, conn, arg=None) -> bool:
        return True


async def _serve(host: str, port: int, gcs_address: str) -> None:
    server = RpcServer()
    server.add_service(ClientProxyService())
    bound = await server.start(host, port)
    print(f'{{"client_port": {bound}}}', flush=True)
    logger.info("client proxy listening on %s:%s (cluster %s)",
                host, bound, gcs_address)
    await asyncio.Event().wait()   # run forever


def main(gcs_address: str, port: int = 10001, host: str = "0.0.0.0"):
    import ray_tpu_torch as rt

    # attach as a driver BEFORE starting the proxy loop (init drives its
    # own short-lived asyncio loops internally)
    rt.init(address=gcs_address)
    asyncio.run(_serve(host, port, gcs_address))
