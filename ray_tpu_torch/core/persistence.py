"""GCS snapshot persistence backends (ref analog:
src/ray/gcs/store_client/ — in_memory_store_client vs
redis_store_client.h:107).

The reference achieves head HA by backing GCS tables with an EXTERNAL
Redis so a restarted head (anywhere) rebuilds its view. The TPU-native
analog keeps the same split without a Redis dependency: a
`SnapshotBackend` port with two adapters —

* :class:`FileSnapshotBackend` — local file + content-addressed blob
  dir (the existing single-box layout, byte-compatible with old
  snapshots);
* :class:`RemoteSnapshotBackend` — blocking bridge to a standalone
  :class:`SnapshotStoreServer` process reachable over the cluster RPC
  substrate (`rayt://host:port`), which survives head death so the head
  can restart on a DIFFERENT machine and reload.

Select by address: `gcs_persist_path = "/path/snap.pkl"` or
`"rayt://10.0.0.5:6410"`. The store server runs via
`python -m ray_tpu_torch.core.store_main --dir /data/gcs --port 6410`.
"""

from __future__ import annotations

import os
from typing import Optional

from ray_tpu_torch._internal.logging_utils import setup_logger

logger = setup_logger("persistence")

REMOTE_SCHEME = "rayt://"


class SnapshotBackend:
    def put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def put_if_absent(self, key: str, value: bytes) -> None:
        if not self.exists(key):
            self.put(key, value)

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        pass


def _safe_name(key: str) -> str:
    # keys are "snapshot" or "blobs/<sha256>"; no traversal allowed
    name = key.replace("/", "_")
    if name != os.path.basename(name) or name.startswith("."):
        raise ValueError(f"bad snapshot key {key!r}")
    return name


class FileSnapshotBackend(SnapshotBackend):
    """Single-box layout: `base` is the snapshot file, blobs live in
    `base + '.blobs/<digest>'` (unchanged from the pre-backend code, so
    existing snapshots keep loading)."""

    def __init__(self, base: str):
        self.base = base

    def _path(self, key: str) -> str:
        if key == "snapshot":
            return self.base
        if key.startswith("blobs/"):
            return os.path.join(self.base + ".blobs", key[len("blobs/"):])
        raise ValueError(f"unknown snapshot key {key!r}")

    def put(self, key: str, value: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(value)
            # fsync BEFORE the rename: os.replace alone is atomic
            # against a process crash but not a host crash — the rename
            # can hit disk before the data, leaving a torn snapshot
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except OSError:
            return None

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))


class RemoteSnapshotBackend(SnapshotBackend):
    """Sync facade over the async RPC client: snapshot IO happens off
    the GCS event loop (executor thread / process start-stop), so each
    call blocks on a private IO loop the way CoreWorker's sync API
    does.

    Store-server restarts are expected (it is a plain process on a
    different box), so every call retries with backoff and redials the
    connection on transport errors. Only after the retry budget is
    exhausted does the error surface — and `failure_listener` (wired by
    the GCS server to a WARNING cluster event) fires so operators learn
    persistence is degraded even though the head keeps running."""

    MAX_ATTEMPTS = 4
    BACKOFF_S = 0.2      # doubles per attempt: 0.2, 0.4, 0.8

    def __init__(self, host: str, port: int, timeout_s: float = 30.0):
        from ray_tpu_torch._internal.rpc import EventLoopThread, connect

        self._host, self._port = host, port
        self._io = EventLoopThread(name="rayt-snap-store")
        self._timeout = timeout_s
        self._conn = self._io.run(connect(host, port), timeout_s)
        # called (exc, method) after the retry budget is exhausted
        self.failure_listener = None

    def _redial(self):
        from ray_tpu_torch._internal.rpc import connect

        try:
            self._io.run(self._conn.close(), 2)
        except Exception:
            pass
        self._conn = self._io.run(connect(self._host, self._port),
                                  self._timeout)

    def _call(self, method: str, arg):
        import time as _time

        delay = self.BACKOFF_S
        last: Exception | None = None
        for attempt in range(self.MAX_ATTEMPTS):
            try:
                if self._conn is None:
                    self._redial()
                return self._io.run(self._conn.call(method, arg),
                                    self._timeout)
            except Exception as e:
                last = e
                self._conn = None   # force a redial next attempt
                if attempt < self.MAX_ATTEMPTS - 1:
                    logger.warning(
                        "snapshot store %s failed (%r), retrying in "
                        "%.1fs (%d/%d)", method, e, delay, attempt + 1,
                        self.MAX_ATTEMPTS)
                    _time.sleep(delay)
                    delay *= 2
        logger.error("snapshot store %s failed after %d attempts: %r",
                     method, self.MAX_ATTEMPTS, last)
        if self.failure_listener is not None:
            try:
                self.failure_listener(last, method)
            except Exception:
                pass
        raise last

    def put(self, key: str, value: bytes) -> None:
        self._call("store_put", (key, value))

    def get(self, key: str) -> Optional[bytes]:
        return self._call("store_get", key)

    def exists(self, key: str) -> bool:
        return bool(self._call("store_exists", key))

    def close(self) -> None:
        try:
            if self._conn is not None:
                self._io.run(self._conn.close(), 5)
        except Exception:
            pass
        self._io.stop()


def make_backend(persist_path: Optional[str]) -> Optional[SnapshotBackend]:
    if not persist_path:
        return None
    if persist_path.startswith(REMOTE_SCHEME):
        hostport = persist_path[len(REMOTE_SCHEME):]
        host, _, port = hostport.partition(":")
        return RemoteSnapshotBackend(host, int(port))
    return FileSnapshotBackend(persist_path)


class SnapshotStoreServer:
    """Standalone durable KV for GCS snapshots — the Redis-role process.
    Values land in `dir` via atomic replace; restart-safe; shared by
    successive head incarnations."""

    def __init__(self, data_dir: str):
        from ray_tpu_torch._internal.rpc import RpcServer

        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self.server = RpcServer()
        self.server.add_service(self)
        self.port: Optional[int] = None

    def _path(self, key: str) -> str:
        return os.path.join(self.data_dir, _safe_name(key))

    def rpc_store_put(self, conn, arg):
        key, value = arg
        path = self._path(key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(bytes(value))
            # durability is this process's whole job: data must be on
            # disk before the rename commits it (host-crash safety)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return True

    def rpc_store_get(self, conn, key):
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except OSError:
            return None

    def rpc_store_exists(self, conn, key):
        return os.path.exists(self._path(key))

    def rpc_store_ping(self, conn, arg=None):
        return True

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self.port = await self.server.start(host, port)
        logger.info("snapshot store listening on %s:%s (dir=%s)",
                    host, self.port, self.data_dir)
        return self.port

    async def stop(self):
        await self.server.stop()
