"""Entry point for the standalone GCS snapshot store (the Redis-role
process in the reference's HA story — ref: redis_store_client.h:107).

    python -m ray_tpu_torch.core.store_main --dir /data/gcs-store --port 6410

Point the head at it with `gcs_persist_path = "rayt://<host>:6410"`
(env: RAYT_GCS_PERSIST_PATH). The store outlives head crashes, so a new
head on any machine reloads the cluster state from it.
"""

from __future__ import annotations

import argparse
import asyncio


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True, help="durable data directory")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=6410)
    args = ap.parse_args()

    from ray_tpu_torch.core.persistence import SnapshotStoreServer

    async def run():
        server = SnapshotStoreServer(args.dir)
        await server.start(args.host, args.port)
        await asyncio.Event().wait()  # serve until killed

    asyncio.run(run())


if __name__ == "__main__":
    main()
