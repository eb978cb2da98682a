"""Worker-node process: one NodeManager joining an existing GCS (ref
analog: `ray start --address=...` spawning a raylet that registers with
the head's GCS — python/ray/scripts/scripts.py `start`, raylet main).

Prints one JSON line {"nm_port", "node_id"} on stdout, then serves until
SIGTERM. Used by cluster_utils.Cluster to stand up in-process multi-node
clusters for tests (ref: python/ray/cluster_utils.py:135).
"""

from __future__ import annotations

import argparse
import asyncio
import json


async def run(args):
    from ray_tpu_torch._internal.ids import NodeID
    from ray_tpu_torch._internal.rpc import log_loop_exceptions
    from ray_tpu_torch.core.common import Address
    from ray_tpu_torch.core.node_manager import NodeManager

    log_loop_exceptions(asyncio.get_running_loop())
    gcs_host, gcs_port = args.gcs_address.split(":")
    resources = json.loads(args.resources)
    labels = json.loads(args.labels)
    nm = NodeManager(
        node_id=NodeID.random(), resources=resources,
        gcs_address=Address(gcs_host, int(gcs_port)),
        labels=labels)
    addr = await nm.start()
    print(json.dumps({"nm_port": addr.port, "node_id": nm.node_id.hex()}),
          flush=True)
    import signal

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass
    try:
        await stop.wait()
    finally:
        await nm.stop()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--gcs-address", type=str, required=True)
    p.add_argument("--resources", type=str, default="{}")
    p.add_argument("--labels", type=str, default="{}")
    args = p.parse_args()
    try:
        asyncio.run(run(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
