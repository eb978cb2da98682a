"""Worker process entrypoint (ref analog:
python/ray/_private/workers/default_worker.py + the C++ task execution loop
entered from _raylet.pyx:3038). Spawned by the node manager; registers back
and then serves push_task / create_actor / push_actor_task until killed.

Deliberately does NOT import torch at startup — workers boot in ~100ms and
only pay the torch import (seconds) when a task actually uses it.
"""

from __future__ import annotations

import os
import signal
import sys
import threading


def main():
    from ray_tpu_torch._internal.ids import JobID, NodeID
    from ray_tpu_torch.core.common import Address
    from ray_tpu_torch.core.core_worker import CoreWorker

    node_id = NodeID.from_hex(os.environ["RAYT_NODE_ID"])
    nm_host, nm_port = os.environ["RAYT_NODE_ADDR"].split(":")
    gcs_host, gcs_port = os.environ["RAYT_GCS_ADDR"].split(":")
    job_id = JobID.from_hex(os.environ.get("RAYT_JOB_ID", "00000000"))

    cw = CoreWorker(
        mode="worker", job_id=job_id,
        gcs_address=Address(gcs_host, int(gcs_port)),
        node_address=Address(nm_host, int(nm_port)),
        node_id=node_id)
    try:
        cw.connect_cluster()
    except BaseException:
        from ray_tpu_torch._internal.logging_utils import setup_logger

        setup_logger("worker").exception(
            "worker pid %d failed to bootstrap against node %s (gcs %s)",
            os.getpid(), os.environ["RAYT_NODE_ADDR"],
            os.environ["RAYT_GCS_ADDR"])
        raise

    stop = threading.Event()

    def _term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    # Orphan watchdog: if the node manager connection drops (raylet died,
    # possibly SIGKILLed), exit instead of lingering forever (ref analog:
    # workers die when their raylet does).
    if cw.node_conn is not None:
        cw.node_conn.on_close.append(lambda _c: stop.set())
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    os._exit(0)


if __name__ == "__main__":
    main()
