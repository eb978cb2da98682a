"""Head process: GCS + the head node's manager in one asyncio process
(ref analog: `ray start --head` spawning gcs_server + raylet; merged here
because both are asyncio services and separate daemons buy nothing on a
single host — multi-node tests spawn extra node managers via
cluster_utils).

Prints one JSON line with the bound ports on stdout, then serves forever.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys


async def run(args):
    from ray_tpu_torch._internal.ids import NodeID
    from ray_tpu_torch._internal.rpc import log_loop_exceptions
    from ray_tpu_torch.core.common import Address
    from ray_tpu_torch.core.gcs import GcsServer
    from ray_tpu_torch.core.node_manager import NodeManager

    log_loop_exceptions(asyncio.get_running_loop())
    gcs = GcsServer(persist_path=args.persist_path or None)
    gcs_port = await gcs.start(port=args.gcs_port)
    dashboard_port = -1
    dashboard = None
    nm = None
    if args.dashboard_port >= 0:
        from ray_tpu_torch.dashboard import DashboardHead

        dashboard = DashboardHead(gcs, f"127.0.0.1:{gcs_port}")
        dashboard_port = await dashboard.start(port=args.dashboard_port)
    autoscaler = None
    if args.autoscaler_config:
        from ray_tpu_torch.autoscaler import Autoscaler, NodeTypeConfig
        from ray_tpu_torch.autoscaler.node_provider import make_provider

        as_cfg = json.loads(args.autoscaler_config)
        provider = make_provider(as_cfg.get("provider"),
                                 f"127.0.0.1:{gcs_port}")
        types = [NodeTypeConfig(**t) for t in as_cfg["node_types"]]
        gcs.autoscaler_active = True  # infeasible tasks wait for capacity
        autoscaler = Autoscaler(
            gcs, provider, types,
            idle_timeout_s=as_cfg.get("idle_timeout_s", 60.0),
            reconcile_interval_s=as_cfg.get("reconcile_interval_s", 1.0))
        gcs.autoscaler = autoscaler  # status surface (rpc_cluster_status)
        autoscaler.start()
    if args.gcs_only:
        print(json.dumps({"gcs_port": gcs_port, "nm_port": -1,
                          "node_id": None,
                          "dashboard_port": dashboard_port}), flush=True)
    else:
        resources = json.loads(args.resources)
        nm = NodeManager(
            node_id=NodeID.random(), resources=resources,
            gcs_address=Address("127.0.0.1", gcs_port),
            labels={**json.loads(args.labels), "head": "1"})
        addr = await nm.start()
        print(json.dumps({"gcs_port": gcs_port, "nm_port": addr.port,
                          "node_id": nm.node_id.hex(),
                          "dashboard_port": dashboard_port}), flush=True)
    # SIGTERM must run the shutdown path (terminate pool workers) — the
    # default handler would kill this process and orphan every worker.
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
        if autoscaler is not None:
            autoscaler.stop()
        if dashboard is not None:
            await dashboard.stop()
        if nm is not None:
            await nm.stop()
        await gcs.stop()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--gcs-port", type=int, default=0)
    p.add_argument("--resources", type=str, default="{}")
    p.add_argument("--labels", type=str, default="{}")
    p.add_argument("--persist-path", type=str, default="")
    p.add_argument("--gcs-only", action="store_true")
    p.add_argument("--autoscaler-config", type=str, default="")
    # -1 = disabled, 0 = ephemeral port, >0 = fixed port
    p.add_argument("--dashboard-port", type=int, default=-1)
    args = p.parse_args()
    try:
        asyncio.run(run(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
