"""In-process multi-node cluster harness (ref analog:
python/ray/cluster_utils.py:135 `Cluster` — extra raylets as local
subprocesses on one machine, which is how the reference tests
"multi-node" behavior without a real cluster).

Usage:
    cluster = Cluster(head_resources={"CPU": 2})
    node_b = cluster.add_node(resources={"CPU": 2, "blue": 1})
    cluster.connect()                 # ray_tpu_torch.init(address=...)
    ...
    cluster.remove_node(node_b)       # node death
    cluster.shutdown()
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import time
from dataclasses import dataclass, field


@dataclass
class NodeHandle:
    proc: subprocess.Popen
    node_id_hex: str
    nm_port: int
    resources: dict = field(default_factory=dict)

    @property
    def node_id(self):
        from ray_tpu_torch._internal.ids import NodeID

        return NodeID.from_hex(self.node_id_hex)


class Cluster:
    def __init__(self, head_resources: dict | None = None,
                 initialize_head: bool = True,
                 gcs_only_head: bool = False,
                 persist_path: str | None = None,
                 autoscaler_config: dict | None = None,
                 dashboard_port: int | None = None):
        self.head_proc: subprocess.Popen | None = None
        self.gcs_port: int | None = None
        self.dashboard_port: int | None = None
        self.head_node: NodeHandle | None = None
        self.worker_nodes: list[NodeHandle] = []
        self._connected = False
        self._gcs_only = gcs_only_head
        self._persist_path = persist_path
        self._autoscaler_config = autoscaler_config
        self._dashboard_port = dashboard_port
        if initialize_head:
            self._start_head(head_resources or {"CPU": 2.0})

    # ------------------------------------------------------------ lifecycle
    def _start_head(self, resources: dict, gcs_port: int = 0):
        from ray_tpu_torch._internal.config import get_config
        from ray_tpu_torch._internal.spawn import child_env, fast_python_argv

        resources = dict(resources)
        resources.setdefault("memory", float(1 << 30))
        env = child_env(self._pkg_root())
        env["RAYT_CONFIG_JSON"] = get_config().to_json()
        argv = (fast_python_argv("ray_tpu_torch.core.head_main")
                + ["--resources", json.dumps(resources),
                   "--gcs-port", str(gcs_port)])
        if self._persist_path:
            argv += ["--persist-path", self._persist_path]
        if self._gcs_only:
            argv += ["--gcs-only"]
        if self._autoscaler_config:
            argv += ["--autoscaler-config",
                     json.dumps(self._autoscaler_config)]
        if self._dashboard_port is not None:
            argv += ["--dashboard-port", str(self._dashboard_port)]
        self.head_proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, env=env, text=True)
        line = self.head_proc.stdout.readline()
        if not line:
            raise RuntimeError("head process failed to start")
        info = json.loads(line)
        self.gcs_port = info["gcs_port"]
        self.dashboard_port = info.get("dashboard_port", -1)
        if not self._gcs_only:
            self.head_node = NodeHandle(
                proc=self.head_proc, node_id_hex=info["node_id"],
                nm_port=info["nm_port"], resources=resources)
        self._head_resources = resources

    def kill_head(self, *, graceful: bool = False):
        """Kill the head process (GCS). With persistence + gcs_only_head,
        restart_head() brings the cluster back (ref:
        tests/test_gcs_fault_tolerance.py)."""
        if graceful:
            self.head_proc.terminate()
        else:
            self.head_proc.send_signal(signal.SIGKILL)
        self.head_proc.wait(timeout=10)

    def restart_head(self):
        """Restart the GCS on the SAME port so clients/nodes reconnect."""
        assert self.gcs_port, "head never started"
        self._start_head(self._head_resources, gcs_port=self.gcs_port)

    @staticmethod
    def _pkg_root() -> str:
        return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.gcs_port}"

    def add_node(self, *, num_cpus: float | None = None,
                 resources: dict | None = None,
                 labels: dict | None = None,
                 startup_timeout_s: float = 30.0) -> NodeHandle:
        from ray_tpu_torch._internal.config import get_config
        from ray_tpu_torch._internal.spawn import child_env, fast_python_argv

        total = dict(resources or {})
        if num_cpus is not None:
            total["CPU"] = float(num_cpus)
        total.setdefault("CPU", 1.0)
        total.setdefault("memory", float(1 << 30))
        env = child_env(self._pkg_root())
        env["RAYT_CONFIG_JSON"] = get_config().to_json()
        proc = subprocess.Popen(
            fast_python_argv("ray_tpu_torch.core.node_main")
            + ["--gcs-address", self.address,
               "--resources", json.dumps(total),
               "--labels", json.dumps(labels or {})],
            stdout=subprocess.PIPE, env=env, text=True)
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError("worker node failed to start")
        info = json.loads(line)
        handle = NodeHandle(proc=proc, node_id_hex=info["node_id"],
                            nm_port=info["nm_port"], resources=total)
        self.worker_nodes.append(handle)
        self._wait_registered(handle, startup_timeout_s)
        return handle

    def _wait_registered(self, handle: NodeHandle, timeout_s: float):
        """Block until the new node shows up alive in the GCS view (and the
        driver, if connected, has seen the node-added event)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                view = self._cluster_view()
            except Exception:
                view = {}
            entry = view.get(handle.node_id_hex)
            if entry and entry.get("alive"):
                return
            time.sleep(0.05)
        raise TimeoutError(f"node {handle.node_id_hex} failed to register")

    def _cluster_view(self) -> dict:
        import asyncio

        from ray_tpu_torch.core.common import Address
        from ray_tpu_torch.core.gcs import GcsClient

        if self._connected:
            import ray_tpu_torch.core.runtime as rtc

            cw = rtc.get_runtime_context().core_worker
            return cw.io.run(cw.gcs.conn.call("get_cluster_resources"))

        async def _go():
            gcs = await GcsClient.connect(Address("127.0.0.1", self.gcs_port))
            try:
                return await gcs.conn.call("get_cluster_resources")
            finally:
                await gcs.close()

        return asyncio.run(_go())

    def remove_node(self, handle: NodeHandle, *, graceful: bool = True,
                    timeout_s: float = 10.0):
        """Stop a worker node. graceful=False SIGKILLs the node manager,
        simulating sudden node loss (workers self-exit via their
        node-connection watchdog)."""
        if graceful:
            handle.proc.terminate()
        else:
            handle.proc.send_signal(signal.SIGKILL)
        try:
            handle.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            handle.proc.kill()
            handle.proc.wait(timeout=timeout_s)
        if handle in self.worker_nodes:
            self.worker_nodes.remove(handle)
        # wait for the GCS to notice the death so tests observe a settled view
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                entry = self._cluster_view().get(handle.node_id_hex)
            except Exception:
                break
            if entry is None or not entry.get("alive"):
                return
            time.sleep(0.05)

    def connect(self):
        import ray_tpu_torch

        ctx = ray_tpu_torch.init(address=self.address)
        self._connected = True
        return ctx

    def shutdown(self):
        import ray_tpu_torch

        if self._connected:
            try:
                ray_tpu_torch.shutdown()
            except Exception:
                pass
            self._connected = False
        for handle in list(self.worker_nodes):
            try:
                self.remove_node(handle, graceful=True)
            except Exception:
                pass
        if self.head_proc is not None:
            self.head_proc.terminate()
            try:
                self.head_proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.head_proc.kill()
            self.head_proc = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
