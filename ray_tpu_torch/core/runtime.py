"""Driver-side cluster bootstrap: init/shutdown (ref analog:
python/ray/_private/worker.py:1275 `init` + _private/{node,services}.py
process launching)."""

from __future__ import annotations

import atexit
import json
import os
import subprocess
import sys
import time

from ray_tpu_torch._internal.config import get_config
from ray_tpu_torch._internal.ids import JobID, NodeID
from ray_tpu_torch._internal.logging_utils import setup_logger
from ray_tpu_torch.core.common import Address
from ray_tpu_torch.core.core_worker import CoreWorker

logger = setup_logger("runtime")

_global: "RuntimeContext | None" = None


class RuntimeContext:
    def __init__(self):
        self.head_proc: subprocess.Popen | None = None
        self.core_worker: CoreWorker | None = None
        self.gcs_address: Address | None = None
        self.nm_address: Address | None = None
        self.head_node_id: NodeID | None = None
        self.job_id: JobID | None = None
        self.owns_cluster = False


def _detect_default_resources(num_cpus, resources) -> tuple[dict, dict]:
    """(resources, node labels) of the head node."""
    out = dict(resources or {})
    labels = {}
    if num_cpus is None:
        num_cpus = os.cpu_count() or 1
    out.setdefault("CPU", float(num_cpus))
    if "GPU" not in out:
        # GPU autodetect (ref analog: _private/accelerators/nvidia_gpu.py):
        # CUDA_VISIBLE_DEVICES over the cards nvidia-smi or the driver's
        # /proc tree lists; the node label names the part.
        from ray_tpu_torch._internal.accelerators import detect_gpus

        info = detect_gpus()
        if info is not None:
            out.update(info.resources())
            labels.update(info.labels())
    out.setdefault("memory", float(_system_memory_bytes()))
    return out, labels


def _system_memory_bytes() -> int:
    try:
        import psutil

        return psutil.virtual_memory().total
    except Exception:
        return 8 << 30


def is_initialized() -> bool:
    return _global is not None


def get_runtime_context() -> RuntimeContext:
    if _global is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return _global


def init(address: str | None = None, *, num_cpus: float | None = None,
         resources: dict | None = None, log_to_driver: bool = True,
         ignore_reinit_error: bool = False, **kwargs) -> RuntimeContext:
    global _global
    if _global is not None:
        if ignore_reinit_error:
            return _global
        raise RuntimeError("ray_tpu_torch already initialized (pass "
                           "ignore_reinit_error=True to tolerate)")
    ctx = RuntimeContext()
    if address is None:
        from ray_tpu_torch._internal.spawn import child_env, fast_python_argv

        total, labels = _detect_default_resources(num_cpus, resources)
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env = child_env(pkg_root)
        env["RAYT_CONFIG_JSON"] = get_config().to_json()
        ctx.head_proc = subprocess.Popen(
            fast_python_argv("ray_tpu_torch.core.head_main")
            + ["--resources", json.dumps(total),
               "--labels", json.dumps(labels)],
            stdout=subprocess.PIPE, env=env, text=True)
        line = ctx.head_proc.stdout.readline()
        if not line:
            raise RuntimeError("head process failed to start")
        info = json.loads(line)
        ctx.gcs_address = Address("127.0.0.1", info["gcs_port"])
        ctx.nm_address = Address("127.0.0.1", info["nm_port"])
        ctx.head_node_id = NodeID.from_hex(info["node_id"])
        ctx.owns_cluster = True
    else:
        host, port = address.split(":")
        ctx.gcs_address = Address(host, int(port))
        # attach: discover the head node manager via GCS
        import asyncio

        from ray_tpu_torch.core.gcs import GcsClient

        async def _discover():
            gcs = await GcsClient.connect(ctx.gcs_address)
            nodes = await gcs.get_all_nodes()
            await gcs.close()
            return nodes

        nodes = asyncio.run(_discover())
        head = next((n for n in nodes if n.labels.get("head")), nodes[0])
        ctx.nm_address = head.address
        ctx.head_node_id = head.node_id

    ctx.job_id = JobID.random()
    os.environ["RAYT_JOB_ID"] = ctx.job_id.hex()
    cw = CoreWorker(mode="driver", job_id=ctx.job_id,
                    gcs_address=ctx.gcs_address,
                    node_address=ctx.nm_address,
                    node_id=ctx.head_node_id)
    cw.connect_cluster()
    cw.io.run(cw.gcs.conn.call("register_job", (ctx.job_id, {"driver_pid": os.getpid()})))
    ctx.core_worker = cw
    _global = ctx
    atexit.register(shutdown)
    return ctx


def shutdown():
    global _global
    ctx = _global
    if ctx is None:
        return
    _global = None
    try:
        if ctx.core_worker is not None:
            try:
                ctx.core_worker.io.run(
                    ctx.core_worker.gcs.conn.call("finish_job", ctx.job_id),
                    timeout=2)
            except Exception:
                pass
            ctx.core_worker.shutdown()
    finally:
        if ctx.owns_cluster and ctx.head_proc is not None:
            ctx.head_proc.terminate()
            try:
                ctx.head_proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                ctx.head_proc.kill()
    try:
        atexit.unregister(shutdown)
    except Exception:
        pass
