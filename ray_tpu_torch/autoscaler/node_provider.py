"""NodeProvider plugin API + the local slice provider (ref analogs:
python/ray/autoscaler/node_provider.py:13 — the cloud-provider plugin
surface — and autoscaler/_private/fake_multi_node/node_provider.py, which
"launches" nodes as local processes so autoscaling is testable without a
cloud).

A node type describes ONE slice: `hosts` host processes, each advertising
`resources_per_host`; host 0 of a slice additionally advertises the
`<type>-head: 1` resource so a whole slice can be gang-targeted. A host
whose resources name `GPU` is labelled as `rt.init()` labels a GPU node
(`gpu-count`, and `gpu-type` with the part's name where this host has a
card to name).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess


@dataclasses.dataclass
class NodeTypeConfig:
    name: str
    resources_per_host: dict
    hosts: int = 1                  # hosts per slice (slice granularity)
    max_slices: int = 10
    min_slices: int = 0             # floor the autoscaler maintains

    def head_resource(self) -> str:
        return f"{self.name}-head"


class NodeProvider:
    """Provider plugin API (ref: autoscaler/node_provider.py:13).
    Slice-granular: create/terminate whole slices, never single hosts —
    a gang of hosts is launched all-or-nothing."""

    def create_slice(self, node_type: NodeTypeConfig) -> str:
        """Launch all hosts of one slice; returns a slice id."""
        raise NotImplementedError

    def terminate_slice(self, slice_id: str) -> None:
        raise NotImplementedError

    def non_terminated_slices(self) -> dict[str, dict]:
        """slice_id -> {"node_type": name, "node_ids": [hex, ...]}"""
        raise NotImplementedError


def make_provider(provider_cfg: dict | None,
                  gcs_address: str) -> NodeProvider:
    """Provider factory from a cluster-config dict: the one factory of
    head_main's autoscaler wiring and the launcher's `down`."""
    kind = (provider_cfg or {}).get("type", "local")
    if kind in ("local", "fake"):
        return LocalNodeProvider(gcs_address)
    if kind == "gcp":
        from ray_tpu_torch.autoscaler.gcp import GcpGpuNodeProvider

        return GcpGpuNodeProvider(provider_cfg)
    raise ValueError(f"unknown provider type {kind!r}")


def host_labels(slice_id: str, host_idx: int, node_type: NodeTypeConfig,
                resources: dict) -> dict:
    """Node labels of one autoscaled host: its slice, and for a GPU host
    the labels `rt.init()` gives a GPU node."""
    labels = {"slice": slice_id, "slice_worker_index": str(host_idx),
              "node_type": node_type.name, "autoscaled": "1"}
    gpus = resources.get("GPU", 0)
    if gpus:
        from ray_tpu_torch._internal.accelerators import GpuInfo, probe_cards

        cards = probe_cards()
        labels.update(GpuInfo(count=int(gpus),
                              name=cards[0] if cards else "").labels())
    return labels


class LocalNodeProvider(NodeProvider):
    """Slices are groups of local node-manager subprocesses (ref:
    fake_multi_node/node_provider.py). Used by tests, `up` with a local
    provider, and the autoscaler on one machine."""

    def __init__(self, gcs_address: str):
        self.gcs_address = gcs_address
        self._slices: dict[str, dict] = {}
        self._counter = 0

    def create_slice(self, node_type: NodeTypeConfig) -> str:
        from ray_tpu_torch._internal.config import get_config
        from ray_tpu_torch._internal.spawn import child_env, fast_python_argv

        self._counter += 1
        slice_id = f"{node_type.name}-{self._counter}"
        procs, node_ids = [], []
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        for host_idx in range(node_type.hosts):
            resources = dict(node_type.resources_per_host)
            resources.setdefault("CPU", 1.0)
            resources.setdefault("memory", float(1 << 30))
            if host_idx == 0:
                resources[node_type.head_resource()] = 1.0
            labels = host_labels(slice_id, host_idx, node_type, resources)
            env = child_env(pkg_root)
            env["RAYT_CONFIG_JSON"] = get_config().to_json()
            # slices stay in the CREATOR's process group on purpose: a
            # launched cluster's `down` reaps them via killpg on the head
            # (their parent)
            proc = subprocess.Popen(
                fast_python_argv("ray_tpu_torch.core.node_main")
                + ["--gcs-address", self.gcs_address,
                   "--resources", json.dumps(resources),
                   "--labels", json.dumps(labels)],
                stdout=subprocess.PIPE, env=env, text=True)
            line = proc.stdout.readline()
            if not line:
                for p in procs + [proc]:
                    p.terminate()
                raise RuntimeError(f"slice host {host_idx} failed to boot")
            info = json.loads(line)
            procs.append(proc)
            node_ids.append(info["node_id"])
        self._slices[slice_id] = {
            "node_type": node_type.name, "procs": procs,
            "node_ids": node_ids,
        }
        return slice_id

    def terminate_slice(self, slice_id: str) -> None:
        entry = self._slices.pop(slice_id, None)
        if entry is None:
            return
        for proc in entry["procs"]:
            try:
                proc.terminate()
            except Exception:
                pass
        for proc in entry["procs"]:
            try:
                proc.wait(timeout=5)
            except Exception:
                try:
                    proc.kill()
                except Exception:
                    pass

    def non_terminated_slices(self) -> dict[str, dict]:
        return {sid: {"node_type": e["node_type"],
                      "node_ids": list(e["node_ids"])}
                for sid, e in self._slices.items()}

    def shutdown(self):
        for sid in list(self._slices):
            self.terminate_slice(sid)

