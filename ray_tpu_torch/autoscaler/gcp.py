"""GCP GPU node provider over Compute Engine (ref analogs: the reference's
GCP provider and the autoscaler's cluster YAML node types; the A3 machine
family, each VM with 1, 2, 4 or 8 H100s).

Speaks the Compute Engine REST surface (`compute/v1`): `create_slice` posts
one `instances.bulkInsert` for a slice's `hosts` VMs with `count =
minCount = hosts`, so the slice is created all-or-nothing, as a queued
resource creates a pod slice; `non_terminated_slices` pages
`instances.list` to the end and groups this cluster's PROVISIONING,
STAGING and RUNNING VMs by their slice label; `terminate_slice` deletes a
slice's VMs. The HTTP transport is injected (`transport(method, url,
body) -> dict`) so air-gapped tests exercise the full request/response
handling against a recorded fake; the default transport uses urllib and
requires the standard metadata-server credentials.

Config mirrors the cluster config's provider section:

    provider = GcpGpuNodeProvider({
        "project_id": "my-proj",
        "zone": "us-central1-a",
        "cluster_name": "demo",
        "source_image": "projects/<p>/global/images/family/<family>",
        "startup_script": "python -m ray_tpu_torch.core.node_main ...",
    })

A node type's machine type is its name when that names an A3 type, else
the A3 type with the node type's `GPU` per host.
"""

from __future__ import annotations

import json
import uuid
from typing import Callable, Optional
from urllib.parse import quote

from ray_tpu_torch._internal.logging_utils import setup_logger
from ray_tpu_torch.autoscaler.node_provider import (NodeProvider,
                                                    NodeTypeConfig)

logger = setup_logger("gcp_gpu")

# A3 machine type -> H100s per VM
MACHINE_TYPES = {
    "a3-highgpu-1g": 1,
    "a3-highgpu-2g": 2,
    "a3-highgpu-4g": 4,
    "a3-highgpu-8g": 8,
}

# Compute Engine states of a VM that is, or is becoming, a host
_LIVE_STATES = ("PROVISIONING", "STAGING", "RUNNING")

DEFAULT_IMAGE = ("projects/deeplearning-platform-release/global/images/"
                 "family/common-cu128-ubuntu-2204-nvidia-570")


def default_transport(method: str, url: str,
                      body: Optional[dict] = None) -> dict:
    """urllib transport with metadata-server auth (GCE/GKE standard)."""
    import urllib.request

    token_req = urllib.request.Request(
        "http://metadata.google.internal/computeMetadata/v1/instance/"
        "service-accounts/default/token",
        headers={"Metadata-Flavor": "Google"})
    with urllib.request.urlopen(token_req, timeout=10) as r:
        token = json.loads(r.read())["access_token"]
    req = urllib.request.Request(
        url, data=json.dumps(body).encode() if body is not None else None,
        headers={"Authorization": f"Bearer {token}",
                 "Content-Type": "application/json"},
        method=method)
    with urllib.request.urlopen(req, timeout=60) as r:
        data = r.read()
    return json.loads(data) if data else {}


class GcpGpuNodeProvider(NodeProvider):
    API = "https://compute.googleapis.com/compute/v1"

    def __init__(self, config: dict,
                 transport: Callable[..., dict] = default_transport):
        self.project = config["project_id"]
        self.zone = config["zone"]
        self.source_image = config.get("source_image", DEFAULT_IMAGE)
        self.network = config.get("network", "global/networks/default")
        self.startup_script = config.get("startup_script", "")
        self.labels = dict(config.get("labels") or {})
        # scope every list/terminate to THIS cluster's slices: without it
        # `down` would reap other clusters' rayt-labeled VMs
        self.cluster_name = config.get("cluster_name", "")
        if self.cluster_name:
            self.labels["rayt-cluster"] = self.cluster_name
        self.transport = transport

    # ------------------------------------------------------------- helpers
    def _zone_url(self) -> str:
        return f"{self.API}/projects/{self.project}/zones/{self.zone}"

    def machine_type_for(self, node_type: NodeTypeConfig) -> str:
        """The A3 machine type of one host of `node_type`, checked
        against the GPUs per host the node type advertises."""
        gpus = node_type.resources_per_host.get("GPU")
        if node_type.name in MACHINE_TYPES:
            machine = node_type.name
        else:
            machine = next((m for m, n in MACHINE_TYPES.items()
                            if gpus is not None and n == gpus), None)
        if machine not in MACHINE_TYPES:
            raise ValueError(
                f"no A3 machine type for node type {node_type.name!r} "
                f"({gpus} GPU per host); have {sorted(MACHINE_TYPES)}")
        if gpus is not None and gpus != MACHINE_TYPES[machine]:
            raise ValueError(
                f"{machine} has {MACHINE_TYPES[machine]} GPUs per host, "
                f"node type {node_type.name!r} says {gpus:g}")
        if node_type.hosts < 1:
            raise ValueError(f"node type {node_type.name!r} has "
                             f"{node_type.hosts} hosts")
        return machine

    def _list(self) -> list[dict]:
        # Paginate to exhaustion: a one-page read would silently drop
        # slices beyond page 1, making _observe_provider mark their live
        # instances FAILED and double-launch capacity. A transport error
        # mid-listing propagates, aborting the whole reconcile tick — a
        # partial listing is never observed.
        items: list[dict] = []
        page_token = None
        while True:
            url = f"{self._zone_url()}/instances"
            if page_token:
                url += f"?pageToken={quote(page_token, safe='')}"
            resp = self.transport("GET", url)
            items.extend(resp.get("items", []))
            page_token = resp.get("nextPageToken")
            if not page_token:
                return items

    def _ours(self, inst: dict) -> Optional[str]:
        """The slice label of one of this cluster's VMs, else None."""
        labels = inst.get("labels", {})
        if labels.get("rayt-node-type") is None:
            return None   # not ours
        if self.cluster_name and \
                labels.get("rayt-cluster") != self.cluster_name:
            return None   # another cluster's VM
        return labels.get("rayt-slice")

    # ------------------------------------------------------ provider API
    def create_slice(self, node_type: NodeTypeConfig) -> str:
        """One bulkInsert for the slice's hosts with minCount = count: the
        control plane creates all of them or none (gang semantics)."""
        machine = self.machine_type_for(node_type)
        slice_id = f"rayt-{node_type.name}-{uuid.uuid4().hex[:8]}"
        body = {
            "count": node_type.hosts,
            "minCount": node_type.hosts,
            "namePattern": f"{slice_id}-####",
            "instanceProperties": {
                "machineType": machine,
                "labels": {**self.labels, "rayt-node-type": node_type.name,
                           "rayt-slice": slice_id},
                "metadata": {"items": [
                    {"key": "startup-script", "value": self.startup_script},
                    {"key": "rayt-slice", "value": slice_id},
                    {"key": "rayt-node-type", "value": node_type.name},
                ]},
                "disks": [{"boot": True, "autoDelete": True,
                           "initializeParams": {
                               "sourceImage": self.source_image}}],
                "networkInterfaces": [{"network": self.network}],
                # GPU VMs cannot live-migrate
                "scheduling": {"onHostMaintenance": "TERMINATE"},
            },
        }
        self.transport("POST", f"{self._zone_url()}/instances/bulkInsert",
                       body)
        logger.info("requested GPU slice %s (%d x %s)", slice_id,
                    node_type.hosts, machine)
        return slice_id

    def terminate_slice(self, slice_id: str) -> None:
        for inst in self._list():
            if self._ours(inst) == slice_id:
                self.transport(
                    "DELETE", f"{self._zone_url()}/instances/{inst['name']}")

    def non_terminated_slices(self) -> dict[str, dict]:
        out: dict[str, dict] = {}
        for inst in self._list():
            if inst.get("status") not in _LIVE_STATES:
                continue
            slice_id = self._ours(inst)
            if slice_id is None:
                continue
            entry = out.setdefault(slice_id, {
                "node_type": inst["labels"]["rayt-node-type"],
                "node_ids": []})
            # host node-ids register via the startup script; the GCS view
            # joins on the slice label, so the provider reports endpoints
            entry["node_ids"].append(
                (inst.get("networkInterfaces") or [{}])[0].get(
                    "networkIP", ""))
        return out
