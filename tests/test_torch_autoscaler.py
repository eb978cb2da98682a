"""The port's autoscaler and its node providers.

- The reference's ``tests/test_autoscaler.py`` runs re-pointed at the port
  through ``torch_repoint`` (a slice of GPU hosts booted for a pending
  placement group and for a pending actor, then retired when idle; the
  instance lifecycle and the reconciler against a scripted provider). Its
  four GCP tests request TPU VMs; each has a twin here against
  ``GcpGpuNodeProvider``, which requests A3 GPU VMs from Compute Engine
  through a recorded fake transport (no network).
- The local provider labels a GPU host as ``rt.init()`` labels a GPU node.
- The reconciler of both packages takes the same decisions, tick by tick,
  on the same scripted demand.
"""

import asyncio
from urllib.parse import unquote

import pytest

from torch_repoint import run_repointed
from ray_tpu_torch.autoscaler import node_provider
from ray_tpu_torch.autoscaler.autoscaler import Autoscaler
from ray_tpu_torch.autoscaler.gcp import GcpGpuNodeProvider
from ray_tpu_torch.autoscaler.instance_manager import InstanceStatus
from ray_tpu_torch.autoscaler.node_provider import NodeTypeConfig

ZONE_URL = ("https://compute.googleapis.com/compute/v1/projects/proj/zones/"
            "us-central1-a")


def test_reference_autoscaler_file_passes_on_the_port(tmp_path):
    # the four GCP tests are DESELECT's (their twins are below)
    run_repointed("test_autoscaler", 5, tmp_path, timeout=170)


def _vm(name, slice_id, node_type="h100-1", status="RUNNING",
        cluster=None, ip="10.0.0.2"):
    labels = {"rayt-node-type": node_type, "rayt-slice": slice_id}
    if cluster:
        labels["rayt-cluster"] = cluster
    return {"name": name, "status": status, "labels": labels,
            "networkInterfaces": [{"networkIP": ip}]}


def test_gcp_gpu_provider_request_shapes():
    """One bulkInsert a slice with count = minCount = hosts (the gang is
    created all-or-nothing), the A3 machine type of the node type's GPUs
    per host, the node-type/slice/cluster labels and the startup script;
    a listing grouped by slice; a delete of each of the slice's VMs; and a
    node type whose GPUs or hosts no A3 slice can give raises."""
    calls = []
    listing = [
        _vm("rayt-h100-8-x-0000", "rayt-h100-8-x", "h100-8",
            cluster="demo", ip="10.0.0.2"),
        _vm("rayt-h100-8-x-0001", "rayt-h100-8-x", "h100-8",
            cluster="demo", ip="10.0.0.3"),
        _vm("rayt-h100-8-y-0000", "rayt-h100-8-y", "h100-8",
            status="TERMINATED", cluster="demo"),
        _vm("rayt-h100-8-z-0000", "rayt-h100-8-z", "h100-8",
            cluster="other"),
        {"name": "unrelated", "status": "RUNNING", "labels": {}},
    ]

    def transport(method, url, body=None):
        calls.append((method, url, body))
        return {"items": listing} if method == "GET" else {}

    p = GcpGpuNodeProvider(
        {"project_id": "proj", "zone": "us-central1-a",
         "cluster_name": "demo", "startup_script": "echo hi"},
        transport=transport)
    t = NodeTypeConfig("h100-8", {"CPU": 200, "GPU": 8}, hosts=2)
    sid = p.create_slice(t)
    method, url, body = calls[0]
    assert (method, url) == ("POST", f"{ZONE_URL}/instances/bulkInsert")
    assert body["count"] == body["minCount"] == 2
    assert body["namePattern"].startswith(sid + "-")
    props = body["instanceProperties"]
    assert props["machineType"] == "a3-highgpu-8g"
    assert props["labels"] == {"rayt-node-type": "h100-8",
                               "rayt-slice": sid, "rayt-cluster": "demo"}
    meta = {i["key"]: i["value"] for i in props["metadata"]["items"]}
    assert meta["startup-script"] == "echo hi"
    assert meta["rayt-slice"] == sid
    assert props["scheduling"]["onHostMaintenance"] == "TERMINATE"

    # the machine type from the name, or from the GPUs per host
    for name, gpus, machine in (("a3-highgpu-2g", 2, "a3-highgpu-2g"),
                                ("h100-1", 1, "a3-highgpu-1g"),
                                ("h100-4", 4, "a3-highgpu-4g")):
        assert p.machine_type_for(NodeTypeConfig(
            name, {"GPU": gpus})) == machine

    slices = p.non_terminated_slices()
    assert slices == {"rayt-h100-8-x": {
        "node_type": "h100-8", "node_ids": ["10.0.0.2", "10.0.0.3"]}}

    calls.clear()
    p.terminate_slice("rayt-h100-8-x")
    assert [c[:2] for c in calls if c[0] == "DELETE"] == [
        ("DELETE", f"{ZONE_URL}/instances/rayt-h100-8-x-0000"),
        ("DELETE", f"{ZONE_URL}/instances/rayt-h100-8-x-0001")]

    with pytest.raises(ValueError, match="8 GPUs per host"):
        p.create_slice(NodeTypeConfig("a3-highgpu-8g", {"GPU": 4}))
    with pytest.raises(ValueError, match="no A3 machine type"):
        p.create_slice(NodeTypeConfig("h100-3", {"GPU": 3}))
    with pytest.raises(ValueError, match="0 hosts"):
        p.create_slice(NodeTypeConfig("h100-1", {"GPU": 1}, hosts=0))


def test_gcp_gpu_provider_paginates_and_encodes_tokens():
    """A multi-page fleet is listed to exhaustion (one-page truncation
    read as 'slice vanished' would double-launch capacity), with the
    opaque pageToken URL-encoded."""
    pages = {
        None: {"items": [_vm(f"rayt-a{i}-0000", f"rayt-a{i}")
                         for i in range(2)],
               "nextPageToken": "tok+with/reserved&chars"},
        "tok+with/reserved&chars": {"items": [_vm("rayt-b0-0000",
                                                  "rayt-b0")]},
    }
    urls = []

    def transport(method, url, body=None):
        urls.append(url)
        if "pageToken=" in url:
            raw = url.split("pageToken=")[1]
            assert "/" not in raw and "&" not in raw  # encoded on the wire
            return pages[unquote(raw)]
        return pages[None]

    p = GcpGpuNodeProvider({"project_id": "p", "zone": "z"},
                           transport=transport)
    assert sorted(p.non_terminated_slices()) == ["rayt-a0", "rayt-a1",
                                                 "rayt-b0"]
    assert len(urls) == 2


def test_gcp_gpu_provider_midlisting_failure_aborts_observation():
    """A transport error on page 2 aborts the WHOLE listing (the
    reconciler skips the tick): page 1 is never returned as if it were
    the fleet."""
    def transport(method, url, body=None):
        if "pageToken=" in url:
            raise OSError("503 backend unavailable")
        return {"items": [_vm("rayt-a0-0000", "rayt-a0")],
                "nextPageToken": "t2"}

    p = GcpGpuNodeProvider({"project_id": "p", "zone": "z"},
                           transport=transport)
    with pytest.raises(OSError):
        p.non_terminated_slices()


class _FakeGcs:
    def __init__(self):
        self.nodes = {}
        self.node_resources_available = {}
        self.demand = {"placement_groups": [], "actors": [], "tasks": []}

    def rpc_get_pending_demand(self, _):
        return self.demand


def test_gcp_gpu_provider_reconciler_survives_listing_outage():
    """The listing fails for several ticks, then recovers: the live slice
    is neither marked FAILED nor launched again during the outage."""
    created = []
    outage = [False]

    def transport(method, url, body=None):
        if method == "POST":
            created.append(body["namePattern"][:-len("-####")])
            return {}
        if outage[0]:
            raise OSError("API outage")
        return {"items": [_vm(f"{sid}-0000", sid, "h100-1")
                          for sid in created]}

    provider = GcpGpuNodeProvider({"project_id": "p", "zone": "z"},
                                  transport=transport)
    scaler = Autoscaler(_FakeGcs(), provider, node_types=[
        NodeTypeConfig("h100-1", {"GPU": 1}, min_slices=1, max_slices=2)])

    async def run():
        await scaler.reconcile()   # creates min_slices=1
        await scaler.reconcile()   # observes it -> ALLOCATED
        assert len(created) == 1
        outage[0] = True
        for _ in range(3):
            with pytest.raises(OSError):
                await scaler.reconcile()
        im = scaler.instance_manager
        assert len(created) == 1
        assert not im.instances(InstanceStatus.FAILED)
        outage[0] = False
        await scaler.reconcile()
        assert len(created) == 1
        assert [i.status for i in im.instances()] == [
            InstanceStatus.ALLOCATED]

    asyncio.run(run())


@pytest.mark.parametrize("cards,expect", [
    (["NVIDIA H100 80GB HBM3"], {"gpu-count": "1",
                                 "gpu-type": "NVIDIA H100 80GB HBM3"}),
    ([], {"gpu-count": "1"}),
])
def test_local_provider_labels_a_gpu_host(cards, expect, monkeypatch):
    """A GPU host's labels carry gpu-count, and gpu-type where the host
    has a card to name, beside the slice labels; a CPU host's carry the
    slice labels alone."""
    from ray_tpu_torch._internal import accelerators

    monkeypatch.setattr(accelerators, "probe_cards", lambda: cards)
    t = NodeTypeConfig("h100-1", {"CPU": 2, "GPU": 1})
    slice_labels = {"slice": "h100-1-1", "slice_worker_index": "0",
                    "node_type": "h100-1", "autoscaled": "1"}
    assert node_provider.host_labels("h100-1-1", 0, t, {"GPU": 1.0}) == {
        **slice_labels, **expect}
    assert node_provider.host_labels("h100-1-1", 0, t, {"CPU": 2.0}) == \
        slice_labels


def test_make_provider_is_the_one_factory():
    """head_main and the launcher's down build providers through one
    factory: the local provider for local/fake/no provider, the GPU
    provider for gcp."""
    local = node_provider.make_provider(None, "127.0.0.1:1")
    assert type(local) is node_provider.LocalNodeProvider
    for kind in ("local", "fake"):
        assert isinstance(node_provider.make_provider(
            {"type": kind}, "127.0.0.1:1"), node_provider.LocalNodeProvider)
    gcp = node_provider.make_provider(
        {"type": "gcp", "project_id": "p", "zone": "z"}, "127.0.0.1:1")
    assert isinstance(gcp, GcpGpuNodeProvider)
    with pytest.raises(ValueError, match="unknown provider"):
        node_provider.make_provider({"type": "aws"}, "127.0.0.1:1")


class _ScriptedProvider:
    def __init__(self):
        self.slices = {}
        self.n = 0

    def create_slice(self, node_type):
        self.n += 1
        sid = f"s{self.n}"
        self.slices[sid] = {"node_type": node_type.name,
                            "node_ids": [f"n{self.n}"]}
        return sid

    def terminate_slice(self, sid):
        self.slices.pop(sid, None)

    def non_terminated_slices(self):
        return {k: dict(v) for k, v in self.slices.items()}


def test_reconciler_decides_as_the_reference():
    """Both packages' reconcilers, fed the same demand tick by tick
    (placement groups of each strategy, actors, tasks, a draining node's
    load, a floor, a type cap), launch the same slices and walk their
    instances through the same states."""
    from ray_tpu.autoscaler.autoscaler import Autoscaler as JAutoscaler
    from ray_tpu.autoscaler.node_provider import \
        NodeTypeConfig as JNodeTypeConfig

    def types(cls):
        return [cls("gpu-small", {"CPU": 2.0, "GPU": 1.0}, hosts=1,
                    max_slices=2),
                cls("gpu-big", {"CPU": 8.0, "GPU": 8.0}, hosts=2,
                    max_slices=1, min_slices=1)]

    ticks = [
        {"actors": [{"GPU": 1.0}]},
        {"placement_groups": [{"strategy": "STRICT_PACK",
                               "bundles": [{"GPU": 4.0}, {"GPU": 4.0}]}]},
        {"tasks": [{"GPU": 1.0}, {"GPU": 1.0}], "draining": [{"CPU": 1.0}]},
        {"placement_groups": [{"strategy": "SPREAD",
                               "bundles": [{"GPU": 1.0}] * 3}]},
        {},
        {"actors": [{"GPU": 16.0}]},   # no node type covers it
    ]

    def trace(cls_scaler, cls_type):
        gcs, provider = _FakeGcs(), _ScriptedProvider()
        scaler = cls_scaler(gcs, provider, types(cls_type),
                            idle_timeout_s=9999)
        out = []
        for demand in ticks:
            gcs.demand = {"placement_groups": [], "actors": [],
                          "tasks": [], **demand}
            asyncio.run(scaler.reconcile())
            out.append((sorted((sid, e["node_type"]) for sid, e in
                               provider.slices.items()),
                        [(e["instance_id"], e["from"], e["to"],
                          e["slice_id"])
                         for e in scaler.instance_manager.event_log],
                        scaler.num_scale_ups))
        return out

    assert trace(Autoscaler, NodeTypeConfig) == trace(JAutoscaler,
                                                      JNodeTypeConfig)
