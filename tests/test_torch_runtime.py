"""What only the port's runtime has: the GPU as a schedulable resource
(autodetected without torch), the processes it spawns running
ray_tpu_torch's own modules with a torch-free boot, device objects over
torch tensors, the errors of the paths not ported yet, and the port's
compute run inside workers against the JAX package on the same numpy
inputs.

Tolerances: the debug model's loss, f32, 1e-5 relative (as the train-step
parity tests); greedy streams equal token for token."""

import asyncio
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.models import llama as jllama
from ray_tpu.serve import llm as jllm
from ray_tpu_torch._internal import accelerators as acc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


# --------------------------------------------------------- GPU autodetect
def _cards(*names):
    return lambda: list(names)


def test_detect_gpus_counts_the_cards_and_names_the_part():
    info = acc.detect_gpus(env={}, probe=_cards(H100, H100, H100, H100))
    assert info.resources() == {"GPU": 4.0}
    assert info.labels() == {"gpu-count": "4", "gpu-type": H100}


@pytest.mark.parametrize("visible,count,name", [
    ("1,3", 2, "B"), ("2", 1, "C"), ("0,7,1", 1, "A"),
    ("GPU-5f0c,GPU-77aa", 2, "A"), ("", None, None), ("-1", None, None)])
def test_detect_gpus_honours_cuda_visible_devices(visible, count, name):
    info = acc.detect_gpus(env={"CUDA_VISIBLE_DEVICES": visible},
                           probe=_cards("A", "B", "C", "D"))
    if count is None:
        assert info is None
    else:
        assert (info.count, info.name) == (count, name)


def test_detect_gpus_finds_none_without_a_card():
    assert acc.detect_gpus(env={}, probe=_cards()) is None
    assert acc.detect_gpus(env={"CUDA_VISIBLE_DEVICES": "0"},
                           probe=_cards()) is None


def _fake_smi(directory, n: int) -> str:
    """An `nvidia-smi` on PATH that lists `n` H100s for `-L`."""
    path = os.path.join(directory, "nvidia-smi")
    lines = "".join(f"GPU {i}: {H100} (UUID: GPU-{i:04d})\\n"
                    for i in range(n))
    with open(path, "w") as f:
        f.write(f"#!/bin/sh\n[ \"$1\" = -L ] && printf '{lines}'\n")
    os.chmod(path, 0o755)
    return directory


def test_probes_read_nvidia_smi_and_the_driver_tree(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", _fake_smi(str(tmp_path), 2) + os.pathsep
                       + os.environ["PATH"])
    assert acc.probe_cards() == [H100, H100]
    for bus in ("0000:19:00.0", "0000:3b:00.0"):
        (tmp_path / "gpus" / bus).mkdir(parents=True)
        (tmp_path / "gpus" / bus / "information").write_text(
            f"Model: \t\t {H100}\nIRQ:   \t\t 17\n")
    assert acc._proc_cards(str(tmp_path / "gpus")) == [H100, H100]
    assert acc._proc_cards(str(tmp_path / "none")) == []


# ------------------------------------- the spawned processes, in a driver
_DRIVER = textwrap.dedent("""
    import json, os, sys
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import runtime

    rt.init()
    head = runtime.get_runtime_context().head_proc.pid

    def modules():
        import sys
        return {"main": sys.modules["__main__"].__spec__.name,
                "bad": sorted(m for m in sys.modules if m.split(".")[0]
                              in ("jax", "jaxlib", "ray_tpu", "torch"))}

    @rt.remote
    def task():
        return modules()

    @rt.remote
    class Actor:
        def probe(self):
            return modules()

    a = Actor.remote()
    out = {"resources": rt.cluster_resources(),
           "labels": [n.labels for n in rt.nodes()],
           "task": rt.get(task.remote(), timeout=60),
           "actor": rt.get(a.probe.remote(), timeout=60)}

    def cmdline(pid):
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\\0", b" ").decode().strip()

    def children(pid):
        kids = []
        for p in os.listdir("/proc"):
            if p.isdigit():
                try:
                    with open(f"/proc/{p}/stat") as f:
                        ppid = int(f.read().rsplit(")", 1)[1].split()[1])
                except OSError:
                    continue
                if ppid == pid:
                    kids.append(int(p))
        return kids

    out["head"] = cmdline(head)
    out["workers"] = [cmdline(p) for p in children(head)]
    rt.kill(a)
    rt.shutdown()
    print("RESULT", json.dumps(out), flush=True)
""")


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """A fresh driver process that calls rt.init() with no arguments on a
    host whose `nvidia-smi` lists two H100s, runs a CPU task and an actor,
    and reports what it saw; every process of the cluster logs its imports
    (PYTHONPROFILEIMPORTTIME) to the captured stderr."""
    directory = str(tmp_path_factory.mktemp("smi"))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    env.update(PATH=_fake_smi(directory, 2) + os.pathsep + env["PATH"],
               PYTHONPATH=ROOT, PYTHONPROFILEIMPORTTIME="1")
    proc = subprocess.run([sys.executable, "-c", _DRIVER], cwd=directory,
                          env=env, capture_output=True, text=True,
                          timeout=150)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT "))
    imported = [ln.rsplit("|", 1)[1].strip()
                for ln in proc.stderr.splitlines()
                if ln.startswith("import time:") and "|" in ln]
    return json.loads(line[len("RESULT "):]), imported


def test_init_autodetects_the_gpus_and_labels_the_part(spawned):
    out, _ = spawned
    assert out["resources"]["GPU"] == 2.0
    [labels] = out["labels"]
    assert labels["gpu-type"] == H100 and labels["head"] == "1"


def test_spawned_processes_run_the_ports_modules(spawned):
    out, _ = spawned
    assert "-m ray_tpu_torch.core.head_main" in out["head"]
    assert out["workers"] and all(
        "-S -m ray_tpu_torch.core.worker_main" in w for w in out["workers"])
    for who in ("task", "actor"):
        assert out[who]["main"] == "ray_tpu_torch.core.worker_main"


def test_no_process_imports_jax_ray_tpu_or_torch(spawned):
    """Head (GCS and node manager), workers and the driver: none imported
    jax or the JAX package, and worker boot stays torch-free."""
    out, imported = spawned
    # each process logs its own imports: the driver, the head and at least
    # the task's and the actor's workers
    assert imported.count("ray_tpu_torch._internal.ids") >= 4
    assert "ray_tpu_torch.core.node_manager" in imported
    tops = {name.split(".")[0] for name in imported}
    assert not tops & {"jax", "jaxlib", "ray_tpu", "torch"}, tops
    assert out["task"]["bad"] == [] and out["actor"]["bad"] == []


# -------------------------------------------- a cluster with two GPUs
@pytest.fixture(scope="module")
def cluster():
    ctx = rt.init(num_cpus=4, resources={"GPU": 2})
    yield ctx
    rt.shutdown()


@rt.remote(num_gpus=1)
class GpuHolder:
    def ping(self):
        return 1


def test_num_gpus_schedules_against_the_gpu_resource(cluster):
    assert rt.cluster_resources()["GPU"] == 2.0

    @rt.remote(num_gpus=2)
    def both():
        return "both"

    assert rt.get(both.remote(), timeout=60) == "both"
    a, b = GpuHolder.remote(), GpuHolder.remote()
    assert rt.get([a.ping.remote(), b.ping.remote()], timeout=60) == [1, 1]
    c = GpuHolder.remote()                       # no GPU left: it waits
    ready, _ = rt.wait([c.ping.remote()], timeout=2)
    assert ready == []
    rt.kill(a)
    assert rt.get(c.ping.remote(), timeout=60) == 1
    for h in (b, c):
        rt.kill(h)


def test_infeasible_gpu_demand_fails(cluster):
    @rt.remote(num_gpus=3)
    def impossible():
        return 1

    with pytest.raises(rt.RayTpuError):
        rt.get(impossible.remote(), timeout=60)


# ---------------------------------------------- device objects, CPU tensors
@rt.remote
class TensorHolder:
    def __init__(self):
        import torch

        self.t = torch.arange(2 * 64 * 4 * 16, dtype=torch.float32).reshape(
            2, 64, 4, 16).to(torch.bfloat16)

    def put(self):
        self.ref = rt.put_device(self.t)
        return [self.ref]          # in a list: the ref itself, not its value

    def holder_gets_the_same_object(self):
        return rt.get(self.ref) is self.t

    def tensor(self):
        return self.t


def test_put_device_in_the_driver_returns_the_same_object(cluster):
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    ref = rt.put_device(t)
    assert rt.get(ref) is t

    @rt.remote
    def consume(x):
        import torch

        return isinstance(x, torch.Tensor), x.dtype == torch.float32, \
            float(x.sum())

    assert rt.get(consume.remote(ref), timeout=60) == (True, True, 66.0)


def test_device_object_of_an_actor_reaches_the_driver(cluster):
    h = TensorHolder.remote()
    [ref] = rt.get(h.put.remote(), timeout=60)
    assert rt.get(h.holder_gets_the_same_object.remote(), timeout=60)
    want = rt.get(h.tensor.remote(), timeout=60)
    got = rt.get(ref, timeout=60)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    # a method with tensor_transport=True returns through the same plane
    ret = h.tensor.options(tensor_transport=True).remote()
    assert torch.equal(rt.get(ret, timeout=60), want)
    from ray_tpu_torch.core.object_ref import get_core_worker

    assert get_core_worker().object_meta[ret.id].in_device
    rt.kill(h)


def test_put_device_rejects_a_non_tensor(cluster):
    with pytest.raises(TypeError, match="torch.Tensor"):
        rt.put_device({"not": "a tensor"})
    with pytest.raises(TypeError):
        rt.put_device(np.zeros(3))


# ------------------------------------------------------- code shipping
def test_shipping_test_code_keeps_the_jax_package_by_reference():
    """Shipping a function of this test module walks the module's globals
    (jllama and jllm, modules of the JAX package, among them): the test
    module ships by value, but nothing that workers import by name from the
    checkout does. Registering the JAX package's modules by value pickled
    their classes by value in the whole pytest worker, so the JAX package's
    own runtime, driven later from that process by its tests, sent its
    workers copies of core_worker.RefArg that they did not resolve
    ("'RefArg' object is not subscriptable")."""
    import cloudpickle

    from ray_tpu.core import core_worker as jcore_worker
    from ray_tpu_torch._internal import serialization

    serialization.ship_code_by_value(_cards)
    registered = cloudpickle.cloudpickle._PICKLE_BY_VALUE_MODULES
    assert _cards.__module__ in registered
    assert not [m for m in registered if m.split(".")[0] in
                ("ray_tpu", "ray_tpu_torch", "chip_smoke", "torch_repoint")]
    assert not serialization._is_driver_local(jcore_worker)
    assert not serialization._is_driver_local(jllama)
    assert serialization._is_driver_local(sys.modules[_cards.__module__])


# ------------------------------------------------- paths not ported yet
def test_paths_not_ported_name_their_roadmap_item(cluster):
    @rt.remote
    def f():
        return 1

    # compiled DAGs are ported: bind builds nodes
    from ray_tpu_torch.dag import ClassMethodNode, FunctionNode

    assert isinstance(f.bind(), FunctionNode)
    h = GpuHolder.options(num_gpus=0).remote()
    assert isinstance(h.ping.bind(), ClassMethodNode)
    rt.kill(h)
    from ray_tpu_torch.cluster_utils import Cluster

    # the dashboard (item 2b) and the autoscaler (item 8b) are ported: a
    # Cluster starts both, and the cluster status carries the autoscaler's
    dash = Cluster(dashboard_port=0, initialize_head=True,
                   autoscaler_config={"node_types": []})
    try:
        assert dash.dashboard_port > 0
        from urllib.request import urlopen

        with urlopen(f"http://127.0.0.1:{dash.dashboard_port}"
                     "/api/cluster_status", timeout=30) as r:
            scaler = json.loads(r.read())["autoscaler"]
        assert (scaler["num_scale_ups"], scaler["num_scale_downs"]) == (0, 0)
    finally:
        dash.shutdown()
    assert rt.state_api.list_nodes is not None
    from ray_tpu_torch import workflow

    assert workflow.run is not None
    assert rt.dag.InputNode is not None
    # RL is ported, its offline algorithms with the data plane, and Tune
    assert rt.rl.PPOConfig is not None
    assert rt.rl.BCConfig is not None and rt.rl.CQLConfig is not None
    assert rt.tune.Tuner is not None and rt.data.build_corpus is not None
    # the train runtime and the host collective tier are ported; like the
    # reference's, the host tier takes no "nccl" (the device plane is the
    # collectives inside the mesh), and there is no top-level collective
    assert rt.train.TorchTrainer is not None
    with pytest.raises(ValueError, match="unsupported backend"):
        rt.util.collective.init_collective_group(2, 0, backend="nccl")
    with pytest.raises(ModuleNotFoundError):
        rt.collective


def test_head_main_refuses_the_dashboard_and_autoscaler():
    """The head starts the dashboard (item 2b) and serves it, and with
    --autoscaler-config it runs the autoscaler (item 8b) over the
    configured provider, which the cluster status shows."""
    from urllib.request import urlopen

    from ray_tpu_torch._internal.spawn import child_env, fast_python_argv

    as_cfg = {"provider": {"type": "local"}, "reconcile_interval_s": 0.2,
              "node_types": [{"name": "h100-1", "resources_per_host":
                              {"CPU": 1, "GPU": 1}, "max_slices": 1}]}
    head = subprocess.Popen(
        fast_python_argv("ray_tpu_torch.core.head_main")
        + ["--gcs-only", "--dashboard-port", "0",
           "--autoscaler-config", json.dumps(as_cfg)],
        stdout=subprocess.PIPE, env=child_env(ROOT), text=True)
    try:
        info = json.loads(head.stdout.readline())
        assert info["dashboard_port"] > 0
        with urlopen(f"http://127.0.0.1:{info['dashboard_port']}"
                     "/api/cluster", timeout=30) as r:
            assert "scheduling" in json.loads(r.read())
        with urlopen(f"http://127.0.0.1:{info['dashboard_port']}"
                     "/api/cluster_status", timeout=30) as r:
            scaler = json.loads(r.read())["autoscaler"]
        assert scaler["num_scale_ups"] == 0 and scaler["slices"] == {}
    finally:
        head.terminate()
        head.wait(timeout=30)


# ----------------------------- the port's compute inside workers vs ray_tpu
def _debug_setup():
    jcfg = jllama.config_for("debug", dtype=jnp.float32, remat=False,
                             attn_impl="xla")
    params = jax.tree.map(np.asarray,
                          jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    return jcfg, params, {"tokens": tokens, "targets": np.roll(tokens, -1, 1)}


@rt.remote
def port_loss(params_np, batch_np):
    import sys

    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_numpy

    cfg = llama.config_for("debug", dtype=torch.float32, remat=False,
                           attn_impl="xla")
    params = params_from_numpy(params_np, device="cpu", cfg=cfg)
    batch = {k: torch.from_numpy(v).long() for k, v in batch_np.items()}
    with torch.no_grad():
        loss, _ = llama.loss_fn(params, batch, cfg)
    return float(loss), sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "ray_tpu"))


def test_loss_in_a_task_matches_jax(cluster):
    jcfg, params, batch = _debug_setup()
    want = float(jllama.loss_fn(jax.tree.map(jnp.asarray, params),
                                jax.tree.map(jnp.asarray, batch), jcfg)[0])
    got, bad = rt.get(port_loss.remote(params, batch), timeout=120)
    assert bad == []
    np.testing.assert_allclose(got, want, rtol=1e-5)


@rt.remote
class LlamaActor:
    """The debug LlamaService in f32 on the CPU, in an async actor that
    streams its tokens."""

    def __init__(self, params_np):
        import torch

        from ray_tpu_torch.serve import llm

        config_for = llm.llama.config_for
        llm.llama.config_for = lambda name, **kw: config_for(
            name, **{"dtype": torch.float32, **kw})
        self.svc = llm.LlamaService("debug", params=params_np, device="cpu")

    async def generate(self, payload):
        async for out in self.svc(payload):
            yield out["token"]


PROMPTS = ([5, 9, 11, 42, 7], list(range(3, 23)))


def test_llama_service_in_an_actor_streams_the_jax_engines_tokens(
        cluster, monkeypatch):
    _, params, _ = _debug_setup()
    config_for = jllm.llama.config_for
    monkeypatch.setattr(jllm.llama, "config_for", lambda name, **kw:
                        config_for(name, **{"dtype": jnp.float32, **kw}))
    eng = jllm.LLMEngine("debug", tp=1, params=params)

    async def collect(prompt):
        return [t async for t in eng.generate(prompt, max_new_tokens=8)]

    want = [asyncio.run(collect(p)) for p in PROMPTS]
    actor = LlamaActor.remote(params)
    got = []
    for prompt in PROMPTS:                       # one at a time
        gen = actor.generate.options(num_returns="streaming").remote(
            {"tokens": prompt, "max_new_tokens": 8})
        got.append([rt.get(ref, timeout=120) for ref in gen])
    assert [len(g) for g in got] == [8, 8]
    assert got == want
    rt.kill(actor)
