"""The port's surfaces (``state_api``, the CLI, the dashboard, the thin
client, the rest of ``util``) held against the JAX package's on the CPU.

- The CLI's renderers print the same text in both packages when fed the
  same snapshot (a "GPU" resource where the reference's has "TPU" is the
  only difference allowed).
- ``util.multiprocessing.Pool`` and the joblib backend return what the
  reference's return, each on a local cluster of its own package (one
  child process per package).
- ``python -m ray_tpu_torch start --head`` autodetects the GPU as
  ``rt.init()`` does (the probe injected), and ``--num-gpus 0`` advertises
  none.
- The dashboard's train view and ``/metrics`` carry the ``cuda:<i>``
  device memory a worker reports.
- A ``num_gpus=1`` task sent through the client proxy runs in a
  GPU-leased worker, from a client process that never imports torch.
- An owned shm ring closes without a resource-tracker traceback (the
  reference's prints one on Python below 3.13).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

import pytest

from ray_tpu.scripts import cli as jcli
from ray_tpu_torch.scripts import cli as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return env


def _run(code: str, timeout: float = 120) -> str:
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def _result(stdout: str):
    line = next(ln for ln in stdout.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


# --------------------------------------------------- the ring's unlink
_RING = """
import os
from {pkg}.dag.channel import ShmChannel
owner = ShmChannel.create(slot_size=64, n_slots=2)
peer = ShmChannel.attach(owner.spec)
peer.close()
owner.close()
print(os.path.exists("/dev/shm/" + owner.spec.name.lstrip("/")))
"""


@pytest.mark.parametrize("pkg", ["ray_tpu_torch", "ray_tpu"])
def test_owned_ring_close_leaves_no_tracker_traceback(pkg):
    """The owner unlinks its ring; the port sends the resource tracker no
    unregister for a name it never registered, so the tracker prints
    nothing. The reference's ring (frozen) still prints the KeyError
    traceback below Python 3.13, which shows the check sees it."""
    proc = subprocess.run([sys.executable, "-c", _RING.format(pkg=pkg)],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False"]  # the segment is gone
    traceback = "KeyError" in proc.stderr and "resource_tracker" in \
        proc.stderr
    if pkg == "ray_tpu_torch":
        assert not traceback, proc.stderr
    elif sys.version_info < (3, 13):
        assert traceback, proc.stderr


# ---------------------------------------------------------- renderers
def _cluster_status(acc: str) -> dict:
    return {
        "uptime_s": 12.0, "num_actors": 2, "num_placement_groups": 1,
        "nodes": [
            {"node_id": "a" * 32, "alive": True, "state": "ALIVE",
             "heartbeat_age_s": 0.4, "pending_leases": 2,
             "labels": {"gpu-type": H100, "ici-slice": "s0", "head": "1"},
             "resources_total": {"CPU": 8.0, acc: 1.0, "memory": 8e9},
             "resources_available": {"CPU": 6.0, acc: 0.0,
                                     "memory": 7e9}},
            {"node_id": "b" * 32, "alive": False, "heartbeat_age_s": None,
             "labels": {}, "resources_total": {"CPU": 2.0},
             "resources_available": {}}],
        "drains": {"b" * 32: {"state": "DRAINED", "started": 10.0,
                              "completed": 12.5,
                              "migrated": {"actors": 1, "objects": 3}}},
        "quotas": {"c" * 32: {"weight": 2.0, "share": 4.0, "used": 3.0,
                              "resource": acc}},
        "quota_throttled": {"c" * 32: 1},
        "pending_demand": {f"CPU:1,{acc}:1": {"count": 3,
                                              "nodes": ["a" * 32]}},
        "scheduling": {"granted": 10, "queued": 3,
                       "queue_wait_s_total": 0.25, "spillback": 1,
                       "max_spill_hops": 1, "infeasible": 0,
                       "cancelled": 0},
        "recent_events": [{"ts": 1_700_000_000.0, "severity": "WARNING",
                           "source": "gcs", "kind": "node_lost",
                           "message": "node b lost"}]}


def _why_pending(acc: str) -> dict:
    return {"found": True, "task_id": "d" * 32, "name": "train_step",
            "state": "PENDING_NODE_ASSIGNMENT", "attempt": 0,
            "verdict": "feasible-but-busy",
            "explanation": f"every node with {acc} is busy",
            "quota": {"weight": 1.0, "floor": 0.0, "share": 1.0,
                      "used": 1.0, "resource": acc},
            "pending": True,
            "nodes": {"a" * 32: {"fits_now": False, "fits_ever": True,
                                 "pending_leases": 2,
                                 "available": {"CPU": 6.0, acc: 0.0}}},
            "shape": f"CPU:1,{acc}:1",
            "trace": {"granted": 4, "queued": 2, "queue_wait_max_s": 1.5,
                      "spillback": 0, "infeasible": 0,
                      "last_reason": f"no {acc} free"}}


def _task_summary(acc: str) -> dict:
    return {"total_tasks": 7, "dropped": {"job": 1},
            "worker_buffer_dropped": 2,
            "by_name": {f"{acc}_task": {
                "count": 4, "states": {"FINISHED": 3, "RUNNING": 1},
                "sched_delay_mean_s": 0.004, "exec_time_mean_s": 1.5},
                "idle": {"count": 3, "states": {"PENDING": 3},
                         "sched_delay_mean_s": None,
                         "exec_time_mean_s": None}}}


def _object_summary(acc: str) -> dict:
    return {"totals": {"objects": 5, "bytes": 12_000_000,
                       "pinned_bytes": 4_000_000, "spilled_bytes": 0,
                       "leaked_objects": 1},
            "dropped": {"job": 2},
            "by_callsite": {"tests/x.py:10": {
                "count": 5, "total_bytes": 12_000_000,
                "pinned_bytes": 4_000_000, "spilled_bytes": 0,
                "leaked_count": 1}},
            "by_node": {"a" * 32: {
                "objects": 5, "total_bytes": 12_000_000, "leaked_count": 1,
                "store": {"used_bytes": 12_000_000,
                          "capacity_bytes": 1_000_000_000,
                          "zombie_segments": 1, "zombies_swept_total": 4,
                          "fallback_bytes": 2_000_000}}}}


def _dag(acc: str) -> dict:
    edge = {"edge": 0, "role": "input", "producer": {"label": "driver"},
            "consumer": {"label": "Learner.step"}, "kind": "device",
            "transport": "shm", "device_arrays": 3, "ticks": 10,
            "reads": 10, "bytes": 4096, "occupancy": 1,
            "write_block_s": 0.1, "read_block_s": 0.2,
            "stall": {"blocked": "read", "blocked_s": 2.5,
                      "dead_peer": True, "culprit": "Learner.step"}}
    return {"dag_id": "e" * 32, "state": "RUNNING", "job_id": "f" * 32,
            "num_edges": 2, "channel_kinds": {"device": 1, "shm": 1,
                                              "dcn": 0},
            "stalled_edges": [0],
            "edges": [edge, dict(edge, edge=1, kind="shm", stall=None,
                                 role="output")]}


def _requests(acc: str) -> dict:
    return {"requests": [{
        "request_id": "r" * 16, "app": "llm", "outcome": "ok",
        "e2e_s": 1.2, "ttft_s": 0.3, "tpot_s": 0.04,
        "stages": {"admission_s": 0.001, "router_s": 0.002,
                   "dispatch_s": 0.003, "stream_s": 1.1},
        "replica_stages": {"queue_s": 0.01, "service_s": 1.1},
        "engine": {"queue_s": 0.02, "prefill_s": 0.2, "prefill_chunks": 2,
                   "ttft_s": 0.3, "tpot_s": 0.04, "occupancy_mean": 0.5,
                   "prefix_cache": "hit", "prefix_hit_tokens": 16,
                   "kv_handoff_bytes": 1024, "kv_handoff_edge": "shm"},
        "model_id": "ad-a", "affinity": "hit", "proxy": "http"}],
        "dropped": {"llm": 1}, "sampled_out": {"llm": 2}, "total": 1,
        "truncated": 0}


def _steps(acc: str) -> dict:
    return {"steps": [{"run_id": "1" * 32, "experiment": "obs-wf",
                       "rank": 0, "step": 3, "wall_s": 0.32,
                       "stages": {"data_wait_s": 0.001, "h2d_s": 0.002,
                                  "step_s": 0.3, "ckpt_block_s": 0.0},
                       "ckpt_commit_s": 0.05, "loss": 2.3456}],
            "dropped": {"run": 1}, "total": 1, "truncated": 0}


def _roll(p50: float) -> dict:
    return {"p50": p50, "p99": 2 * p50, "mean": 1.5 * p50, "n": 4}


def _serve_waterfall(acc: str) -> dict:
    return {"apps": {"llm": {"count": 4, "outcomes": {"ok": 3, "shed": 1},
                             "e2e": _roll(1.2), "ttft": _roll(0.3),
                             "tpot": _roll(0.04),
                             "stages": {"admission_s": _roll(0.001),
                                        "stream_s": _roll(1.1)}}},
            "dropped": {"llm": 1}, "sampled_out": {}, "finalized_total": 4,
            "total_requests": 4}


def _train_waterfall(acc: str) -> dict:
    return {"runs": {"1" * 32: {
        "experiment": "surfaces", "state": "FINISHED", "world_size": 1,
        "steps": 3, "last_step": 3, "wall": _roll(0.32),
        "stages": {"data_wait_s": _roll(0.001), "step_s": _roll(0.3)},
        "compile_count": 1, "retrace_count": 0,
        "memory_used_bytes": 9e9, "memory_peak_bytes": 2e10,
        "stalled_workers": {0: {"attribution": "ingest", "step": 2,
                                "blocked_s": 6.0, "phase": "data_wait"}},
        "starved_workers": {0: {"share": 0.4, "data_wait_s": 0.4,
                                "wall_s": 1.0}}}},
        "dropped": {}}


RENDERERS = {"_print_cluster_status": _cluster_status,
             "_print_why_pending": _why_pending,
             "_print_task_summary": _task_summary,
             "_print_object_summary": _object_summary,
             "_print_dag": _dag, "_print_requests": _requests,
             "_print_steps": _steps,
             "_print_serve_waterfall": _serve_waterfall,
             "_print_train_waterfall": _train_waterfall}


def _printed(fn, snapshot) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(snapshot)
    return buf.getvalue()


@pytest.mark.parametrize("name", sorted(RENDERERS))
def test_renderers_print_what_the_reference_prints(name):
    """Each pure renderer of the CLI, fed the same snapshot (the
    reference's with "TPU" where the port's has "GPU"), prints the same
    text but for that resource name."""
    make = RENDERERS[name]
    ours = _printed(getattr(tcli, name), make("GPU"))
    theirs = _printed(getattr(jcli, name), make("TPU"))
    assert ours.strip()
    assert ours == theirs.replace("TPU", "GPU")


# -------------------------------------------- util: Pool and joblib
_POOL = """
import json
import {pkg} as rt
from {pkg}.util.multiprocessing import Pool
from {pkg}.util.joblib_backend import register_rayt
import joblib


def square(x):
    return x * x


def add(a, b):
    return a + b


rt.init(num_cpus=2)
with Pool(processes=2) as pool:
    out = {{"map": pool.map(square, range(8)),
           "starmap": pool.starmap(add, [(i, 10 * i) for i in range(5)]),
           "imap": list(pool.imap(square, range(6))),
           "imap_unordered": sorted(pool.imap_unordered(square, range(6))),
           "apply": pool.apply(add, (2, 3))}}
register_rayt()
with joblib.parallel_backend("rayt", n_jobs=2):
    out["joblib"] = joblib.Parallel()(
        joblib.delayed(square)(i) for i in range(6))
rt.shutdown()
print("RESULT", json.dumps(out))
"""


def test_pool_and_joblib_backend_match_the_reference():
    """Pool.map / starmap / imap / imap_unordered / apply and the "rayt"
    joblib backend return the same results as the reference's, each on a
    local cluster of its own package."""
    ours = _result(_run(_POOL.format(pkg="ray_tpu_torch")))
    theirs = _result(_run(_POOL.format(pkg="ray_tpu")))
    assert ours == theirs
    assert ours["map"] == [i * i for i in range(8)]
    assert ours["joblib"] == [i * i for i in range(6)]


# -------------------------------------------------------- start --head
_START = """
import contextlib, functools, io, json, os, sys
from ray_tpu_torch._internal import accelerators
from ray_tpu_torch.scripts import cli

# a probe that reports {cards!r}, as nvidia-smi would
accelerators.detect_gpus = functools.partial(
    accelerators.detect_gpus, env={{}}, probe=lambda: {cards!r})
state = {state!r}
cli.PIDFILE, cli.ADDRFILE, cli.DASHFILE = (
    os.path.join(state, "head.pid"), os.path.join(state, "head.addr"),
    os.path.join(state, "head.dashboard"))
out = {{}}
try:
    cli.main(["start", "--head", "--num-cpus", "1", "--dashboard-port", "-1",
              *{extra!r}])
    with open(cli.ADDRFILE) as f:
        address = f.read().strip()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["status", "--address", address])
    out["status"] = buf.getvalue()
    import ray_tpu_torch as rt
    [node] = rt.nodes()
    out["resources"] = node.resources_total
    out["labels"] = node.labels
    rt.shutdown()
finally:
    cli.main(["stop"])
print("RESULT", json.dumps(out))
"""


@pytest.mark.parametrize("extra,gpus", [((), 1.0),
                                        (("--num-gpus", "0"), None)])
def test_start_head_autodetects_the_gpu(extra, gpus, tmp_path):
    """`start --head` with no flag advertises the GPU the probe reports
    and labels the head with the part's name, as rt.init() does;
    `--num-gpus 0` advertises no GPU. `status` prints the GPU line."""
    out = _result(_run(_START.format(cards=[H100], state=str(tmp_path),
                                     extra=list(extra))))
    assert out["resources"].get("GPU") == gpus
    if gpus:
        assert out["labels"]["gpu-type"] == H100
        assert out["labels"]["gpu-count"] == "1"
        assert "GPU: 1/1 available" in out["status"]
    else:
        assert "gpu-type" not in out["labels"]
        assert "GPU" not in out["status"]


def test_cli_state_lives_apart_from_the_reference():
    """The CLI keeps its head's pid, address and dashboard files in a
    directory of its own, so a `stop` of one package's head never reads
    the other's."""
    ours = {tcli.PIDFILE, tcli.ADDRFILE, tcli.DASHFILE}
    theirs = {jcli.PIDFILE, jcli.ADDRFILE, jcli.DASHFILE}
    assert {os.path.dirname(p) for p in ours} == {
        os.path.join(tempfile.gettempdir(), "ray_tpu_torch")}
    assert not ours & theirs


def test_job_logs_live_under_tmpdir(tmp_path, monkeypatch):
    """A job's log file lies under the process's temp dir, beside the
    CLI's head state, so two heads on one machine (two checkouts, or both
    packages) never open the same job's log."""
    from ray_tpu_torch.dashboard.head import JobManager

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    jm = JobManager("127.0.0.1:0")
    try:
        sub = jm.submit("echo logged", submission_id="same-id")
        deadline = time.monotonic() + 30
        while jm.status(sub)["status"] == "RUNNING" \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert jm.status(sub)["status"] == "SUCCEEDED"
        assert jm.jobs[sub]["log_path"] == os.path.join(
            str(tmp_path), "ray_tpu_torch", "jobs", "same-id.log")
        assert jm.logs(sub).strip() == "logged"
    finally:
        jm.shutdown()


@pytest.mark.parametrize("argv",[["up", "cluster.yaml"], ["down"],
                                  ["exec", "default", "--", "ls"],
                                  ["attach"]])
def test_launcher_subcommands_name_their_roadmap_item(argv, monkeypatch):
    """up, down, exec and attach (item 8b) drive the port's launcher."""
    from ray_tpu_torch.scripts import launcher

    calls = []
    for fn in ("up", "down", "exec_cmd", "attach"):
        monkeypatch.setattr(launcher, fn,
                            lambda *a, fn=fn: calls.append((fn, *a)) or 0)
    try:
        tcli.main(argv)
    except SystemExit as e:
        assert e.code == 0
    assert calls == [{"up": ("up", "cluster.yaml"),
                      "down": ("down", "default"),
                      "exec": ("exec_cmd", "default", ["ls"]),
                      "attach": ("attach", "default")}[argv[0]]]


def test_spawn_has_no_site_import_modes():
    """The port's spawn drops the reference's PJRT site-import modes
    (there is no PJRT plugin to defer): children start with -S and the
    site-packages dirs on PYTHONPATH, and nothing replays sitecustomize
    or reads RAYT_SITE_IMPORT."""
    from ray_tpu._internal import spawn as jspawn
    from ray_tpu_torch._internal import spawn

    assert hasattr(jspawn, "import_site_background")
    for name in ("import_site_background", "wait_site_ready",
                 "_site_thread", "_site_wanted"):
        assert not hasattr(spawn, name), name
    with open(spawn.__file__) as f:
        assert "RAYT_SITE_IMPORT" not in f.read()
    assert spawn.fast_python_argv("m")[1:] == ["-S", "-m", "m"]


# ------------------------------------------- dashboard: device memory
def _get(port: int, path: str) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.read().decode()


def test_dashboard_train_view_and_metrics_carry_cuda_memory():
    """A worker's memory snapshot naming cuda:0 (what
    train/telemetry.device_memory_snapshot records on the card) reaches
    /api/train's run record and summary, and /metrics' device gauge."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.train import telemetry

    cluster = Cluster(head_resources={"CPU": 2.0}, dashboard_port=0)
    cluster.connect()
    try:
        port = cluster.dashboard_port
        rid = telemetry.mint_run_id()
        used, peak = 9_876_543_210, 12_345_678_901
        telemetry.publish_record({
            "kind": "run", "run_id": rid, "experiment": "cuda-mem",
            "job_id": "", "world_size": 1, "state": "RUNNING",
            "ts": time.time()})
        telemetry.publish_record({
            "kind": "step", "run_id": rid, "experiment": "cuda-mem",
            "rank": 0, "step": 1, "wall_s": 0.3,
            "stages": {"data_wait_s": 0.01, "h2d_s": 0.01, "step_s": 0.28,
                       "ckpt_block_s": 0.0}, "ts": time.time()})
        telemetry.publish_record({
            "kind": "memory", "run_id": rid, "rank": 0, "node_id": "n0",
            "devices": [{"device": "cuda:0", "bytes_in_use": used,
                         "peak_bytes": peak}], "ts": time.time()})
        deadline = time.monotonic() + 30
        while True:
            state = json.loads(_get(port, "/api/train"))
            runs = [r for r in state["runs"] if r["run_id"] == rid]
            if runs and (runs[0]["workers"].get("0") or {}).get(
                    "memory") and rid in state["summary"]["runs"]:
                break
            assert time.monotonic() < deadline, state
            time.sleep(0.3)
        [dev] = runs[0]["workers"]["0"]["memory"]["devices"]
        assert dev == {"device": "cuda:0", "bytes_in_use": used,
                       "peak_bytes": peak}
        assert state["summary"]["runs"][rid]["memory_used_bytes"] == used
        text = ""
        while 'device="cuda:0"' not in text:
            assert time.monotonic() < deadline, text[-2000:]
            text = _get(port, "/metrics")
            time.sleep(0.3)
        line = next(ln for ln in text.splitlines()
                    if ln.startswith("rayt_device_memory_used_bytes")
                    and 'device="cuda:0"' in ln)
        assert float(line.rsplit(" ", 1)[1]) == used
    finally:
        rt.shutdown()
        cluster.shutdown()


# ---------------------------------------------------------- the client
_CLIENT = """
import json, sys
from ray_tpu_torch import client

ctx = client.connect({addr!r})


@ctx.remote(num_gpus=1)
def leased():
    from ray_tpu_torch.core.object_ref import get_core_worker

    return get_core_worker().leased_gpus


@ctx.remote
def unleased():
    from ray_tpu_torch.core.object_ref import get_core_worker

    return get_core_worker().leased_gpus


out = {{"gpu": ctx.get(leased.remote(), timeout=60),
       "cpu": ctx.get(unleased.remote(), timeout=60)}}
ctx.disconnect()
out["torch"] = "torch" in sys.modules
print("RESULT", json.dumps(out))
"""


def test_list_actors_shows_required_resources():
    """`list actors` shows what each actor holds while it lives: a GPU
    actor's required_resources carry the GPU (the chip run reads the
    TrainWorker's this way)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import state_api

    rt.init(num_cpus=2, resources={"GPU": 1})
    try:
        @rt.remote(num_gpus=1, num_cpus=0)
        class Holder:
            def ping(self):
                return 1

        h = Holder.remote()
        assert rt.get(h.ping.remote(), timeout=60) == 1
        [row] = [a for a in state_api.list_actors()
                 if a["class_name"] == "Holder"]
        assert row["state"] == "ALIVE"
        assert row["required_resources"] == {"GPU": 1.0}
        rt.kill(h)
    finally:
        rt.shutdown()


def test_client_gpu_task_runs_in_a_gpu_leased_worker():
    """A num_gpus=1 task sent through the client proxy runs in a worker
    whose lease holds the GPU (a plain task's holds none), and the client
    process imports no torch."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.runtime import get_runtime_context

    rt.init(num_cpus=2, resources={"GPU": 1})
    proxy = None
    try:
        gcs = get_runtime_context().gcs_address
        proxy = subprocess.Popen(
            [sys.executable, "-c",
             "from ray_tpu_torch.client.server import main; "
             f"main('{gcs.host}:{gcs.port}', port=0)"],
            cwd=ROOT, env=_env(), stdout=subprocess.PIPE, text=True)
        port = json.loads(proxy.stdout.readline())["client_port"]
        out = _result(_run(_CLIENT.format(addr=f"127.0.0.1:{port}")))
    finally:
        if proxy is not None:
            proxy.terminate()
            proxy.wait(timeout=10)
        rt.shutdown()
    assert out["gpu"] and not out["cpu"]
    assert out["torch"] is False
