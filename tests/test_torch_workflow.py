"""The port's durable workflows, and the slice as a whole against ray_tpu.

- The reference's ``tests/test_workflow.py`` runs re-pointed at the port
  through ``torch_repoint`` (checkpoints, resume, step identity, branches,
  continuations, events).
- The slice as a whole: a ``Cluster`` whose autoscaler (the local
  provider) knows one node type advertising a custom ``trainer`` resource
  that no node has yet. A driver process runs a three-step workflow:
  ``batch`` makes a numpy batch from a seed, ``train`` submits a task that
  demands ``trainer`` (so the autoscaler launches the node) and runs the
  port's ``build_train_step`` on the ``debug`` preset for 2 steps on the
  CPU, ``report`` sums up once the harness's ``go`` event arrives. The
  driver is SIGKILLed as soon as ``train``'s checkpoint lands, the event
  is sent, and a second driver resumes the workflow. The losses
  equal ray_tpu's train step (optax AdamW) on the same numpy params and
  batch to 1e-5 relative (the train step's parity tolerance,
  ``test_torch_train_step.py``); the resume re-runs neither ``batch`` nor
  ``train``, and its output carries the checkpointed losses bit for bit.
"""

import glob
import json
import os
import pickle
import signal
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from torch_repoint import run_repointed
from ray_tpu.models import llama as jllama
from ray_tpu.parallel.mesh import build_mesh
from ray_tpu.parallel.spmd import build_train_step as jax_build_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, LR, LOSS_RTOL = 2, 3e-4, 1e-5


def test_reference_workflow_file_passes_on_the_port(tmp_path):
    run_repointed("test_workflow", 6, tmp_path, timeout=170)


DRIVER = textwrap.dedent('''
    import os, sys
    import numpy as np
    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow

    STORE, MARKS, PARAMS, MODE = sys.argv[1:5]

    def mark(name):
        with open(os.path.join(MARKS, name), "a") as f:
            f.write("x")

    @rt.remote(num_cpus=1, resources={"trainer": 1})
    def train_on_node(batch, steps, lr):
        import torch

        from ray_tpu_torch.models import llama
        from ray_tpu_torch.models.convert import params_from_numpy
        from ray_tpu_torch.parallel.spmd import adamw, build_train_step

        cfg = llama.config_for("debug", dtype=torch.float32, remat=False,
                               attn_impl="xla")
        params = dict(np.load(PARAMS, allow_pickle=True)["params"].item())
        step, state = build_train_step(
            lambda p, b: llama.loss_fn(p, b, cfg), adamw(lr),
            params_from_numpy(params, device="cpu"), device="cpu")
        tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
        losses = []
        for _ in range(steps):
            state, aux = step(state, tb)
            losses.append(float(aux["loss"]))
        return losses, os.environ["RAYT_NODE_ID"]

    @workflow.step
    def batch(seed):
        mark("batch")
        rng = np.random.default_rng(seed)
        tokens = rng.integers(0, 256, (4, 32)).astype(np.int32)
        return {"tokens": tokens, "targets": np.roll(tokens, -1, 1)}

    @workflow.step
    def train(b, steps, lr):
        mark("train")
        losses, node = rt.get(train_on_node.remote(b, steps, lr))
        return {"losses": losses, "node_id": node}

    @workflow.step
    def report(out, go):
        mark("report")
        return {**out, "first_loss": out["losses"][0]}

    rt.init(address=os.environ["RAYT_ADDRESS"])
    # report waits for the harness's "go" event too: the first driver is
    # killed with train checkpointed and report not yet run
    final = report.bind(train.bind(batch.bind(0), %(steps)d, %(lr)r),
                        workflow.wait_for_event("go"))
    if MODE == "run":
        out = workflow.run(final, workflow_id="slice", storage=STORE)
    else:
        out = workflow.resume("slice", final, storage=STORE)
    print("OUTPUT", repr(out), flush=True)
    rt.shutdown()
''') % {"steps": STEPS, "lr": LR}


def _reference_losses(params, batch):
    jcfg = jllama.config_for("debug", dtype=jnp.float32, remat=False,
                             attn_impl="xla")
    step, state = jax_build_train_step(
        lambda p, b: jllama.loss_fn(p, b, jcfg), optax.adamw(LR),
        jax.tree.map(jnp.asarray, params), jllama.param_logical_axes(jcfg),
        build_mesh({"data": 1}, jax.devices()[:1]))
    losses = []
    for _ in range(STEPS):
        state, aux = step(state, jax.tree.map(jnp.asarray, batch))
        losses.append(float(aux["loss"]))
    return losses


def test_autoscaled_workflow_survives_its_driver_and_matches_ray_tpu(
        tmp_path):
    from ray_tpu_torch import workflow
    from ray_tpu_torch.cluster_utils import Cluster

    jcfg = jllama.config_for("debug", dtype=jnp.float32)
    params = jax.tree.map(np.asarray,
                          jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    np.savez(tmp_path / "params.npz",
             params=np.array(params, dtype=object))
    store, marks = tmp_path / "store", tmp_path / "marks"
    marks.mkdir()
    (tmp_path / "driver.py").write_text(DRIVER)
    cluster = Cluster(head_resources={"CPU": 2.0}, autoscaler_config={
        "node_types": [{"name": "trainer", "max_slices": 1,
                        "resources_per_host": {"CPU": 2.0, "trainer": 1.0}}],
        "idle_timeout_s": 600.0, "reconcile_interval_s": 0.3})
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
           "RAYT_ADDRESS": cluster.address}

    def driver(mode):
        return subprocess.Popen(
            [sys.executable, str(tmp_path / "driver.py"), str(store),
             str(marks), str(tmp_path / "params.npz"), mode],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    try:
        first = driver("run")
        deadline = time.monotonic() + 150
        while not glob.glob(str(store / "slice" / "steps" / "train-*.pkl")):
            assert first.poll() is None, first.communicate()[1][-3000:]
            assert time.monotonic() < deadline, "train never checkpointed"
            time.sleep(0.05)
        first.send_signal(signal.SIGKILL)
        first.wait(timeout=30)
        with open(glob.glob(str(store / "slice" / "steps" /
                                "train-*.pkl"))[0], "rb") as f:
            trained = pickle.load(f)
        meta = json.loads((store / "slice" / "meta.json").read_text())
        assert meta["status"] == "RUNNING"   # the driver died mid-run
        assert not (marks / "report").exists()

        workflow.send_event("slice", "go", storage=str(store))
        second = driver("resume")
        out, err = second.communicate(timeout=150)
        assert second.returncode == 0, err[-3000:]
        nodes = {n["node_id"]: n for n in _nodes(cluster)}
    finally:
        cluster.shutdown()

    output = workflow.get_output("slice", storage=str(store))
    assert output["losses"] == trained["losses"]      # bit for bit
    assert output["first_loss"] == trained["losses"][0]
    assert "OUTPUT" in out
    # batch and train ran once, in the killed run; report in the resume
    assert (marks / "batch").read_text() == "x"
    assert (marks / "train").read_text() == "x"
    assert (marks / "report").read_text() == "x"
    # the train task ran on the node the autoscaler launched for it
    labels = nodes[trained["node_id"]]["labels"]
    assert labels["autoscaled"] == "1" and labels["node_type"] == "trainer"

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (4, 32)).astype(np.int32)
    want = _reference_losses(params, {"tokens": tokens,
                                      "targets": np.roll(tokens, -1, 1)})
    np.testing.assert_allclose(trained["losses"], want, rtol=LOSS_RTOL)
    assert want[-1] < want[0]


def _nodes(cluster):
    """Every node the GCS has seen, read over a connection of this
    process's own (the drivers have exited)."""
    code = ("import json, os, ray_tpu_torch as rt; "
            "rt.init(address=os.environ['RAYT_ADDRESS']); "
            "print(json.dumps(rt.state_api.list_nodes())); rt.shutdown()")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=60, check=True,
        env={**os.environ, "PYTHONPATH": ROOT,
             "RAYT_ADDRESS": cluster.address})
    return json.loads(out.stdout.strip().splitlines()[-1])
