"""The port's train runtime (ray_tpu_torch.train, util.collective's host
tier, data.llm_corpus) on the CPU: the torch twins of the reference's
jax-bodied train tests (deselected from the re-pointed files by
``torch_repoint.DESELECT``), parity with ray_tpu on the same numpy inputs,
and the slice as a whole, a TorchTrainer LoRA fit that dies once and
resumes, held against ray_tpu's train step.

Tolerances: checkpoint leaves and token streams bit for bit; the LoRA
fit's reported losses 1e-4 relative against ray_tpu's build_train_step
with optax.adamw (debug preset, f32); a resumed fit's final loss against
an uninterrupted one's 1e-6 (the reference's own bound)."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.data import llm_corpus as jcorpus
from ray_tpu.models import llama as jllama
from ray_tpu.models import lora as jlora
from ray_tpu.parallel.mesh import build_mesh
from ray_tpu.parallel.spmd import build_train_step as jax_build_train_step
from ray_tpu.train import checkpoint as jckpt
from ray_tpu_torch import train
from ray_tpu_torch.data import llm_corpus as tcorpus
from ray_tpu_torch.models import lora as tlora
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.train import checkpoint as tckpt
from ray_tpu_torch.train.ingest import CorpusIngestIterator, IngestSpec
from ray_tpu_torch.train.session import TrainContext
from ray_tpu_torch.util.collective import collective as tcoll

LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def cluster():
    """One CPU cluster with a (fake) GPU for the whole module."""
    rt.init(num_cpus=4, resources={"GPU": 1})
    try:
        yield rt
    finally:
        rt.shutdown()


def _run(tmp_path, name):
    return train.RunConfig(name=name, storage_path=str(tmp_path))


# --------------------------------------------------------- checkpoints
def test_save_load_pytree_torch(tmp_path):
    """Twin of test_train.py::test_save_load_pytree with torch leaves."""
    state = {"w": torch.arange(6.0).reshape(2, 3),
             "step": torch.tensor(7, dtype=torch.int32)}
    tckpt.save_pytree(state, str(tmp_path / "ck"))
    loaded = tckpt.load_pytree(str(tmp_path / "ck"))
    np.testing.assert_allclose(np.asarray(loaded["w"]),
                               np.arange(6.0).reshape(2, 3))
    assert int(loaded["step"]) == 7


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16, torch.int32, torch.int64,
                                   torch.uint8])
def test_pytree_leaves_round_trip_bit_for_bit(dtype, tmp_path):
    """Every dtype comes back with its bits: bf16 as a CPU bf16 tensor
    (numpy has no bf16 here), the rest as numpy; nested lists, tuples,
    None and scalars keep their structure; a non-contiguous leaf and a
    0-d leaf too."""
    gen = torch.Generator().manual_seed(0)
    if dtype.is_floating_point:
        w = (torch.randn(5, 7, generator=gen) * 100).to(dtype)
    else:
        w = torch.randint(0, 200, (5, 7), generator=gen).to(dtype)
    state = {"w": w, "t": w.t(), "s": w[0, 0], "nest": [(w, 3), None],
             "x": np.arange(3.0)}
    h = tckpt.save_pytree_async(state, str(tmp_path / "ck"))
    w.add_(1)  # the host copy was staged before the save returned
    h.wait()
    out = tckpt.load_pytree(str(tmp_path / "ck"))

    def bits(x):
        t = torch.as_tensor(x)
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    want = w - 1
    for got, ref in ((out["w"], want), (out["t"], want.t()),
                     (out["s"], want[0, 0]), (out["nest"][0][0], want)):
        if dtype == torch.bfloat16:
            assert isinstance(got, torch.Tensor) and got.dtype == dtype
        else:
            assert isinstance(got, np.ndarray)
        assert torch.equal(bits(got), bits(ref))
    assert int(out["nest"][0][1]) == 3 and out["nest"][1] is None
    np.testing.assert_array_equal(out["x"], state["x"])


def test_port_checkpoint_reads_the_same_in_ray_tpu(tmp_path):
    """The port writes the JAX package's pickle format: ray_tpu's
    load_pytree reads the same f32 and int leaves, and a bf16 leaf's
    bits under its tag."""
    w = torch.randn(4, 8, generator=torch.Generator().manual_seed(1))
    state = {"lora": {"a": w, "b": w.to(torch.bfloat16)},
             "step": 12, "ids": torch.arange(5, dtype=torch.int32)}
    tckpt.save_pytree(state, str(tmp_path))
    ref = jckpt.load_pytree(str(tmp_path))
    ours = tckpt.load_pytree(str(tmp_path))
    np.testing.assert_array_equal(ref["lora"]["a"], w.numpy())
    np.testing.assert_array_equal(ref["ids"], np.arange(5, dtype=np.int32))
    assert ref["ids"].dtype == np.int32 and int(ref["step"]) == 12
    np.testing.assert_array_equal(
        ref["lora"]["b"].view(np.uint16),
        w.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(ours["lora"]["a"], ref["lora"]["a"])
    assert torch.equal(ours["lora"]["b"], w.to(torch.bfloat16))


def test_orbax_directory_raises(tmp_path):
    """A directory holding an orbax checkpoint (the JAX package writes
    one when orbax is importable) is refused by name."""
    (tmp_path / "pytree").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        tckpt.load_pytree(str(tmp_path))


# ------------------------------------------------------ telemetry, session
def _recorder():
    from ray_tpu_torch.train.telemetry import StepRecorder

    class _FakeCW:
        gcs = object()

        def _spawn_from_thread(self, coro):
            coro.close()

    rec = StepRecorder("a" * 32, "unit", rank=0, node_id="n" * 8)
    fake = _FakeCW()
    rec._pub._core_worker = lambda: fake
    return rec


def _compile_events(rec):
    with rec._pub._lock:
        out, rec._pub._buf = rec._pub._buf, []
    return [x for x in out if x["kind"] == "compile"]


def test_recorder_wrap_jit_torch_tensors():
    """Twin of test_train_observability.py::
    test_recorder_wrap_jit_compile_and_retrace with torch tensors: the
    first call per shape is a compile event, a new shape a retrace with
    the delta; a dict of tensors flattens into the signature."""
    rec = _recorder()
    wrapped = rec.wrap_jit(lambda x: {"y": x * 2}, "f")
    assert float(wrapped(torch.ones(4))["y"][0]) == 2.0
    (r,) = _compile_events(rec)
    assert r["event"] == "compile" and r["fn"] == "f"
    assert r["compile_s"] >= 0 and r["shape"] == "(torch.float32[4])"
    wrapped(torch.ones(4))
    assert not _compile_events(rec)
    wrapped(torch.ones(8))
    (r2,) = _compile_events(rec)
    assert r2["event"] == "retrace"
    assert r2["prev_shape"] == r["shape"] and "8" in r2["shape"]
    step = rec.wrap_jit(lambda state, batch: state, "step")
    step({"w": torch.zeros(2, 3)}, {"tokens": torch.zeros(4, 16).long()})
    (r3,) = _compile_events(rec)
    assert r3["shape"] == "(torch.float32[2,3], torch.int64[4,16])"


def test_memory_snapshot_falls_back_to_host_rss_without_cuda():
    from ray_tpu_torch.train.telemetry import device_memory_snapshot

    assert not torch.cuda.is_initialized()
    (dev,) = device_memory_snapshot()
    assert dev["device"] == "host:0" and dev["bytes_in_use"] > 0


def test_get_device_follows_use_gpu_and_never_falls_back(tmp_path):
    ctx = TrainContext(0, 1, str(tmp_path), "x", None, use_gpu=False)
    assert ctx.get_device() == torch.device("cpu")
    # a mesh over GPU workers needs each lease pinned to its own card
    two = TrainContext(0, 2, str(tmp_path), "x", None, use_gpu=True)
    with pytest.raises(NotImplementedError, match="item 6"):
        two.get_mesh()
    gpu = TrainContext(0, 1, str(tmp_path), "x", None, use_gpu=True)
    if torch.cuda.is_available():
        assert gpu.get_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA"):
            gpu.get_device()
    assert train.ScalingConfig().worker_resources() == {"CPU": 1.0,
                                                         "GPU": 1.0}
    assert train.ScalingConfig(use_gpu=False).worker_resources() == {
        "CPU": 1.0}


def test_actor_options_map_gpu_to_num_gpus():
    from ray_tpu_torch.train.worker_group import actor_options_from_resources

    assert actor_options_from_resources({"CPU": 2, "GPU": 1, "x": 3}) == {
        "max_concurrency": 2, "num_cpus": 2, "num_gpus": 1,
        "resources": {"x": 3}}


# --------------------------------------------------------- corpus, ingest
def _make_corpus(root, *, shards=5, docs=25, seed=1):
    corpus = os.path.join(root, "corpus")
    os.makedirs(corpus, exist_ok=True)
    rng = np.random.default_rng(seed)
    for s in range(shards):
        with open(os.path.join(corpus, f"s{s:03d}.jsonl"), "w") as f:
            for _ in range(docs):
                toks = rng.integers(1, 100, rng.integers(5, 60)).tolist()
                f.write(json.dumps({"tokens": toks}) + "\n")
    return corpus


def _assert_state_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2)])
def test_token_corpus_matches_reference(rank, world, tmp_path):
    """The port's TokenCorpus gives ray_tpu's blocks, segment ids and
    cursor state_dict on the same jsonl corpus, straight through and
    after a resume from every cursor of the stream."""
    corpus = _make_corpus(str(tmp_path))
    kw = dict(seq_len=32, dp_rank=rank, world_size=world, eos_id=0,
              epochs=2)
    ref = jcorpus.TokenCorpus(corpus, **kw)
    ours = tcorpus.TokenCorpus(corpus, **kw)
    assert ours.shards == ref.shards
    blocks, states = [], [ref.state_dict()]
    for rb, ob in zip(ref, ours, strict=True):
        assert np.array_equal(rb["tokens"], ob["tokens"])
        assert np.array_equal(rb["segment_ids"], ob["segment_ids"])
        assert ob["tokens"].dtype == rb["tokens"].dtype
        _assert_state_equal(ref.state_dict(), ours.state_dict())
        blocks.append(rb)
        states.append(ref.state_dict())
    assert len(blocks) > 20
    for k, state in enumerate(states):
        resumed = tcorpus.TokenCorpus(corpus, **kw)
        resumed.load_state_dict(state)
        rest = list(resumed)
        assert len(rest) == len(blocks) - k, k
        for want, got in zip(blocks[k:], rest):
            assert np.array_equal(want["tokens"], got["tokens"])
            assert np.array_equal(want["segment_ids"], got["segment_ids"])


def test_corpus_paths_not_ported_raise(tmp_path):
    """The corpus paths that raised before the data plane was ported
    (shard tasks, build_corpus) now take the reference's arguments; the
    streams and shards they give are held against ray_tpu in
    tests/test_torch_data.py."""
    import inspect

    corpus = _make_corpus(str(tmp_path), shards=1)
    ours = tcorpus.TokenCorpus(corpus, seq_len=8, shard_tasks=True,
                               max_in_flight=2)
    assert ours.shard_tasks and ours.max_in_flight == 2
    assert not hasattr(tcorpus, "_NOT_PORTED")
    for name in ("build_corpus", "load_shard_docs", "read_token_corpus"):
        assert (inspect.signature(getattr(tcorpus, name))
                == inspect.signature(getattr(jcorpus, name))), name


def test_ingest_on_a_device_yields_the_numpy_stream_as_tensors(tmp_path):
    corpus = _make_corpus(str(tmp_path))
    spec = IngestSpec(paths=corpus, seq_len=16, batch_blocks=4, eos_id=0)
    plain = CorpusIngestIterator(spec)
    on_cpu = CorpusIngestIterator(spec, device="cpu")
    n = 0
    for want, got in zip(plain, on_cpu, strict=True):
        assert isinstance(want["tokens"], np.ndarray)
        assert isinstance(got["tokens"], torch.Tensor)
        assert got["tokens"].device.type == "cpu"
        assert np.array_equal(got["tokens"].numpy(), want["tokens"])
        assert np.array_equal(got["segment_ids"].numpy(),
                              want["segment_ids"])
        n += 1
    assert n > 5
    _assert_state_equal(plain.state_dict(), on_cpu.state_dict())


# ------------------------------------------------------- host collectives
def test_collective_backends_and_tensor_arguments():
    with pytest.raises(NotImplementedError, match="item 6"):
        tcoll.init_collective_group(2, 0, backend="nccl")
    with pytest.raises(ValueError, match="unsupported backend"):
        tcoll.init_collective_group(2, 0, backend="mpi")
    out = tcoll._host(torch.arange(4, dtype=torch.int32))
    assert isinstance(out, np.ndarray) and out.dtype == np.int32
    with pytest.raises(TypeError, match="bfloat16"):
        tcoll._host(torch.zeros(2, dtype=torch.bfloat16))


def test_collective_takes_tensors_and_returns_numpy(cluster):
    """A torch.Tensor argument reduces like the numpy one and comes back
    as numpy (the reference returns numpy for a jax.Array)."""
    @rt.remote
    class Member:
        def run(self, rank, world):
            import torch

            from ray_tpu_torch.util import collective

            collective.init_collective_group(world, rank, group_name="t")
            out = collective.allreduce(torch.full((3,), rank + 1.0),
                                       group_name="t")
            got = collective.allgather(torch.tensor([rank]), group_name="t")
            collective.destroy_collective_group("t")
            return type(out).__module__, out, [int(g[0]) for g in got]

    members = [Member.remote() for _ in range(2)]
    outs = rt.get([m.run.remote(i, 2) for i, m in enumerate(members)],
                  timeout=120)
    for module, out, gathered in outs:
        assert module == "numpy"
        np.testing.assert_array_equal(out, np.full(3, 3.0, np.float32))
        assert gathered == [0, 1]
    for m in members:
        rt.kill(m)


# -------------------------------------------------------------- trainer
def _mlp_loop(config):
    """Twin body of test_train.py::_mlp_train_loop: the port's MLP on
    get_device(), AdamW, a checkpoint every epoch."""
    import tempfile

    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.mlp import MLPConfig, mlp_init, mlp_loss
    from ray_tpu_torch.parallel.spmd import adamw, build_train_step
    from ray_tpu_torch.train.checkpoint import (Checkpoint, load_pytree,
                                                save_pytree)

    ctx = train.get_context()
    device = ctx.get_device()
    try:
        ctx.get_mesh()
        mesh = "built"
    except NotImplementedError as e:
        mesh = str(e)
    cfg = MLPConfig(in_dim=16, hidden=(32,), n_classes=4)
    step, state = build_train_step(mlp_loss, adamw(1e-2),
                                   mlp_init(cfg, device=device),
                                   device=device)
    rng = np.random.RandomState(ctx.get_world_rank())
    x = rng.randn(64, 16).astype("float32")
    y = (x.sum(-1) > 0).astype("int64") % 4
    batch = {"x": torch.from_numpy(x).to(device),
             "y": torch.from_numpy(y).to(device)}
    start_epoch = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        start_epoch = int(load_pytree(
            ckpt.subdir(f"rank_{ctx.get_world_rank()}").path)["epoch"]) + 1
    for epoch in range(start_epoch, config["epochs"]):
        for _ in range(5):
            state, aux = step(state, batch)
        with tempfile.TemporaryDirectory() as d:
            save_pytree({"epoch": epoch}, d)
            train.report({"loss": float(aux["loss"]), "epoch": epoch,
                          "device": str(device), "mesh": mesh},
                         checkpoint=Checkpoint(d))


def test_torch_trainer_mlp_on_get_device(cluster, tmp_path):
    """The MLP loop trains on get_device() (the CPU when asked), a
    one-worker get_mesh() builds its one-rank gloo mesh, and the fit ends
    with its last checkpoint."""
    result = train.TorchTrainer(
        _mlp_loop, train_loop_config={"epochs": 3},
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=False),
        run_config=_run(tmp_path, "mlp")).fit()
    assert result.error is None and result.metrics["epoch"] == 2
    assert result.metrics["device"] == "cpu"
    assert result.metrics["mesh"] == "built"
    assert result.checkpoint is not None and result.checkpoint.exists()
    assert "checkpoint_" in result.checkpoint.path
    assert train.DataParallelTrainer is train.TorchTrainer


def _mlp_mesh_loop(config):
    """Twin body of test_train.py::_mlp_train_loop on a mesh: the MLP
    step built over get_mesh() with the MLP's logical axes, batches
    through shard_batch."""
    import tempfile

    import numpy as np

    from ray_tpu_torch import train
    from ray_tpu_torch.models.mlp import MLPConfig, mlp_init, mlp_loss
    from ray_tpu_torch.parallel.spmd import (adamw, build_train_step,
                                             shard_batch)
    from ray_tpu_torch.train.checkpoint import Checkpoint, save_pytree

    ctx = train.get_context()
    mesh = ctx.get_mesh()
    cfg = MLPConfig(in_dim=16, hidden=(32,), n_classes=4)
    params = mlp_init(cfg, device=ctx.get_device())
    axes = [{"w": (None, None), "b": (None,)} for _ in params]
    step, state = build_train_step(mlp_loss, adamw(1e-2), params, axes,
                                   mesh)
    rng = np.random.RandomState(0)
    x = rng.randn(64, 16).astype("float32")
    batch = shard_batch({"x": x, "y": (x.sum(-1) > 0).astype("int64") % 4},
                        mesh)
    for epoch in range(config["epochs"]):
        for _ in range(5):
            state, aux = step(state, batch)
        with tempfile.TemporaryDirectory() as d:
            save_pytree({"epoch": epoch}, d)
            train.report({"loss": float(aux["loss"]), "epoch": epoch,
                          "mesh": dict(zip(mesh.mesh_dim_names,
                                           mesh.shape))},
                         checkpoint=Checkpoint(d))


def test_torch_trainer_ddp_mesh(cluster, tmp_path):
    """Twin of test_train.py::test_jax_trainer_ddp_mesh: one worker,
    ScalingConfig(mesh={"data": -1}) on the CPU, the loop's step sharded
    over get_mesh(); the fit ends at epoch 2 with its last checkpoint."""
    result = train.TorchTrainer(
        _mlp_mesh_loop, train_loop_config={"epochs": 3},
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=False,
                                           mesh={"data": -1}),
        run_config=_run(tmp_path, "mlp_ddp")).fit()
    assert result.error is None
    assert result.metrics is not None and result.metrics["epoch"] == 2
    assert result.metrics["mesh"] == {"data": 1}
    assert result.checkpoint is not None and result.checkpoint.exists()
    assert "checkpoint_" in result.checkpoint.path


def _gpu_loop(config):
    import time

    import ray_tpu_torch as rt
    from ray_tpu_torch import train

    # the cluster's view of free resources follows a lease asynchronously
    deadline = time.monotonic() + 20
    free = rt.available_resources().get("GPU")
    while free != 0.0 and time.monotonic() < deadline:
        time.sleep(0.1)
        free = rt.available_resources().get("GPU")
    with open(config["log"], "w") as f:
        f.write(str(free))
    train.get_context().get_device()


def test_use_gpu_leases_a_gpu_and_refuses_to_fall_back(cluster, tmp_path):
    """ScalingConfig(use_gpu=True), the default: the worker holds the
    node's GPU while it lives, and without CUDA get_device() raises, so
    the fit fails (no failures allowed) and releases the GPU."""
    log = str(tmp_path / "gpu.txt")
    trainer = train.TorchTrainer(
        _gpu_loop, train_loop_config={"log": log},
        scaling_config=train.ScalingConfig(num_workers=1),
        run_config=_run(tmp_path, "gpu"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: get_device() succeeds")
    with pytest.raises(train.TrainingFailedError) as info:
        trainer.fit()
    assert "no CUDA" in repr(info.value.__cause__)
    with open(log) as f:
        assert float(f.read()) == 0.0
    deadline = time.monotonic() + 30
    while rt.available_resources().get("GPU") != 1.0:
        assert time.monotonic() < deadline, "the GPU lease was not returned"
        time.sleep(0.1)


# ----------------------------------------------------------------- LoRA
_LORA_CFG = {"preset": "debug", "lora_rank": 4, "steps": 20,
             "batch_size": 8, "seq_len": 32, "lr": 5e-3, "report_every": 5,
             "seed": 3}


def _f32_overrides():
    return {"dtype": torch.float32, "remat": False, "attn_impl": "xla"}


def _numpy_batch(i, rank, b=8, s=32):
    rng = np.random.default_rng(1000 * rank + i)
    tokens = rng.integers(0, 256, (b, s)).astype(np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}


def _crash_batch_fn(marker, at, hard):
    """A batch_fn that dies once at step `at` (hard: the worker process
    exits; else it raises), then gives _numpy_batch."""
    def batch_fn(i, rank):
        import os

        if i == at and not os.path.exists(marker):
            open(marker, "w").close()
            if hard:
                os._exit(1)
            raise RuntimeError("injected crash after the step-10 checkpoint")
        return _numpy_batch(i, rank)
    return batch_fn


def _logged_lora_loop(config):
    """lora_finetune_loop with every train.report's metrics of rank 0
    appended to config["log"] (a crashed attempt's reports too)."""
    import json

    from ray_tpu_torch import train
    from ray_tpu_torch.train.recipes import lora_finetune_loop

    real = train.report

    def report(metrics, checkpoint=None):
        with open(config["log"], "a") as f:
            f.write(json.dumps(metrics) + "\n")
        real(metrics, checkpoint)

    ctx = train.get_context()
    if ctx.get_world_size() > 1:
        import torch

        torch.set_num_threads(1)     # several ranks share the test's cores
    if ctx.get_world_rank() == 0:
        train.report = report
    try:
        return lora_finetune_loop(config)
    finally:
        train.report = real


def _lora_fit(tmp_path, name, extra, max_failures=0, scaling=None):
    log = str(tmp_path / f"{name}.jsonl")
    result = train.TorchTrainer(
        _logged_lora_loop,
        train_loop_config={**_LORA_CFG, "log": log, **extra},
        scaling_config=scaling or train.ScalingConfig(num_workers=1,
                                                      use_gpu=False),
        run_config=train.RunConfig(
            name=name, storage_path=str(tmp_path),
            failure_config=train.FailureConfig(
                max_failures=max_failures))).fit()
    with open(log) as f:
        return result, [json.loads(line) for line in f]


def test_lora_finetune_torch(cluster, tmp_path):
    """Twin of test_train.py::test_lora_finetune on the CPU (one device;
    its dp x fsdp x tensor mesh is item 6): the loss falls and the
    adapters-only checkpoint holds the step and the optimizer state."""
    result, reports = _lora_fit(tmp_path, "lora_ft",
                                {"model_overrides": _f32_overrides()})
    assert result.error is None and result.metrics["step"] == 20
    assert [r["step"] for r in reports] == [5, 10, 15, 20]
    ckpt_dir = result.checkpoint.subdir("rank_0").path
    ckpt = tckpt.load_pytree(ckpt_dir)
    assert set(ckpt) == {"lora", "step"} and int(ckpt["step"]) == 20
    assert set(ckpt["lora"]["layers"]) == {
        f"{t}_{ab}" for t in tlora.DEFAULT_TARGETS for ab in "ab"}
    assert os.path.exists(os.path.join(ckpt_dir, "opt_state.pkl"))
    assert 0 < result.metrics["loss"] < result.metrics["first_loss"]


def test_lora_resume_restores_exact_trajectory_torch(cluster, tmp_path):
    """Twin of test_train.py::test_lora_resume_restores_exact_trajectory:
    a fit whose batch_fn raises once at step 12 restarts from the step-10
    checkpoint (adapters written in place, AdamW's moments and step count
    restored) and ends on the uninterrupted fit's loss."""
    (tmp_path / "never").touch()
    extra = {"model_overrides": _f32_overrides()}
    smooth, _ = _lora_fit(tmp_path, "smooth", {
        **extra, "batch_fn": _crash_batch_fn(str(tmp_path / "never"), 12,
                                             hard=False)})
    crashed, reports = _lora_fit(tmp_path, "crashed", {
        **extra, "batch_fn": _crash_batch_fn(str(tmp_path / "once"), 12,
                                             hard=False)}, max_failures=1)
    assert (tmp_path / "once").exists()
    assert [r["step"] for r in reports] == [5, 10, 15, 20]
    assert crashed.metrics["step"] == smooth.metrics["step"] == 20
    assert abs(crashed.metrics["loss"] - smooth.metrics["loss"]) < 1e-6


def _reference_losses(base, adapters, steps, lr):
    """ray_tpu's build_train_step with optax.adamw, in process, on the
    same base, adapters and batches: the loss of each step."""
    jcfg = jllama.config_for("debug", dtype=jnp.float32, remat=False,
                             attn_impl="xla")
    lcfg = jlora.LoraConfig(rank=4, alpha=jcfg.lora_alpha)
    tree = jax.tree.map(jnp.asarray, {**base, "lora": adapters})
    step, state = jax_build_train_step(
        lambda p, b: jllama.loss_fn(p, b, jcfg), optax.adamw(lr), tree,
        {**jllama.param_logical_axes(jcfg),
         "lora": jlora.lora_logical_axes(jcfg, lcfg)},
        build_mesh({"data": 1}, jax.devices()[:1]), trainable_keys=("lora",))
    losses = []
    for i in range(steps):
        state, aux = step(state, jax.tree.map(jnp.asarray,
                                              _numpy_batch(i, 0)))
        losses.append(float(aux["loss"]))
    return losses


def test_lora_fit_with_a_crash_matches_ray_tpu(cluster, tmp_path):
    """The slice as a whole: a TorchTrainer fit of the port's
    lora_finetune_loop (debug preset, f32, the CPU) from ray_tpu's base
    weights, whose worker hard-exits once at step 12, after the step-10
    checkpoint. Every report, before the crash and after the resume,
    equals ray_tpu's train step on the same base, adapters and batches to
    1e-4 relative."""
    from ray_tpu_torch.models.convert import params_from_numpy

    jcfg = jllama.config_for("debug", dtype=jnp.float32)
    base = jax.tree.map(np.asarray,
                        jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = tllama.config_for("debug", dtype=torch.float32)
    # the adapters the loop draws: init_lora_params(cfg, lcfg, seed + 1)
    adapters = params_to_numpy(tlora.init_lora_params(
        tcfg, tlora.LoraConfig(rank=4, alpha=tcfg.lora_alpha),
        _LORA_CFG["seed"] + 1, device="cpu"))
    result, reports = _lora_fit(tmp_path, "parity", {
        "model_overrides": _f32_overrides(),
        "init_params_fn": lambda cfg: params_from_numpy(base, device="cpu",
                                                        cfg=cfg),
        "batch_fn": _crash_batch_fn(str(tmp_path / "crash"), 12, hard=True),
    }, max_failures=1)
    assert (tmp_path / "crash").exists() and result.error is None
    want = _reference_losses(base, adapters, _LORA_CFG["steps"],
                             _LORA_CFG["lr"])
    assert [r["step"] for r in reports] == [5, 10, 15, 20]
    for r in reports:
        ref = want[r["step"] - 1]
        assert abs(r["loss"] - ref) <= LOSS_RTOL * abs(ref), (r, ref)
    assert want[-1] < want[0]


def _parity_inputs():
    """ray_tpu's debug base weights and the adapters lora_finetune_loop
    draws (init_lora_params(cfg, lcfg, seed + 1)), as numpy."""
    jcfg = jllama.config_for("debug", dtype=jnp.float32)
    base = jax.tree.map(np.asarray,
                        jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = tllama.config_for("debug", dtype=torch.float32)
    adapters = params_to_numpy(tlora.init_lora_params(
        tcfg, tlora.LoraConfig(rank=4, alpha=tcfg.lora_alpha),
        _LORA_CFG["seed"] + 1, device="cpu"))
    return base, adapters


def _mesh_fit(tmp_path, name, scaling):
    from ray_tpu_torch.models.convert import params_from_numpy

    base, adapters = _parity_inputs()
    result, reports = _lora_fit(tmp_path, name, {
        "model_overrides": _f32_overrides(),
        "init_params_fn": lambda cfg: params_from_numpy(base, device="cpu",
                                                        cfg=cfg),
        "batch_fn": _numpy_batch}, scaling=scaling)
    assert result.error is None and result.metrics["step"] == 20
    want = _reference_losses(base, adapters, _LORA_CFG["steps"],
                             _LORA_CFG["lr"])
    assert [r["step"] for r in reports] == [5, 10, 15, 20]
    for r in reports:
        ref = want[r["step"] - 1]
        assert abs(r["loss"] - ref) <= LOSS_RTOL * abs(ref), (r, ref)
    assert 0 < result.metrics["loss"] < result.metrics["first_loss"]
    return result


def test_lora_finetune_on_a_mesh_torch(cluster, tmp_path):
    """Twin of test_train.py::test_lora_finetune: the reference lays a
    dp x fsdp x tensor mesh over one worker's 8 CPU devices; the port lays
    fsdp 2 x tensor 2 over 4 CPU workers, one rank each. Every report
    equals ray_tpu's train step on the same base, adapters and global
    batches to LOSS_RTOL, the loss falls, and each rank checkpoints its
    own shards of the adapters (A's embed dim over fsdp, B's heads over
    tensor) with its optimizer state."""
    result = _mesh_fit(tmp_path, "lora_mesh", train.ScalingConfig(
        num_workers=4, use_gpu=False, mesh={"fsdp": 2, "tensor": 2}))
    for rank in range(4):
        ckpt_dir = result.checkpoint.subdir(f"rank_{rank}").path
        ckpt = tckpt.load_pytree(ckpt_dir)
        assert int(ckpt["step"]) == 20
        layers = ckpt["lora"]["layers"]
        assert layers["wq_a"].shape == (2, 32, 4)      # [L, d/fsdp, r]
        assert layers["wq_b"].shape == (2, 4, 32)      # [L, r, h*hd/tensor]
        assert layers["wo_a"].shape == (2, 32, 4)      # heads over tensor
        assert layers["wo_b"].shape == (2, 4, 32)      # embed over fsdp
        assert os.path.exists(os.path.join(ckpt_dir, "opt_state.pkl"))


def test_two_worker_data_parallel_ends_with_equal_params(cluster,
                                                         tmp_path):
    """Two CPU workers and no mesh given: pure data parallelism over
    get_mesh()'s {"data": -1}. Every report equals ray_tpu's step on the
    global batches, and both ranks end with the same adapters, bit for
    bit."""
    result = _mesh_fit(tmp_path, "lora_dp", train.ScalingConfig(
        num_workers=2, use_gpu=False))
    ranks = [tckpt.load_pytree(result.checkpoint.subdir(f"rank_{r}").path)
             for r in range(2)]
    for name, leaf in ranks[0]["lora"]["layers"].items():
        assert leaf.shape[1:] == ((64, 4) if name.endswith("_a")
                                  else (4, 64 if name[:2] in ("wq", "wo")
                                        else 32)), name
        assert np.array_equal(leaf, ranks[1]["lora"]["layers"][name]), name
