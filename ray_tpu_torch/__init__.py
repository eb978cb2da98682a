"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for an NVIDIA H100.

The runtime (tasks, actors, objects, the GCS and node managers; ``core``,
``_internal``, ``_native``, ``util``, ``api``) is carried over from the JAX
package with the GPU as a schedulable resource::

    import ray_tpu_torch as rt
    rt.init()                      # autodetects the node's GPUs
    @rt.remote(num_gpus=1)
    def f(x): ...
    rt.get(f.remote(2))

Compute, on one card: ops (rms_norm, rope, attention, cross entropy), the
flash-attention kernels written in CUDA C++ for sm_90a (``ops/cuda``), the
Llama model with its KV-cache decode, LoRA adapters and the MoE FFN
(``models/llama``, ``models/lora``, ``ops/moe``), the MLP (``models/mlp``),
weight conversion from the JAX package's parameter tree
(``models/convert``), a single-device train step with AdamW and frozen keys
(``parallel/spmd``), and the continuously batched LLM engine with adapter
serving behind the multiplex LRU (``serve/llm``, ``serve/multiplex``).
Compute entry points run on the CUDA card unless given ``device="cpu"``.

The Serve plane (``serve``: controller, replicas, the DeploymentHandle's
router, HTTP and gRPC ingress) deploys the engine::

    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import llm_app
    serve.start()
    handle = serve.run(llm_app("410m"))

The train runtime (``train``: ``TorchTrainer``, the worker group, the
session, checkpoints, corpus ingest, the recipes) runs a train loop in
GPU-leased workers, restarting from the latest checkpoint after a worker
dies; ``util.collective`` gives a group of workers its host-side barrier
and allreduce::

    from ray_tpu_torch import train
    train.TorchTrainer(train.lora_finetune_loop,
                       train_loop_config={"preset": "410m"},
                       scaling_config=train.ScalingConfig(num_workers=1),
                       ).fit()

Compiled graphs (``dag``): ``actor.method.bind(...)`` builds a DAG and
``experimental_compile()`` runs it over pre-allocated channels between
long-lived actor loops; an edge marked ``.with_tensor_transport()`` carries
CUDA tensors (raw bytes, rebuilt on the consumer's card), and
``serve.llm.disagg_llm_app`` hands a prompt's KV rows from a prefill pool
to a decode pool over one::

    from ray_tpu_torch.dag import InputNode
    with InputNode() as inp:
        dag = learner.step.bind(
            feeder.batch.bind(inp).with_tensor_transport())
    compiled = dag.experimental_compile()
    compiled.execute(0).get()

The data plane (``data``: datasets over blocks, datasources and sinks,
the streaming executor, the exchange, and ``data.llm_corpus``, whose
``build_corpus`` dedups, tokenizes and shuffles a raw corpus into the token
shards the ingest reads), Tune (``tune``: trials as GPU-leased
TrainWorkers, a fraction of the card each if asked, under ASHA or PBT)
and offline RL (``rl.offline``: BC and CQL learners on the card, reading
recorded transitions through the data plane).

The runtime's surfaces: ``state_api``, ``python -m ray_tpu_torch``
(``scripts/cli``: start --head, status, list, job submit, train status,
...), the dashboard with job submission (``dashboard``, started by the
head with ``--dashboard-port``) and the thin client (``client``).

Cluster operations: the autoscaler in the head (``autoscaler``: a
reconciler launching and retiring slices through a node provider, local
node managers or Compute Engine A3 GPU VMs), the launcher
(``python -m ray_tpu_torch up cfg.json``, ``exec``, ``attach``, ``down``)
and durable workflows (``workflow``: steps checkpointed to storage, a
killed driver's run resumed without re-running them).

The package never imports jax. Its root, ``core``, ``_internal``,
``util``, ``dag``, ``serve`` (all but ``serve.llm``), ``train``,
``data``, ``tune``, ``state_api``, ``scripts``, ``dashboard``, ``client``,
``autoscaler`` and ``workflow`` never import torch either (the train
recipes import it inside their bodies): workers boot with ``python -S`` in about 100 ms and pay
torch's import only when a task uses it, so ``resolve_device`` is a lazy
attribute.
"""

__version__ = "0.1.0"

from ray_tpu_torch.api import (ActorClass, ActorHandle,  # noqa: F401
                               PlacementGroup, available_resources, cancel,
                               cluster_resources, drain_node, drain_status,
                               get, get_actor, get_runtime_context, kill,
                               nodes, place_gang, placement_group, put,
                               put_device, remote, remove_placement_group,
                               set_job_quota, wait)
from ray_tpu_torch.core.common import (ActorDiedError,  # noqa: F401
                                       GetTimeoutError,
                                       NodeAffinitySchedulingStrategy,
                                       NodeLabelSchedulingStrategy,
                                       ObjectLostError,
                                       PlacementGroupSchedulingStrategy,
                                       RayTpuError, TaskCancelledError,
                                       TaskError, WorkerCrashedError)
from ray_tpu_torch.core.object_ref import ObjectRef  # noqa: F401
from ray_tpu_torch.core.runtime import (init, is_initialized,  # noqa: F401
                                        shutdown)

def __getattr__(name):
    # Lazy submodules: keep `import ray_tpu_torch` free of torch.
    if name == "resolve_device":
        from ray_tpu_torch.device import resolve_device

        return resolve_device
    if name in ("util", "serve", "models", "ops", "parallel", "experimental",
                "train", "data", "tune", "dag", "rl", "state_api",
                "collective"):
        # "collective" names no module, in the reference either
        # (ray_tpu.collective fails with ModuleNotFoundError)
        import importlib

        return importlib.import_module(f"ray_tpu_torch.{name}")
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")
