"""WorkerGroup: the gang of training actors (ref analogs:
train/_internal/worker_group.py:102 `WorkerGroup`/`RayTrainWorker:19`,
train/v2/_internal/execution/worker_group/worker_group.py:97).

The port of ray_tpu/train/worker_group.py: one worker per GPU lease
(``ScalingConfig.use_gpu``), gang-placed via a placement group when there
is more than one; groups of more than one worker join the host collective
group (util/collective) for barriers and small allreduces. No card is
pinned per lease yet (ROADMAP.md item 6), so on one card every GPU worker
uses it. The worker actor is threaded (max_concurrency=2) so the
controller can drain results while the user loop runs.

The process group a loop's ``get_mesh()`` starts across the workers
(session.py) lives as long as the loop: ``run`` destroys it when the loop
returns or raises, ``setup`` and ``teardown`` destroy one left in the
process, and a restart starts a new one, on a new address, with the new
group of workers (a killed worker's group ends with its process).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional

import cloudpickle

import ray_tpu_torch as rt
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train import session


class TrainWorker:
    """Hosts the user's train_loop_per_worker (ref: RayTrainWorker)."""

    def setup(self, rank: int, world_size: int, experiment_path: str,
              experiment_name: str, latest_checkpoint: Optional[str],
              mesh_axes: Optional[dict], group_name: str,
              ingest_spec=None, run_id: Optional[str] = None,
              use_gpu: bool = False) -> dict:
        from ray_tpu_torch.util import collective

        self._group_name = group_name
        node_id = ""
        try:
            from ray_tpu_torch.core.object_ref import get_core_worker

            cw = get_core_worker()
            if cw is not None:
                node_id = cw.node_id.hex()
        except Exception:
            pass
        ctx = session.TrainContext(rank, world_size, experiment_path,
                                   experiment_name, latest_checkpoint,
                                   mesh_axes, ingest_spec=ingest_spec,
                                   run_id=run_id, node_id=node_id,
                                   use_gpu=use_gpu,
                                   collective_group=group_name)
        ctx.close_process_group()       # one left by this process's last
        session.set_context(ctx)
        self._ctx = ctx
        # Host-plane communicator: barriers, coordinator-address exchange
        # (the analog of the NCCLUniqueId rendezvous).
        if world_size > 1:
            collective.init_collective_group(world_size, rank,
                                             group_name=group_name)
        return {"rank": rank, "pid": os.getpid()}

    def run(self, fn_blob: bytes, config: Optional[dict]) -> dict:
        fn = cloudpickle.loads(fn_blob)
        try:
            if _wants_config(fn):
                fn(config or {})
            elif config:
                raise TypeError(
                    f"train loop {getattr(fn, '__name__', fn)!r} takes "
                    "no config parameter but a non-empty "
                    "train_loop_config was given — it would be silently "
                    "ignored")
            else:
                fn()
        finally:
            # drain buffered step records before the actor can be torn
            # down — the run's tail must reach the GCS train manager
            self._ctx.close_telemetry()
            self._ctx.close_process_group()
        return {"rank": self._ctx.rank, "status": "finished"}

    def drain_results(self) -> list[dict]:
        return self._ctx.drain_results()

    def barrier(self):
        from ray_tpu_torch.util import collective

        if self._ctx.world_size > 1:
            collective.barrier(group_name=self._group_name)
        return True

    def teardown(self):
        from ray_tpu_torch.util import collective

        self._ctx.close_process_group()
        if self._ctx.world_size > 1:
            try:
                collective.destroy_collective_group(self._group_name)
            except Exception:
                pass
        return True


def actor_options_from_resources(res: dict, *,
                                 max_concurrency: int = 2) -> dict:
    """Map a resources dict ({'CPU': 1, 'GPU': 1, 'memory': ..., custom})
    to rt.remote actor options. 'memory' is accounted per-node, not
    scheduled as a custom resource."""
    opts: dict[str, Any] = {"max_concurrency": max_concurrency,
                            "num_cpus": res.get("CPU", 1)}
    if res.get("GPU"):
        opts["num_gpus"] = res["GPU"]
    if res.get("memory"):
        opts["memory"] = res["memory"]
    extra = {k: v for k, v in res.items()
             if k not in ("CPU", "GPU", "memory")}
    if extra:
        opts["resources"] = extra
    return opts


def _wants_config(fn: Callable) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return len(sig.parameters) > 0


class WorkerGroup:
    def __init__(self, scaling: ScalingConfig, run_config: RunConfig,
                 experiment_path: str, experiment_name: str,
                 group_seq: int, run_id: Optional[str] = None):
        self.scaling = scaling
        self.run_config = run_config
        self.experiment_path = experiment_path
        self.experiment_name = experiment_name
        self.group_seq = group_seq
        self.run_id = run_id
        self.workers: list = []
        self.pg = None

    def start(self, latest_checkpoint: Optional[str]):
        return rt.get(self.start_async(latest_checkpoint), timeout=120)

    def start_async(self, latest_checkpoint: Optional[str]) -> list:
        """Create the workers and submit their setup; -> the setup refs
        (a caller starting several groups waits on them together)."""
        n = self.scaling.num_workers
        actor_cls = rt.remote(TrainWorker)
        if n > 1:
            self.pg = self._reserve_gang()
        res = self.scaling.worker_resources()
        group_name = f"train-{self.experiment_name}-{self.group_seq}"
        self.workers = []
        for i in range(n):
            o = actor_options_from_resources(res)
            if self.pg is not None:
                o["scheduling_strategy"] = self.pg.bundle_strategy(i)
            self.workers.append(actor_cls.options(**o).remote())
        setup_refs = [
            w.setup.remote(i, n, self.experiment_path, self.experiment_name,
                           latest_checkpoint, self.scaling.mesh, group_name,
                           self.scaling.ingest, self.run_id,
                           self.scaling.use_gpu)
            for i, w in enumerate(self.workers)]
        return setup_refs

    def _reserve_gang(self):
        """Gang-reserve the workers through the placement plane. GPU
        groups (use_gpu or a topology hint) first try SLICE_PACK — the
        whole gang inside one slice of the interconnect, so collectives
        stay on it and DAG edges to these workers compile co-located —
        and fall back to the configured strategy when no single slice
        fits the gang (e.g. an unlabeled dev cluster smaller than the
        request)."""
        bundles = self.scaling.bundles()
        if (self.scaling.use_gpu or self.scaling.topology) and \
                self.scaling.placement_strategy in ("PACK",
                                                    "SLICE_PACK"):
            try:
                return rt.placement_group(bundles,
                                          strategy="SLICE_PACK",
                                          timeout=30.0)
            except TimeoutError:
                pass
        return rt.placement_group(
            bundles, strategy=self.scaling.placement_strategy)

    def run_async(self, train_fn: Callable, config: Optional[dict]):
        from ray_tpu_torch._internal.serialization import dumps_code

        blob = dumps_code(train_fn)
        return [w.run.remote(blob, config) for w in self.workers]

    def drain_results(self) -> list[dict]:
        out: list[dict] = []
        for ref in [w.drain_results.remote() for w in self.workers]:
            try:
                # results are small metric dicts; a submit to a DEAD
                # worker never resolves, so a short timeout bounds the
                # failure-recovery stall (storage markers cover anything
                # undrained — controller._recover_checkpoints_from_storage)
                out.extend(rt.get(ref, timeout=10))
            except Exception:
                pass  # dead worker: run-ref error surface handles it
        return out

    def shutdown(self):
        for w in self.workers:
            try:
                rt.kill(w)
            except Exception:
                pass
        if self.pg is not None:
            try:
                rt.remove_placement_group(self.pg)
            except Exception:
                pass
        self.workers = []
        self.pg = None
