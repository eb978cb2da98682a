"""IMPALA — async actor-learner architecture with V-trace correction.

Ref analogs: rllib/algorithms/impala/impala.py:508 (algorithm),
:860,923 (stateless AggregatorActors batching episodes for learners),
Espeholt et al. 2018. Dataflow:

  EnvRunner fleet (CPU actors, stale weights) --sample async-->
  AggregatorActor(s) --train batches--> IMPALALearner (V-trace update
  on the learner's device) --weights broadcast (object store ref or the
  compiled DAG's input edge)--> runners

The driver keeps `max_requests_in_flight` sample calls outstanding per
runner and never blocks the learner on the slowest runner — the defining
difference from PPO's synchronous iteration.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import cloudpickle
import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.parallel.mesh import CommandGroup
from ray_tpu_torch.rl.actor_manager import FaultTolerantActorManager
from ray_tpu_torch.rl.env import make_vector_env, require_discrete
from ray_tpu_torch.rl.env_runner import EnvRunner
from ray_tpu_torch.rl.module_config import CNNModuleConfig, MLPModuleConfig


@dataclasses.dataclass
class IMPALAConfig:
    env: str = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 8
    rollout_fragment_length: int = 64
    num_aggregators: int = 1
    hidden: tuple = (64, 64)
    # connector pipelines (None = defaults chosen from the module type;
    # ref: connector_v2.py:31 / connector_pipeline_v2.py:19)
    env_to_module: object = None
    learner_pipeline: object = None
    # >1 shards each learner batch's env axis over this many learner
    # ranks, one process and one device each (num_gpus_per_learner GPUs a
    # rank), gang-leased through a placement group; a cluster that cannot
    # place them raises (the reference drops its mesh instead)
    learner_devices: int = 0
    # rllib's AlgorithmConfig.learners(num_gpus_per_learner=...): the
    # learner actor is leased this many GPUs and runs on the card when it
    # is above 0, on the CPU at 0
    num_gpus_per_learner: float = 1
    lr: float = 5e-4
    gamma: float = 0.99
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    rho_clip: float = 1.0
    c_clip: float = 1.0
    max_grad_norm: float = 40.0
    # timesteps (T*B) per learner update; aggregator releases a batch
    # once it holds at least this many
    train_batch_size: int = 1024
    max_requests_in_flight: int = 2
    broadcast_interval: int = 1     # learner updates between broadcasts
    boot_wave: int = 0              # stagger runner creation (0 = all at once)
    # RPC budget for control-plane calls (aggregate/learner/broadcast):
    # raise on oversubscribed hosts where a saturated core stretches
    # actor-call latency far past the defaults
    call_timeout_s: float = 120.0
    # APPO (ref: algorithms/appo/appo.py): replace the plain V-trace
    # policy-gradient with PPO's clipped surrogate over V-trace
    # advantages — stale-rollout updates can't push the policy
    # arbitrarily far, so higher broadcast_interval stays stable
    use_appo_loss: bool = False
    clip_eps: float = 0.2
    seed: int = 0
    # steady-state execution plane: compile the env_runner→aggregator→
    # learner loop onto a channel DAG (dag/channel_exec.py — the Sebulba
    # shape from the Podracer paper: runners feed rings, the learner
    # consumes, weights broadcast back over the input channel edge).
    # Ticks then cost ring writes instead of task submissions; pipeline
    # depth (ticks in flight) is max_requests_in_flight, which bounds
    # weight staleness exactly like the per-call path's in-flight cap.
    # False restores plain actor calls (per-runner retry/fault tolerance
    # at per-call speed).
    use_compiled_dag: bool = True
    # DAG-mode result granularity (rllib's min-work-per-train-iteration):
    # ticks are cheap enough that one update per train() call would make
    # driver-side bookkeeping the bottleneck — drain this many updates
    # per iteration (soft 5s cap keeps slow-env iterations bounded)
    min_updates_per_iteration: int = 4
    # device edges (dag/device_channel.py — the Anakin shape): the
    # aggregator→learner batch edge and the learner→driver weights edge
    # carry arrays as raw host bytes (never a host pickle of the buffer),
    # batches land on the learner's device during the read, weights
    # broadcast back over a device input edge, and the learner's update
    # owns the edge-supplied batch (donation vector from edge arity).
    # False restores host framing on every edge.
    use_device_edges: bool = True

    def build(self) -> "IMPALA":
        return IMPALA(self)


@dataclasses.dataclass
class APPOConfig(IMPALAConfig):
    """Async PPO (ref: algorithms/appo/appo.py:64 — IMPALA's async
    architecture + the clipped surrogate objective)."""
    use_appo_loss: bool = True
    broadcast_interval: int = 2


def _tree_leaves(tree):
    """Flatten a (possibly nested) params tree without importing a
    device runtime on the driver."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tree_leaves(v)
    else:
        yield tree


def _tree_copy(tree):
    """Copy a params tree's arrays — the copy-on-hold rule for values
    retained across compiled-DAG ticks: numpy leaves are copied, tensor
    leaves (device-edge weights) cloned on their device. The check stays
    torch-free on the host path (torch is only read when a tensor leaf
    already loaded it)."""
    if isinstance(tree, dict):
        return {k: _tree_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_copy(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return np.array(tree)
    from ray_tpu_torch.core.device_objects import is_device_value

    if is_device_value(tree):
        return tree.detach().clone()
    return tree


def _env_axis(key: str) -> int:
    """The env (B) axis of a learner batch key: 0 of last_obs [B, ...],
    1 of every [T, B, ...] key."""
    return 0 if key == "last_obs" else 1


class _LearnerRanks(CommandGroup):
    """The process group of one learner over ``learner_devices=N`` ranks
    (the reference's learner mesh, ray_tpu/rl/impala.py:370-395). Rank 0
    is the IMPALALearner actor, ranks 1..N-1 IMPALALearnerRank actors, one
    process and one device each: NCCL on cards, gloo on the CPU.

    Each update rank 0 sends the batch's layout, then scatters every key
    along its env axis; a key whose env axis N does not divide goes whole
    to every rank. Every rank takes its slice's gradients, and the
    all-reduced mean feeds the clip and Adam on every rank: the clip sees
    the whole batch's gradient, so the update is the one-device update on
    the whole batch, and the params stay equal across the ranks."""

    def send(self, cmd: str, meta=None) -> None:
        """Rank 0: the next command, for every other rank's ``recv``."""
        self.objects((cmd, meta))

    def recv(self) -> tuple:
        return self.objects()

    def layout(self, batch: dict) -> dict:
        """key -> (shape, dtype, the env axis it is cut along or None)."""
        out = {}
        for k, v in batch.items():
            axis = _env_axis(k)
            cut = v.dim() > axis and v.shape[axis] % self.world == 0
            out[k] = (tuple(v.shape), v.dtype, axis if cut else None)
        return out

    def split(self, batch: dict | None, layout: dict) -> dict:
        """This rank's slice of the batch rank 0 holds (None elsewhere)."""
        out = {}
        for k, (shape, dtype, axis) in layout.items():
            t = batch[k] if self.rank == 0 else None
            out[k] = (self.broadcast(t, shape, dtype) if axis is None else
                      self.scatter(t, axis, shape, dtype))
        return out

    def mean(self, grads, aux: dict):
        """The gradients and the loss terms averaged over the ranks."""
        import torch

        flat = self.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        flat /= self.world
        out, i = [], 0
        for g in grads:
            out.append(flat[i:i + g.numel()].view_as(g))
            i += g.numel()
        names = sorted(aux)
        terms = self.all_reduce(torch.stack([aux[k].float() for k in names]))
        terms /= self.world
        return out, dict(zip(names, terms))

    def sync(self, leaves) -> None:
        """Rank 0's params into every rank's (in place)."""
        import torch

        with torch.no_grad():
            for t in leaves:
                self.broadcast(t.data)


def _learner_state(module_cfg, cfg, seed: int):
    """(device, params, trainable leaves, optimizer) of one learner rank."""
    from ray_tpu_torch.device import resolve_device
    from ray_tpu_torch.rl import module as rlm
    from ray_tpu_torch.rl.learner import (ClippedAdam, learner_device,
                                          trainable)

    device = resolve_device(learner_device(cfg.num_gpus_per_learner))
    params = rlm.init_params(module_cfg, seed, device)
    leaves = trainable(params)
    return device, params, leaves, ClippedAdam(leaves, cfg.lr,
                                               cfg.max_grad_norm)


def _rank_update(params, leaves, optimizer, batch: dict, cfg,
                 ranks: "_LearnerRanks | None") -> dict:
    """One V-trace update of this rank's batch; across ranks, on the
    all-reduced mean gradient."""
    import torch

    loss, aux = impala_loss(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    if ranks is not None:
        grads, aux = ranks.mean(grads, aux)
    optimizer.step(grads)
    return aux


def _start_learner(config, module_blob: bytes, cfg_blob: bytes):
    """The learner actor (rank 0), and with ``learner_devices=N > 1`` its
    N-1 other ranks, gang-leased through a placement group of N bundles
    of ``num_gpus_per_learner`` GPUs and a CPU each -> (learner, the
    other ranks, the placement group or None). A cluster that cannot
    place the N ranks raises: the reference quietly drops its mesh when
    it has fewer devices (ray_tpu/rl/impala.py:373-375), the port has no
    such fallback."""
    g = config.num_gpus_per_learner
    n = max(1, int(config.learner_devices))
    learner_cls = rt.remote(num_cpus=1, num_gpus=g)(IMPALALearner)
    if n == 1:
        return learner_cls.remote(module_blob, cfg_blob, config.seed), \
            [], None
    bundle = {"CPU": 1.0, **({"GPU": float(g)} if g > 0 else {})}
    have = rt.cluster_resources()
    short = {r: amt * n for r, amt in bundle.items()
             if have.get(r, 0.0) < amt * n - 1e-9}
    try:
        if short:
            raise TimeoutError(f"the cluster holds {have}")
        pg = rt.placement_group([dict(bundle) for _ in range(n)], "PACK",
                                timeout=config.call_timeout_s)
    except TimeoutError as e:
        raise RuntimeError(
            f"learner_devices={n} needs {n} learner ranks of {bundle}, and "
            f"the cluster cannot place them ({e}); lower learner_devices or "
            "num_gpus_per_learner") from None
    # threaded: serve holds one thread for the learner's life
    rank_cls = rt.remote(num_cpus=1, num_gpus=g,
                         max_concurrency=2)(IMPALALearnerRank)
    others = [rank_cls.options(scheduling_strategy=pg.bundle_strategy(i))
              .remote(module_blob, cfg_blob, config.seed)
              for i in range(1, n)]
    learner = learner_cls.options(
        scheduling_strategy=pg.bundle_strategy(0)).remote(
            module_blob, cfg_blob, config.seed, others)
    return learner, others, pg


def _sample_fragment_nbytes(module_cfg, rollout_fragment_length: int,
                            num_envs_per_runner: int) -> int:
    """Upper-bound one runner fragment's raw array bytes (sizes channel
    slots for the RL DAGs — shared by IMPALA and PPO)."""
    obs_elems = int(np.prod(getattr(module_cfg, "obs_shape", ())
                            or (getattr(module_cfg,
                                        "observation_size", 4),)))
    per_step = (obs_elems + 8) * 4
    return rollout_fragment_length * num_envs_per_runner * per_step


class AggregatorActor:
    """Stateless-ish episode batcher (ref: impala.py:860 AggregatorActor):
    concatenates runner sample dicts along the env axis until a train
    batch is ready. Runs as a CPU actor so concat/copy cost stays off the
    driver and learner."""

    def __init__(self):
        self._buf: list[dict] = []
        self._timesteps = 0

    def add(self, sample: dict, min_batch_timesteps: int) -> Optional[dict]:
        self._buf.append(sample)
        T, N = sample["rewards"].shape
        self._timesteps += T * N
        if self._timesteps < min_batch_timesteps:
            return None
        batch = {
            key: np.concatenate([s[key] for s in self._buf], axis=1)
            for key in ("obs", "actions", "logp", "rewards", "dones",
                        "trunc_values")
        }
        batch["last_obs"] = np.concatenate(
            [s["last_obs"] for s in self._buf], axis=0)
        batch["episode_returns"] = [
            r for s in self._buf for r in s["episode_returns"]]
        self._buf = []
        self._timesteps = 0
        return batch

    def add_many(self, min_batch_timesteps: int, *samples) -> list:
        """Compiled-DAG tick: fold every runner's fragment from this tick
        into the buffer; returns the train batches that became ready (one
        tick can complete several when fragments are large).

        Fragments are COPIED out of their edge channels before buffering:
        zero-copy reads alias the ring slots, and samples held across
        ticks (until a batch fills) would pin more slots than the ring
        has — the slot-pin rule's copy-on-hold requirement."""
        batches = []
        for s in samples:
            s = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
                 for k, v in s.items()}
            b = self.add(s, min_batch_timesteps)
            if b is not None:
                batches.append(b)
        return batches

    def add_many_device(self, min_batch_timesteps: int, *samples) -> list:
        """Device-edge tick (``use_device_edges``): ready batches leave
        with their numpy leaves marked for the device framing
        (``wrap_host_arrays``), so the aggregator→learner edge ships raw
        host bytes and the learner's read rebuilds them as tensors on ITS
        device — the batch never takes a host-pickle round trip, and the
        aggregator itself never imports a device runtime."""
        from ray_tpu_torch.dag.device_channel import wrap_host_arrays

        out = []
        for b in self.add_many(min_batch_timesteps, *samples):
            returns = b.pop("episode_returns")
            b, _ = wrap_host_arrays(b)
            b["episode_returns"] = returns
            out.append(b)
        return out

    def ping(self) -> bool:
        return True


def impala_loss(params, batch: dict, cfg):
    """IMPALA's V-trace loss of one [T, B] batch (APPO's clipped
    surrogate with ``cfg.use_appo_loss``) -> (loss, aux)."""
    import torch

    from ray_tpu_torch.rl import module as rlm
    from ray_tpu_torch.rl.vtrace import vtrace

    T, B = batch["rewards"].shape
    # keep image dims: [T, B, H, W, C] -> [T*B, H, W, C]
    obs_flat = batch["obs"].reshape((T * B,) + tuple(batch["obs"].shape[2:]))
    logits, values = rlm.forward(params, obs_flat)
    logits = logits.reshape(T, B, -1)
    values = values.reshape(T, B)
    _, boot_value = rlm.forward(params, batch["last_obs"])
    logp_all = torch.log_softmax(logits, dim=-1)
    target_logp = logp_all.gather(
        -1, batch["actions"].long()[..., None])[..., 0]
    vs, pg_adv = vtrace(
        batch["logp"], target_logp, batch["rewards"], values,
        boot_value, batch["dones"], batch["trunc_values"],
        gamma=cfg.gamma, rho_clip=cfg.rho_clip, c_clip=cfg.c_clip)
    if cfg.use_appo_loss:
        # APPO: clipped surrogate on V-trace advantages
        ratio = torch.exp(target_logp - batch["logp"])
        pg_loss = -torch.minimum(
            ratio * pg_adv,
            ratio.clamp(1 - cfg.clip_eps, 1 + cfg.clip_eps) * pg_adv).mean()
    else:
        pg_loss = -(pg_adv * target_logp).mean()
    vf_loss = 0.5 * ((values - vs) ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    loss = pg_loss + cfg.vf_coeff * vf_loss - cfg.entropy_coeff * entropy
    return loss, {"loss": loss.detach(), "pg_loss": pg_loss.detach(),
                  "vf_loss": vf_loss.detach(), "entropy": entropy.detach()}


class IMPALALearner:
    """V-trace learner on its device: the card when the config leases it
    a GPU (``num_gpus_per_learner`` above 0; no CUDA then raises), the
    CPU at 0. One update consumes one aggregated batch [T, B, ...]. Given
    ``ranks`` (the other ranks' IMPALALearnerRank actors, with
    ``learner_devices`` above 1) it is rank 0 of a learner over several
    devices, and each update is data parallel over them
    (``_LearnerRanks``)."""

    def __init__(self, module_cfg_blob: bytes, cfg_blob: bytes,
                 seed: int = 0, ranks: list | None = None):
        self.cfg: IMPALAConfig = cloudpickle.loads(cfg_blob)
        self.module_cfg = cloudpickle.loads(module_cfg_blob)
        self.device, self.params, self._leaves, self.optimizer = \
            _learner_state(self.module_cfg, self.cfg, seed)
        self.num_updates = 0
        self.batch_arrivals: dict[str, int] = {}
        cfg = self.cfg
        self._ranks = None
        if ranks:
            from ray_tpu_torch.parallel.mesh import free_address
            from ray_tpu_torch.util.collective.collective import _host_ip

            world = len(ranks) + 1
            address = free_address(_host_ip())
            self._rank_runs = [r.serve.remote(address, i + 1, world)
                               for i, r in enumerate(ranks)]
            self._ranks = _LearnerRanks(world, 0, address, self.device,
                                        cfg.call_timeout_s)
            self._ranks.sync(self._leaves)

        def update(params, optimizer, batch):
            ranks_ = self._ranks
            if ranks_ is not None:
                layout = ranks_.layout(batch)
                ranks_.send("update", layout)
                batch = ranks_.split(batch, layout)
            aux = _rank_update(params, self._leaves, optimizer, batch, cfg,
                               ranks_)
            return params, optimizer, aux

        if self.cfg.use_device_edges:
            # the batch is the edge-supplied arg (arity 1, position 2):
            # the producer relinquished it on write, so the update owns
            # it (the donation vector names it)
            from ray_tpu_torch.dag.device_channel import donating_jit

            self._update = donating_jit(update, n_edge_args=1, offset=2)
        else:
            self._update = update

        # step-waterfall parity with the trainer: the learner emits the
        # same train_state records (experiment "rl:impala"/"rl:appo"),
        # so the data-wait vs update split of the Podracer loop shows,
        # and wrap_jit records the first update's cost (compile events)
        self._recorder = None
        try:
            from ray_tpu_torch.train.telemetry import (StepRecorder,
                                                       mint_run_id,
                                                       recording_enabled)

            if recording_enabled():
                exp = ("rl:appo" if self.cfg.use_appo_loss
                       else "rl:impala")
                self._run_id = mint_run_id()
                self._recorder = StepRecorder(self._run_id, exp)
                job_hex = ""
                try:
                    from ray_tpu_torch.core.object_ref import get_core_worker

                    job_hex = get_core_worker().job_id.hex()
                except Exception:
                    pass
                # the run record rides the recorder's own publisher, so a
                # flush of the step records carries it too (the module's
                # publisher flushes on a timer and could trail them)
                self._recorder._pub.publish({
                    "kind": "run", "run_id": self._run_id,
                    "experiment": exp, "job_id": job_hex,
                    "world_size": max(1, self.cfg.learner_devices),
                    "state": "RUNNING",
                    "ts": time.time()})
                self._update = self._recorder.wrap_jit(
                    self._update, "impala_update")
        except Exception:
            self._recorder = None

        from ray_tpu_torch.rl.connectors import default_learner_pipeline

        self._pipeline = (self.cfg.learner_pipeline
                          or default_learner_pipeline(self.module_cfg))

    def update(self, batch: dict) -> dict:
        import torch

        from ray_tpu_torch.rl.learner import batch_to

        rec = getattr(self, "_recorder", None)
        if rec is not None:
            # close the inter-update data_wait armed after the last
            # step; if it never closes the stall watchdog flags the
            # learner ingest-starved
            rec.end_phase()
            rec.begin_phase("h2d")
        # where the batch arrived: tensors rebuilt by a device edge, or
        # host numpy (the per-call path, host edges)
        where = ",".join(sorted({str(v.device) if isinstance(
            v, torch.Tensor) else "host" for k, v in batch.items()
            if k != "episode_returns"}))
        self.batch_arrivals[where] = self.batch_arrivals.get(where, 0) + 1
        batch = self._pipeline(batch)
        jb = batch_to({k: v for k, v in batch.items()
                       if k != "episode_returns"}, self.device)
        if rec is not None:
            rec.end_phase()
            rec.begin_phase("step")
        self.params, self.optimizer, aux = self._update(
            self.params, self.optimizer, jb)
        self.num_updates += 1
        out = {k: float(v) for k, v in aux.items()}  # waits for the step
        if rec is not None:
            rec.end_phase()
            rec.end_step(self.num_updates, loss=out.get("loss"))
            rec.begin_phase("data_wait")
        return out

    def step(self, *batch_lists) -> dict:
        """Compiled-DAG tick: consume the aggregators' ready batches
        (possibly none — the tick still flows so the pipeline never
        stalls), run one update per batch, and return fresh weights every
        ``broadcast_interval`` updates — the driver feeds them into the
        next tick's input edge, closing the Podracer weight loop over
        channels."""
        out = {"aux": {}, "updates": 0, "steps": 0,
               "episode_returns": [], "weights": None}
        for batches in batch_lists:
            for batch in (batches or []):
                out["episode_returns"].extend(
                    batch.pop("episode_returns", []))
                T, B = batch["rewards"].shape
                out["steps"] += T * B
                out["aux"] = self.update(batch)
                out["updates"] += 1
        self._since_broadcast = (getattr(self, "_since_broadcast", 0)
                                 + out["updates"])
        if out["updates"] and \
                self._since_broadcast >= self.cfg.broadcast_interval:
            # device edges broadcast the params as tensors: the output
            # edge ships their raw bytes (a clone, since the next update
            # writes the params in place and the edge owns what it is
            # given); the host path keeps the numpy copy
            from ray_tpu_torch.rl.module import clone_tree

            out["weights"] = (clone_tree(self.params)
                              if self.cfg.use_device_edges
                              else self.get_weights())
            self._since_broadcast = 0
        return out

    def get_weights(self):
        from ray_tpu_torch.rl.module import to_host

        return to_host(self.params)

    def set_weights(self, params) -> bool:
        from ray_tpu_torch.rl.learner import load_into

        load_into(self.params, params)
        if self._ranks is not None:
            self._ranks.send("sync")
            self._ranks.sync(self._leaves)
        return True

    def placement(self) -> dict:
        """Where this learner runs, for checks: its params' device and
        whether the process has a CUDA context."""
        import torch

        return {"device": str(self._leaves[0].device),
                "cuda_initialized": bool(torch.cuda.is_initialized()),
                "batch_arrivals": dict(self.batch_arrivals),
                "num_updates": self.num_updates}

    def ping(self) -> bool:
        return True


class IMPALALearnerRank:
    """Rank k > 0 of a learner over ``learner_devices`` ranks: the same
    params and optimizer as rank 0 on its own device, driven by rank 0's
    commands over the ranks' process group (``serve``)."""

    def __init__(self, module_cfg_blob: bytes, cfg_blob: bytes,
                 seed: int = 0):
        self.cfg: IMPALAConfig = cloudpickle.loads(cfg_blob)
        self.module_cfg = cloudpickle.loads(module_cfg_blob)
        self.device, self.params, self._leaves, self.optimizer = \
            _learner_state(self.module_cfg, self.cfg, seed)
        self.num_updates = 0

    def serve(self, address: str, rank: int, world: int) -> int:
        """Join rank 0's group and run its commands until it stops: an
        update of this rank's slice, or a copy of rank 0's params."""
        ranks = _LearnerRanks(world, rank, address, self.device,
                              self.cfg.call_timeout_s)
        ranks.sync(self._leaves)
        try:
            while True:
                cmd, layout = ranks.recv()
                if cmd == "update":
                    batch = ranks.split(None, layout)
                    _rank_update(self.params, self._leaves, self.optimizer,
                                 batch, self.cfg, ranks)
                    self.num_updates += 1
                elif cmd == "sync":
                    ranks.sync(self._leaves)
                else:
                    return self.num_updates
        finally:
            ranks.close()

    def get_weights(self):
        from ray_tpu_torch.rl.module import to_host

        return to_host(self.params)

    def ping(self) -> bool:
        return True


class IMPALA:
    """Algorithm driver. train() = drain completed sample futures,
    aggregate, run learner updates on every ready batch, periodically
    broadcast fresh weights; runners are immediately re-tasked, so
    sampling never waits for the learner (async actor-learner)."""

    def __init__(self, config: IMPALAConfig):
        self.config = config
        probe = make_vector_env(config.env, 1, config.seed)
        require_discrete(probe, type(self).__name__)
        obs_shape = getattr(probe, "observation_shape", None)
        if obs_shape is not None:
            # image env -> CNN module (config #4's Atari-shaped path)
            self.module_cfg = CNNModuleConfig(
                obs_shape=tuple(obs_shape), num_actions=probe.num_actions)
        else:
            self.module_cfg = MLPModuleConfig(
                observation_size=probe.observation_size,
                num_actions=probe.num_actions, hidden=tuple(config.hidden))
        module_blob = cloudpickle.dumps(self.module_cfg)
        cfg_blob = cloudpickle.dumps(config)
        self._connector_blob = cloudpickle.dumps(
            config.env_to_module) if config.env_to_module else None

        # control-plane actors FIRST: on a loaded host the worker-boot
        # queue is FIFO, and a learner created after a 256-runner fleet
        # would sit behind every runner's interpreter boot
        agg_cls = rt.remote(num_cpus=1)(AggregatorActor)
        self._aggregators = [agg_cls.remote()
                             for _ in range(config.num_aggregators)]
        self._learner, self._learner_ranks, self._learner_pg = \
            _start_learner(config, module_blob, cfg_blob)
        # asked for now, read once the runners are spawned: the fleet
        # boots while the learner does (torch, its CUDA context)
        init_weights = self._learner.get_weights.remote()

        runner_cls = rt.remote(num_cpus=1, max_restarts=-1)(EnvRunner)
        # runner spec, retained so DAG recovery can respawn REPLACEMENT
        # runners when a dead one has no restarts left (or its restart
        # times out) — the DAG's actor set is rebuildable from here
        self._runner_cls = runner_cls
        self._module_blob = module_blob
        self._spawned_runners = config.num_env_runners
        # placement-plane consult: soft co-location of the runner fleet
        # (one node when the gang fits) keeps the compiled DAG's runner
        # edges off the DCN fallback
        from ray_tpu_torch.rl.actor_manager import gang_placement_options

        gang_opts = gang_placement_options(config.num_env_runners)
        runners = []
        wave = config.boot_wave or config.num_env_runners
        for lo in range(0, config.num_env_runners, wave):
            batch = [
                runner_cls.options(**gang_opts[i]).remote(
                    config.env, config.num_envs_per_runner,
                    config.seed + i, module_blob,
                    self._connector_blob)
                for i in range(lo, min(lo + wave, config.num_env_runners))]
            if config.boot_wave:
                # stagger fleet boot: each wave's workers finish importing
                # before the next spawns (a 256-runner gang booting at
                # once floods worker startup on small hosts; ref analog:
                # worker-pool prestart throttling in the raylet)
                for r in batch:
                    try:
                        rt.get(r.ping.remote(), timeout=900)
                    except Exception:
                        pass  # FaultTolerantActorManager handles stragglers
            runners.extend(batch)
        self._runners = FaultTolerantActorManager(runners)
        self._weights_ref = rt.put(
            rt.get(init_weights, timeout=self.config.call_timeout_s))
        self._runners.foreach(
            lambda a: a.set_weights.remote(self._weights_ref))
        self._inflight: dict = {}   # sample ref -> runner
        self._agg_rr = 0
        self._updates_since_broadcast = 0
        self._iteration = 0
        self._recent_returns: list[float] = []
        self._total_steps = 0
        # compiled-DAG execution plane (Sebulba shape): built once, ticks
        # forever — see _build_dag
        self._dag = None
        self._dag_refs: list = []
        self._next_weights = None
        if config.use_compiled_dag:
            self._build_dag()

    # ----------------------------------------------- compiled-DAG plane
    def _sample_nbytes(self) -> int:
        cfg = self.config
        return _sample_fragment_nbytes(self.module_cfg,
                                       cfg.rollout_fragment_length,
                                       cfg.num_envs_per_runner)

    def _build_dag(self):
        """Wrap the compiled ring in the recovery engine: a dead runner
        mid-tick tears the ring down, restarts (or respawns) the runner,
        recompiles over the CURRENT fleet and resumes — DAG mode keeps
        worker fault tolerance instead of trading it away."""
        from ray_tpu_torch.dag.recovery import RecoverableDag

        self._dag = RecoverableDag(
            self._compile_dag, recover_cb=self._recover_runners,
            name="appo" if self.config.use_appo_loss else "impala")

    def _compile_dag(self, epoch: int = 0, recovered_from: str = ""):
        from ray_tpu_torch.dag import InputNode

        cfg = self.config
        runners = self._runners.healthy_actors()
        agg_method = ("add_many_device" if cfg.use_device_edges
                      else "add_many")
        with InputNode() as inp:
            samples = [r.sample_dag.bind(inp, cfg.rollout_fragment_length)
                       for r in runners]
            n_agg = len(self._aggregators)
            agg_outs = [
                getattr(self._aggregators[k], agg_method).bind(
                    cfg.train_batch_size, *samples[k::n_agg])
                for k in range(n_agg)]
            if cfg.use_device_edges:
                # agg→learner batches + learner→driver weights ride
                # device edges (raw host bytes, zero host pickle);
                # runner→agg fragments are host numpy and stay on the
                # host framing
                for node in agg_outs:
                    node.with_tensor_transport()
            out = self._learner.step.bind(*agg_outs)
            if cfg.use_device_edges:
                out.with_tensor_transport()
        # slot sizing: the widest edge is agg→learner, which can carry a
        # whole tick's worth of batches (every runner's fragment,
        # re-concatenated) — and a RELEASED batch holds up to
        # train_batch_size timesteps accumulated across ticks (plus one
        # tick's overshoot), which can dwarf the per-tick intake; input
        # edges carry a weights broadcast. 2x headroom over raw array
        # bytes covers serialization framing.
        frag_bytes = self._sample_nbytes()
        tick_steps = (cfg.rollout_fragment_length
                      * cfg.num_envs_per_runner * max(1, len(runners)))
        per_step = frag_bytes / max(
            1, cfg.rollout_fragment_length * cfg.num_envs_per_runner)
        batch_bytes = 2 * int(per_step * (cfg.train_batch_size
                                          + tick_steps)) + (1 << 16)
        weights_nbytes = 2 * sum(
            int(np.asarray(w).nbytes)
            for w in _tree_leaves(rt.get(
                self._learner.get_weights.remote(),
                timeout=cfg.call_timeout_s))) + (1 << 16)
        buf = max(2 * frag_bytes * max(1, len(runners)) + (1 << 16),
                  batch_bytes, weights_nbytes, 1 << 20)
        return out.experimental_compile(
            buffer_size_bytes=buf,
            max_inflight=max(2, cfg.max_requests_in_flight),
            # weight broadcasts over the input edges ride the device
            # framing too, closing the on-device loop driver-side
            device_input=cfg.use_device_edges,
            epoch=epoch, recovered_from=recovered_from)

    def _recover_runners(self, failed: dict):
        """RecoverableDag recover_cb. Runners are restartable
        (max_restarts=-1): wait for the GCS to bring each one back
        ALIVE, and respawn a replacement from the stored spec when one
        stays dead past the restart budget. Aggregator/learner death is
        fatal — the learner's params live nowhere else. Restarted and
        replacement runners re-init from the ORIGINAL module blob, so
        push the learner's CURRENT weights before the ring recompiles
        (bounded loss: only the dead runner's in-flight fragments)."""
        from ray_tpu_torch._internal.config import get_config
        from ray_tpu_torch.dag.recovery import DagRecoveryError, wait_actor_alive

        cfg = self.config
        by_hex = {a._actor_id.hex(): a for a in self._runners._actors}
        fatal = [h for h in failed if h not in by_hex]
        if fatal:
            raise DagRecoveryError(
                f"non-runner DAG peers died ({fatal}): aggregator/"
                "learner state is not recoverable — restart training "
                "from a checkpoint")
        timeout = get_config().dag_recovery_restart_timeout_s
        for hexid in failed:
            runner = by_hex[hexid]
            state = wait_actor_alive(runner, timeout)
            if state != "ALIVE":
                # no restarts left (or restart timed out): respawn a
                # replacement runner from the retained spec
                replacement = self._runner_cls.remote(
                    cfg.env, cfg.num_envs_per_runner,
                    cfg.seed + self._spawned_runners,
                    self._module_blob, self._connector_blob)
                self._spawned_runners += 1
                self._runners.replace(runner, replacement)
        self._runners.probe_unhealthy(timeout=timeout)
        self._weights_ref = rt.put(
            rt.get(self._learner.get_weights.remote(),
                   timeout=cfg.call_timeout_s))
        self._runners.foreach(
            lambda a: a.set_weights.remote(self._weights_ref))

    def _train_dag(self) -> dict:
        """One iteration on the compiled DAG: keep `max_requests_in_flight`
        ticks pipelined through the rings, drain results until at least
        one learner update ran; weights returned by the learner ride the
        NEXT tick's input edge to every runner."""
        from ray_tpu_torch.util import builtin_metrics as _bm

        cfg = self.config
        t0 = time.perf_counter()
        aux_last: dict = {}
        updates = 0
        depth = max(2, cfg.max_requests_in_flight)
        deadline = time.monotonic() + 4 * cfg.call_timeout_s
        want = max(1, cfg.min_updates_per_iteration)
        soft_cap = time.monotonic() + 5.0
        algo = "appo" if cfg.use_appo_loss else "impala"
        while updates < want and time.monotonic() < deadline:
            if updates > 0 and time.monotonic() > soft_cap:
                break  # slow env: return what we have past the soft cap
            while len(self._dag_refs) < depth:
                self._dag_refs.append(self._dag.execute(self._next_weights))
                self._next_weights = None
            # pipeline-depth staleness: the result consumed now was
            # computed len(_dag_refs) ticks ago (the in-flight window) —
            # exactly the weight-staleness bound the Podracer pipeline
            # imposes; visible so the depth/throughput trade is tunable
            _bm.rl_dag_staleness.set(len(self._dag_refs),
                                     tags={"algo": algo})
            ref = self._dag_refs.pop(0)
            res = ref.get(timeout=4 * cfg.call_timeout_s)
            self._recent_returns.extend(res["episode_returns"])
            self._recent_returns = self._recent_returns[-100:]
            self._total_steps += res["steps"]
            updates += res["updates"]
            if res["aux"]:
                aux_last = res["aux"]
            if res["weights"] is not None:
                # copy-on-hold: the weights arrays alias an output ring
                # slot; held across ticks they would pin it
                self._next_weights = _tree_copy(res["weights"])
                _bm.rl_dag_weight_broadcasts.inc(tags={"algo": algo})
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "episode_return_mean": (float(np.mean(self._recent_returns))
                                    if self._recent_returns else 0.0),
            "num_env_steps_sampled": self._total_steps,
            "num_learner_updates": updates,
            "time_this_iter_s": time.perf_counter() - t0,
            **{f"learner/{k}": v for k, v in aux_last.items()},
        }

    def _pump_runners(self):
        cfg = self.config
        counts: dict = {}
        for ref, runner in self._inflight.items():
            counts[id(runner)] = counts.get(id(runner), 0) + 1
        for runner in self._runners.healthy_actors():
            while counts.get(id(runner), 0) < cfg.max_requests_in_flight:
                ref = runner.sample.remote(cfg.rollout_fragment_length)
                self._inflight[ref] = runner
                counts[id(runner)] = counts.get(id(runner), 0) + 1

    def train(self) -> dict:
        """One iteration: process sample results until at least one
        learner update has run."""
        if self._dag is not None:
            return self._train_dag()
        cfg = self.config
        t0 = time.perf_counter()
        aux_last: dict = {}
        updates = 0
        deadline = time.monotonic() + 4 * cfg.call_timeout_s
        while updates == 0 and time.monotonic() < deadline:
            self._pump_runners()
            if not self._inflight:
                self._runners.probe_unhealthy()
                if not self._runners.healthy_actors():
                    raise RuntimeError("all env runners unhealthy")
                continue
            ready, _ = rt.wait(list(self._inflight),
                               num_returns=1, timeout=10.0)
            for ref in ready:
                runner = self._inflight.pop(ref)
                agg = self._aggregators[self._agg_rr % len(self._aggregators)]
                self._agg_rr += 1
                try:
                    batch = rt.get(agg.add.remote(ref, cfg.train_batch_size),
                                   timeout=cfg.call_timeout_s)
                except Exception:
                    self._runners.probe_unhealthy()
                    continue
                # re-task the runner right away (async pipeline)
                self._pump_runners()
                if batch is None:
                    continue
                self._recent_returns.extend(batch.pop("episode_returns"))
                self._recent_returns = self._recent_returns[-100:]
                T, B = batch["rewards"].shape
                self._total_steps += T * B
                aux_last = rt.get(self._learner.update.remote(batch),
                                  timeout=max(300.0, cfg.call_timeout_s))
                updates += 1
                self._updates_since_broadcast += 1
            if self._updates_since_broadcast >= cfg.broadcast_interval:
                self._broadcast_weights()
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "episode_return_mean": (float(np.mean(self._recent_returns))
                                    if self._recent_returns else 0.0),
            "num_env_steps_sampled": self._total_steps,
            "num_learner_updates": updates,
            "time_this_iter_s": time.perf_counter() - t0,
            **{f"learner/{k}": v for k, v in aux_last.items()},
        }

    def _broadcast_weights(self):
        self._weights_ref = rt.put(
            rt.get(self._learner.get_weights.remote(),
                   timeout=self.config.call_timeout_s))
        self._runners.foreach(
            lambda a: a.set_weights.remote(self._weights_ref))
        self._updates_since_broadcast = 0

    # ------------------------------------------------------- checkpointable
    def save_to_path(self, path: str) -> str:
        import os
        import pickle

        os.makedirs(path, exist_ok=True)
        weights = rt.get(self._learner.get_weights.remote(),
                         timeout=self.config.call_timeout_s)
        with open(os.path.join(path, "algorithm_state.pkl"), "wb") as f:
            pickle.dump({"weights": weights, "iteration": self._iteration,
                         "config": self.config}, f)
        return path

    def restore_from_path(self, path: str) -> None:
        import os
        import pickle

        with open(os.path.join(path, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self._iteration = state["iteration"]
        rt.get(self._learner.set_weights.remote(state["weights"]),
               timeout=self.config.call_timeout_s)
        self._broadcast_weights()

    def stop(self):
        if self._dag is not None:
            try:
                self._dag.teardown()
            except Exception:
                pass
            self._dag = None
        for a in (self._runners._actors + self._aggregators
                  + [self._learner] + self._learner_ranks):
            try:
                rt.kill(a)
            except Exception:
                pass
        if self._learner_pg is not None:
            try:
                rt.remove_placement_group(self._learner_pg)
            except Exception:
                pass
            self._learner_pg = None
