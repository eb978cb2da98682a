"""Runtime configuration flags.

TPU-native analog of the reference's ``RAY_CONFIG`` macro table
(ref: src/ray/common/ray_config_def.h): a single typed flag registry,
overridable via ``RAYT_<NAME>`` environment variables, serialized to every
spawned process so the whole cluster sees one consistent view.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

_ENV_PREFIX = "RAYT_"


@dataclasses.dataclass
class Config:
    # ---- RPC / control plane ----
    rpc_connect_timeout_s: float = 10.0
    rpc_request_timeout_s: float = 60.0
    rpc_retry_delay_s: float = 0.1
    rpc_max_retries: int = 5
    # Fault-injection: probability of dropping an RPC before send / before
    # reply delivery (analog of RAY_testing_rpc_failure, ref:
    # src/ray/rpc/rpc_chaos.h:23). 0 disables.
    testing_rpc_failure_prob: float = 0.0
    # Deterministic chaos seed (0 = nondeterministic).
    testing_chaos_seed: int = 0

    # ---- GCS / head ----
    gcs_health_check_period_s: float = 1.0
    gcs_health_check_timeout_s: float = 5.0
    gcs_health_check_failure_threshold: int = 5
    # Snapshot path for GCS table persistence ("" = in-memory only). With
    # a path set, a restarted head reloads cluster state and nodes
    # re-register (ref analog: gcs/store_client/redis_store_client.h).
    gcs_persist_path: str = ""
    # Mark a node dead after this many seconds without a heartbeat (used
    # after head restart, when the death-detecting connection is gone).
    node_death_timeout_s: float = 10.0
    # ---- node drain / preemption lifecycle ----
    # Default deadline for rt.drain_node when the caller passes none: the
    # drain coordinator must finish migrating the node's workloads
    # (actors, serve replicas, PG bundles, sole object copies) within
    # this budget; at the deadline the node is declared DRAINED with
    # whatever migrated (remaining workloads fall back to the reactive
    # death-recovery paths when the node actually goes away).
    drain_deadline_s: float = 300.0
    # Poll cadence of the drain coordinator while it waits for migrated
    # actors to come back ALIVE elsewhere.
    drain_poll_interval_s: float = 0.25
    # Preemption watcher (node_manager): when set, each node polls this
    # file path (formatted with {node_id} if present); the file appearing
    # simulates the TPU maintenance-event endpoint and the node
    # self-initiates a drain. The file body may be JSON
    # {"deadline_s": ..., "reason": ...}; empty body uses defaults.
    preemption_notice_file: str = ""
    preemption_poll_interval_s: float = 1.0
    # A PENDING placement group whose driver has not polled
    # get_pending_demand status for this long is pruned as abandoned
    # (was a hardcoded 15s; the prune now records a WARNING
    # `placement_group_pruned` cluster event).
    pg_pending_poll_timeout_s: float = 15.0
    # ---- scheduler ----
    lease_timeout_s: float = 30.0
    # GCS gives up placing a PENDING actor after this (ref: actor
    # scheduling; raise on oversubscribed hosts where fleet boot is slow)
    actor_scheduling_deadline_s: float = 300.0
    # GCS -> node start_actor push timeout. The node bounds its own
    # worker-startup wait + create call strictly BELOW this so a timed-out
    # push can't leave a ghost actor instance holding leased resources.
    actor_creation_push_timeout_s: float = 330.0
    worker_startup_timeout_s: float = 60.0
    # Keep a granted lease (worker + resources) cached for this long after
    # a task finishes so back-to-back tasks with the same resource shape
    # skip the lease round-trip (ref: normal_task_submitter.cc:291 lease
    # reuse). 0 disables caching.
    lease_reuse_idle_s: float = 1.0
    # Largest number of leases one batched request_lease asks for: the
    # driver's per-scheduling-key pool sizes requests to its waiter-queue
    # depth during bursts instead of one RPC round-trip per task.
    lease_batch_max: int = 64
    # Worker-side loaded-code LRU capacity (function table entries kept
    # per worker process; see core/function_table.py).
    fn_cache_size: int = 256
    # Max workers booting (spawned, not yet registered) at once per
    # node; further creations queue (boot-storm throttle for fleets).
    max_concurrent_worker_boots: int = 8
    # Number of pre-forked idle workers kept per node.
    idle_worker_pool_size: int = 1
    idle_worker_ttl_s: float = 300.0
    # Top-k candidate nodes considered by the hybrid scheduling policy
    # (analog of ref raylet/scheduling/policy/hybrid_scheduling_policy.h:85).
    scheduler_top_k_fraction: float = 0.2
    scheduler_spread_threshold: float = 0.5

    # ---- object store ----
    # Objects <= this many bytes are returned inline in RPC replies /
    # stored in the owner's in-process memory store.
    max_direct_call_object_size: int = 100 * 1024
    # Shared-memory store capacity (bytes). 0 = auto (30% of system RAM).
    object_store_memory: int = 0
    # ---- node-to-node object transfer (ref: pull_manager.h:52,
    # push_manager.h:30, object_buffer_pool chunking) ----
    # Transfer chunk size; objects larger than this stream in pieces.
    object_transfer_chunk_bytes: int = 4 * 1024 * 1024
    # Parallel chunk requests per pull (pipeline depth over one link).
    object_transfer_max_inflight_chunks: int = 8
    # Pull admission control: total bytes of objects being pulled into
    # this node concurrently; excess pulls queue FIFO.
    pull_max_inflight_bytes: int = 256 * 1024 * 1024
    # Push throttling: concurrent outbound chunk reads served per node.
    push_max_concurrent_chunks: int = 16
    # Spill sealed objects to disk when the store passes this fraction of
    # capacity (ref: local_object_manager.h:41). 0 disables spilling.
    object_spilling_threshold: float = 0.8
    # under $TMPDIR, and apart from the TPU build's /tmp/rayt_spill, so
    # both packages' clusters can run on one host
    object_spill_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(
            os.environ.get("TMPDIR") or "/tmp", "rayt_torch_spill"))
    # Node memory watermark: above this fraction of system RAM the memory
    # monitor kills the newest retriable task worker (ref:
    # memory_monitor.h + worker_killing_policy_retriable_fifo).
    memory_usage_threshold: float = 0.95
    memory_monitor_interval_s: float = 1.0
    # Seconds a get() waits between liveness re-checks of the owner.
    get_poll_interval_s: float = 0.2

    # ---- streaming generators ----
    # Max yielded-but-unconsumed items buffered at the owner before the
    # producing worker blocks (ref: generator_backpressure_num_objects).
    generator_backpressure_num_objects: int = 16

    # ---- tasks / actors ----
    default_max_retries: int = 3
    # Max retained reconstructable-task specs (lineage) per owner; beyond
    # this, freed objects lose reconstructability (ref: RAY_max_lineage...).
    max_lineage_entries: int = 10000
    default_actor_max_restarts: int = 0
    actor_death_cache_size: int = 1024

    # ---- metrics / observability ----
    # GCS time-series store: history kept per series, and the bin width
    # records aggregate into (queries downsample to multiples of it).
    metrics_retention_s: float = 900.0
    metrics_resolution_s: float = 5.0
    # Per-process metric batcher: records aggregate locally and flush to
    # the GCS metrics channel at this cadence (hot paths never pay an
    # RPC per Counter.inc / Histogram.observe).
    metrics_flush_interval_s: float = 0.2
    # Node managers publish resource-utilization gauges at this period.
    node_metrics_period_s: float = 2.0
    # Task lifecycle events (ref: RAY_task_events_report_interval_ms /
    # gcs_task_manager): workers+node managers record per-task state
    # transitions into a local ring and flush them to the GCS task
    # manager. Disabling removes the per-submit recording cost entirely.
    task_events_enabled: bool = True
    # GCS task-manager memory bound: max coalesced task records kept;
    # beyond it the job holding the most records evicts oldest-first,
    # with per-job dropped accounting (ref: RAY_task_events_max_num_...).
    task_events_max_tasks: int = 10000
    # Object-plane observability (`rayt memory` / GcsObjectManager
    # analog): node managers and workers publish object-directory /
    # ref-breakdown deltas to the GCS on the flush cadence, puts/returns
    # capture a creation callsite, and the worker flush loop runs the
    # shm-leak watchdog. Disabling removes the per-put capture cost and
    # all report traffic.
    object_state_enabled: bool = True
    # GCS object-manager memory bound: max coalesced object records;
    # same per-job oldest-first eviction + dropped accounting contract
    # as task_events_max_tasks.
    object_state_max_objects: int = 20000
    # A shm segment that outlived every counted ref but still holds
    # get-pins for longer than this is flagged by the leak watchdog
    # (pins held by live zero-copy views are legal — the flag marks
    # ones that look forgotten, surfaced via `rayt memory` summaries).
    object_leak_grace_s: float = 5.0
    # ---- compiled-DAG execution-plane observability ----
    # Per-tick deadline for ChannelCompiledDAG driver reads (get() with
    # no explicit timeout) and execute()'s input-channel writes. The old
    # hardcoded 300.0s, now tunable: RL loops on slow envs raise it,
    # tests shrink it.
    dag_tick_timeout_s: float = 300.0
    # Compiled-DAG stall watchdog: an edge whose producer is parked on a
    # full ring (or consumer on an empty one) for longer than this is
    # flagged in the GCS dag record; when the blocked side's peer actor
    # is DEAD, the record (and the _get_tick timeout error) names it.
    dag_stall_grace_s: float = 5.0
    # DAG-plane state reports: driver + actor loops publish per-channel
    # tick/byte/occupancy/block stats on the `dag_state` channel at this
    # cadence. Disabling removes registration, reports and the watchdog.
    dag_state_enabled: bool = True
    dag_state_report_interval_s: float = 1.0
    # GCS dag-manager memory bound: max DAG records kept; beyond it the
    # job holding the most records evicts oldest-first with per-job
    # dropped accounting (same contract as task/object managers).
    dag_state_max_dags: int = 500
    # ---- compiled-DAG recovery (dag/recovery.py) ----
    # RecoverableDag.get() re-checks peer liveness at this cadence while
    # waiting on a tick, so a dead runner is detected in ~probe seconds
    # instead of the caller's full timeout (the stall watchdog's
    # attribution rides the same check).
    dag_recovery_probe_s: float = 5.0
    # After a teardown, how long to wait for the GCS to bring each
    # restartable dead actor back to ALIVE before giving up (or handing
    # the survivors to the algorithm's recover callback to respawn
    # replacements from specs).
    dag_recovery_restart_timeout_s: float = 60.0
    # Recoveries per RecoverableDag lifetime; beyond it the failure is
    # re-raised (a crash-looping actor should fail loudly, not churn).
    dag_recovery_max_attempts: int = 8
    # ---- serve request-path observability (core/gcs_serve_manager) ----
    # Gates per-request waterfall recording end-to-end: the proxy mints
    # a request id (echoed as X-Rayt-Request-Id), each stage stamps its
    # latency, and proxy/replica publish partial records on the
    # `serve_state` channel. Disabling removes the per-request capture
    # cost and all report traffic (the id/header survive — they cost
    # nothing and stay useful for log correlation).
    serve_requests_enabled: bool = True
    # GCS serve-manager memory bound: max retained request records;
    # beyond it the app holding the most records evicts oldest-first
    # with per-app dropped accounting (same contract as the
    # task/object/DAG/event stores).
    serve_requests_max: int = 2000
    # Tail-biased retention: errors, sheds, stream aborts, and the
    # slowest decile are ALWAYS retained; happy-path requests are kept
    # at this sample rate (1.0 keeps everything; histograms derive from
    # every finalized record BEFORE the sampling drop, so Prometheus
    # series stay unskewed at any rate).
    serve_request_sample: float = 1.0
    # ---- train-plane observability (core/gcs_train_manager) ----
    # Gates per-step waterfall recording end-to-end: the controller
    # mints a run id, each worker's StepRecorder stamps the phase
    # timings (data_wait/h2d/step/ckpt_block tiling step wall), compile
    # events, and device-memory snapshots, publishing on the
    # `train_state` channel. Disabling removes the per-step capture
    # cost and all report traffic.
    train_state_enabled: bool = True
    # GCS train-manager memory bound: max retained step records; beyond
    # it the run holding the most records evicts oldest-first with
    # per-run dropped accounting (same contract as the
    # task/object/DAG/serve stores).
    train_state_max: int = 5000
    # Stall watchdog grace: a worker blocked inside ONE step phase
    # longer than this is flagged stalled with an attribution
    # (ingest-starved / checkpoint-blocked / collective-barrier) and a
    # WARNING cluster event on the transition.
    train_stall_grace_s: float = 5.0
    # StepRecorder flush cadence: step/compile records batch in-process
    # and ship once per interval; the blocked-phase heartbeat and the
    # device-memory snapshot (rate-limited to 1s) ride the same cycle.
    train_flush_interval_s: float = 1.0
    # ---- scheduling-plane observability (cluster events + traces) ----
    # Gates the cluster event log AND the lease decision tracer: node
    # managers record per-demand-shape request_lease verdicts and emit
    # structured events (worker crash/OOM-reap, node/actor lifecycle,
    # autoscaler decisions, DAG stalls) onto the `cluster_events`
    # channel; the GCS event manager stores + serves them. Disabling
    # removes the per-decision recording cost and all report traffic.
    cluster_events_enabled: bool = True
    # GCS event-manager memory bound: max events kept; beyond it the
    # job holding the most events evicts oldest-first with per-job
    # dropped accounting (same contract as the task/object/DAG stores).
    cluster_events_max: int = 10000

    # ---- logging ----
    log_level: str = "INFO"
    log_dir: str = ""

    # ---- train / collective ----
    rendezvous_timeout_s: float = 120.0
    collective_barrier_timeout_s: float = 120.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls(**json.loads(s))


def _coerce(value: str, typ: Any) -> Any:
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    return typ(value)


def load_config() -> Config:
    """Build the config, applying RAYT_* env overrides.

    If RAYT_CONFIG_JSON is set (how parent processes hand the full table to
    children, analog of ref _raylet.pyx `_config`), it is the base.
    """
    blob = os.environ.get(_ENV_PREFIX + "CONFIG_JSON")
    cfg = Config.from_json(blob) if blob else Config()
    for f in dataclasses.fields(Config):
        env = os.environ.get(_ENV_PREFIX + f.name.upper())
        if env is not None:
            setattr(cfg, f.name, _coerce(env, f.type if isinstance(f.type, type) else type(getattr(cfg, f.name))))
    return cfg


_config: Config | None = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = load_config()
    return _config


def set_config(cfg: Config) -> None:
    global _config
    _config = cfg
