"""Built-in instrumentation metrics emitted from the hot paths (ref
analog: the reference's ray_metrics_* / serve_* / train telemetry
families surfaced on every cluster by default).

One module owns the definitions so the dashboard, tests, and call sites
agree on names and tag keys. All emission rides the batched publisher in
util/metrics.py, so a call here costs a lock + dict update. Tag keys are
deliberately low-cardinality: task metrics tag only by kind
(task/actor), never by task name.

Families:
* ``rayt_task_*`` — core worker: scheduling (submit→lease) and
  execution latency histograms, owner queue depth, submit/finish
  counters.
* ``rayt_node_*`` — node manager resource gauges (emitted directly on
  the node manager's GCS connection; see node_manager.py — that process
  has no core worker).
* ``rayt_serve_*`` — replica QPS counter + request latency histogram.
* ``rayt_train_*`` — per-report tokens/sec + MFU gauges and a generic
  per-key gauge for everything else a train loop reports.
"""

from __future__ import annotations

from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

# sub-millisecond to a minute: covers scheduling RTTs and user tasks
LATENCY_BOUNDS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                  0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# ---- core worker ----
task_sched_latency = Histogram(
    "rayt_task_sched_latency_s",
    "Submission-to-lease-grant latency (owner-side queueing + "
    "scheduling)", boundaries=LATENCY_BOUNDS)
task_exec_latency = Histogram(
    "rayt_task_exec_latency_s",
    "Task body execution wall time on the worker",
    boundaries=LATENCY_BOUNDS, tag_keys=("kind",))
task_queue_depth = Gauge(
    "rayt_task_queue_depth",
    "Tasks submitted by this owner and not yet finished",
    tag_keys=("owner",))  # per-owner series; without the tag every
# process would last-write-win the same series and the chart would flap
tasks_submitted = Counter(
    "rayt_tasks_submitted_total", "Normal tasks submitted")
tasks_finished = Counter(
    "rayt_tasks_finished_total", "Normal tasks finished",
    tag_keys=("status",))

# ---- serve ----
serve_requests = Counter(
    "rayt_serve_requests_total", "Requests handled per deployment",
    tag_keys=("app", "deployment"))
serve_request_latency = Histogram(
    "rayt_serve_request_latency_s", "Replica request handling latency",
    boundaries=LATENCY_BOUNDS, tag_keys=("app", "deployment"))
serve_admitted = Counter(
    "rayt_serve_admitted_total",
    "Requests admitted through an ingress proxy's admission window",
    tag_keys=("app", "proxy"))
serve_shed = Counter(
    "rayt_serve_shed_total",
    "Requests shed at an ingress proxy (admission window full, router "
    "queue timeout, or request timeout) — 503/RESOURCE_EXHAUSTED, "
    "never a 500", tag_keys=("app", "proxy", "reason"))
serve_autoscale_decision = Gauge(
    "rayt_serve_autoscale_decision",
    "Target replica count the controller's autoscaler decided on its "
    "last reconcile tick (post-hysteresis)",
    tag_keys=("app", "deployment"))
serve_handle_queued = Gauge(
    "rayt_serve_handle_queued",
    "Requests parked in a DeploymentHandle's capacity gate (every "
    "replica at max_ongoing_requests); per-handle series — the "
    "controller sums them (merge) as the autoscaler's queue-depth "
    "signal", tag_keys=("app", "deployment", "handle"))
serve_affinity = Counter(
    "rayt_serve_affinity_total",
    "Multiplexed-model routing outcomes at the handle: hit (an "
    "affinity replica had the adapter resident and a free slot), spill "
    "(every affinity target saturated — the pow-2 pick joins the "
    "affinity set), cold (first request for the model id)",
    tag_keys=("app", "result"))
serve_mux_loads = Counter(
    "rayt_serve_mux_loads_total",
    "Multiplex LRU model loads (a cold adapter entering a replica's "
    "cache)", tag_keys=("loader",))
serve_mux_evictions = Counter(
    "rayt_serve_mux_evictions_total",
    "Multiplex LRU evictions (steady-state growth = hot adapters "
    "thrashing the per-replica cache)", tag_keys=("loader",))

# ---- train ----
train_tokens_per_s = Gauge(
    "rayt_train_tokens_per_s",
    "Training throughput from session.report (tokens_per_s passthrough "
    "or tokens/dt)", tag_keys=("experiment", "rank"))
train_mfu = Gauge(
    "rayt_train_mfu", "Model FLOPs utilization reported by the train "
    "loop", tag_keys=("experiment", "rank"))
train_metric = Gauge(
    "rayt_train_metric", "Generic per-key gauge of scalar train-report "
    "metrics", tag_keys=("experiment", "rank", "key"))

# ---- ingest (train/ingest.py corpus prefetch bridge) ----
ingest_tokens_per_s = Gauge(
    "rayt_ingest_tokens_per_s",
    "Corpus-ingest delivery throughput per worker (tokens in batch / "
    "time since previous batch)", tag_keys=("experiment", "rank"))
ingest_stall_s = Counter(
    "rayt_ingest_stall_s_total",
    "Consumer seconds blocked waiting on the prefetch queue (nonzero "
    "growth at steady state means ingest can't keep up with the train "
    "step)", tag_keys=("experiment", "rank"))
ingest_batches = Counter(
    "rayt_ingest_batches_total", "Batches delivered to the train loop",
    tag_keys=("experiment", "rank"))

# ---- data exchange (data/exchange.py all-to-all controller) ----
data_exchange_bytes = Counter(
    "rayt_data_exchange_bytes_total",
    "Bytes of shard objects moved through the exchange plane (map-task "
    "shard outputs, by owner object metadata)", tag_keys=("op",))
data_exchange_partitions = Counter(
    "rayt_data_exchange_partitions_total",
    "Output partitions produced by exchanges", tag_keys=("op",))
data_exchange_reduce_wait = Counter(
    "rayt_data_exchange_reduce_wait_s",
    "Cumulative seconds ready shards waited before a reduce-side task "
    "consumed them (near zero when map and reduce pipeline well)",
    tag_keys=("op",))

# ---- object plane (core_worker leak watchdog; see `rayt memory`) ----
object_leaks_flagged = Counter(
    "rayt_object_leaks_flagged_total",
    "Shm segments flagged by the leak watchdog: get-pins outlived every "
    "counted ref past RAYT_OBJECT_LEAK_GRACE_S")

# ---- RL on the compiled-DAG plane (rl/impala.py, rl/ppo.py) ----
rl_dag_staleness = Gauge(
    "rayt_rl_dag_staleness_ticks",
    "Ticks in flight through the compiled-DAG pipeline when a result "
    "was consumed — the weight-staleness bound the pipeline depth "
    "imposes", tag_keys=("algo",))
rl_dag_weight_broadcasts = Counter(
    "rayt_rl_dag_weight_broadcasts_total",
    "Weight broadcasts ridden over the DAG's input edge to the runner "
    "fleet", tag_keys=("algo",))


def node_gauge_records(node_hex: str, *, resources_total: dict,
                       resources_available: dict, num_workers: int,
                       object_store_bytes: int,
                       object_store_capacity: int, ts: float) -> list:
    """Build the node manager's resource-utilization gauge records.

    The node manager has no core worker, so it can't use the Gauge
    class; it publishes raw records on its GCS connection instead. This
    helper keeps the names/tags next to the rest of the family."""
    recs = []

    def g(name, value, **tags):
        recs.append({"name": name, "kind": "gauge", "value": float(value),
                     "tags": {"node": node_hex, **tags}, "ts": ts})

    for res, total in resources_total.items():
        avail = float(resources_available.get(res, 0.0))
        g("rayt_node_resource_total", total, resource=res)
        g("rayt_node_resource_available", avail, resource=res)
        if total:
            g("rayt_node_resource_utilization", 1.0 - avail / total,
              resource=res)
    g("rayt_node_workers", num_workers)
    g("rayt_node_object_store_bytes", object_store_bytes)
    if object_store_capacity:
        g("rayt_node_object_store_utilization",
          object_store_bytes / object_store_capacity)
    return recs


def object_store_gauge_records(node_hex: str, stats: dict, *,
                               ts: float) -> list:
    """Object-plane store gauges from a node manager's store snapshot
    (node_manager._store_stats): byte-level occupancy split + segment /
    zombie / fallback counters, so `rayt memory` numbers are graphable
    and alertable from Prometheus. Emitted on the node manager's GCS
    connection next to the resource gauges (that process has no core
    worker)."""
    recs = []

    def g(name, value):
        recs.append({"name": name, "kind": "gauge", "value": float(value),
                     "tags": {"node": node_hex}, "ts": ts})

    g("rayt_object_store_used_bytes", stats.get("used_bytes", 0))
    g("rayt_object_store_capacity_bytes", stats.get("capacity_bytes", 0))
    g("rayt_object_store_pinned_bytes", stats.get("pinned_bytes", 0))
    g("rayt_object_store_spilled_bytes", stats.get("spilled_bytes", 0))
    g("rayt_object_store_zombie_bytes", stats.get("zombie_bytes", 0))
    g("rayt_object_store_fallback_bytes", stats.get("fallback_bytes", 0))
    g("rayt_object_store_objects", stats.get("num_objects", 0))
    g("rayt_object_store_segments", stats.get("segments", 0))
    g("rayt_object_store_zombie_segments",
      stats.get("zombie_segments", 0))
    g("rayt_object_store_zombies_swept_total",
      stats.get("zombies_swept_total", 0))
    if "arena_used_bytes" in stats:
        g("rayt_object_store_arena_used_bytes", stats["arena_used_bytes"])
        g("rayt_object_store_arena_evictions_total",
          stats.get("arena_evictions_total", 0))
    return recs


def dag_edge_metric_records(dag_hex: str, edge: str, *, ticks: int = 0,
                            nbytes: int = 0, write_block_s: float = 0.0,
                            read_block_s: float = 0.0,
                            occupancy=None, ts: float = 0.0) -> list:
    """Compiled-DAG per-edge metrics, derived by the GCS dag manager
    from `dag_state` report deltas (the GCS process has no core worker,
    so — like the node manager's gauges — it builds raw records and
    feeds its own metrics store). Counter records carry DELTAS; the
    store sums them. Tag cardinality is one series per live (dag, edge),
    bounded by the dag manager's record cap."""
    tags = {"dag": dag_hex, "edge": edge}
    recs = []

    def rec(name, kind, value):
        recs.append({"name": name, "kind": kind, "value": float(value),
                     "tags": tags, "ts": ts})

    if ticks:
        rec("rayt_dag_ticks_total", "counter", ticks)
    if nbytes:
        rec("rayt_dag_bytes_total", "counter", nbytes)
    if write_block_s:
        rec("rayt_dag_write_block_s_total", "counter", write_block_s)
    if read_block_s:
        rec("rayt_dag_read_block_s_total", "counter", read_block_s)
    if occupancy is not None:
        rec("rayt_dag_ring_occupancy", "gauge", occupancy)
    return recs


def dag_stalled_gauge_record(stalled_edges: int, *, ts: float) -> dict:
    """Cluster-wide count of stall-watchdog-flagged DAG edges."""
    return {"name": "rayt_dag_stalled_edges", "kind": "gauge",
            "value": float(stalled_edges), "tags": {}, "ts": ts}


def sched_metric_records(node_hex: str, *, spillbacks: int = 0,
                         infeasible: int = 0, queue_wait_s: float = 0.0,
                         pending=None, ts: float = 0.0) -> list:
    """Scheduling-plane metrics, derived by the GCS event manager from
    node managers' coalesced decision-trace reports (the GCS process
    has no core worker, so — like the dag manager — it builds raw
    records and feeds its own metrics store). Counter records carry
    DELTAS; the store sums them. One series per node."""
    tags = {"node": node_hex}
    recs = []

    def rec(name, kind, value):
        recs.append({"name": name, "kind": kind, "value": float(value),
                     "tags": tags, "ts": ts})

    if spillbacks:
        rec("rayt_sched_spillbacks_total", "counter", spillbacks)
    if infeasible:
        rec("rayt_sched_infeasible_total", "counter", infeasible)
    if queue_wait_s:
        rec("rayt_sched_queue_wait_s_total", "counter", queue_wait_s)
    if pending is not None:
        rec("rayt_sched_pending_leases", "gauge", pending)
    return recs


def quota_throttled_records(node_hex: str, throttled: dict, *,
                            ts: float = 0.0) -> list:
    """Per-job quota-throttle verdict counters, derived by the GCS event
    manager from node managers' sched-report deltas (counter records
    carry DELTAS; the store sums them). One series per (node, job) —
    bounded by jobs actually throttled, not by all jobs."""
    return [{"name": "rayt_sched_quota_throttled_total", "kind": "counter",
             "value": float(n),
             "tags": {"node": node_hex, "job": job_hex}, "ts": ts}
            for job_hex, n in throttled.items() if n]


def dag_preferred_kind_record(dag_hex: str, ratio: float, *,
                              ts: float = 0.0) -> dict:
    """The placement-quality gauge (defined in core/placement.py): the
    fraction of a DAG's compiled edges whose transport avoided the DCN
    fallback — device/shm where the payload prefers it. Derived by the
    GCS dag manager from DAG register reports."""
    return {"name": "rayt_dag_edges_preferred_kind_ratio",
            "kind": "gauge", "value": float(ratio),
            "tags": {"dag": dag_hex}, "ts": ts}


def serve_request_metric_records(app: str, *, queue_wait_s=None,
                                 ttft_s=None, tpot_s=None,
                                 prefill_s=None, ts: float = 0.0) -> list:
    """Per-request serve-path histograms, derived by the GCS serve
    manager from finalized request records (the GCS process has no core
    worker, so — like the dag/event managers — it builds raw records
    and feeds its own metrics store). Each record is one raw
    observation (the store's legacy histogram path buckets it into
    LATENCY_BOUNDS); derivation happens before tail-biased sampling, so
    the series are unskewed by the retention rate."""
    tags = {"app": app}
    bounds = list(LATENCY_BOUNDS)
    recs = []

    def hist(name, value):
        if value is not None:
            recs.append({"name": name, "kind": "histogram",
                         "value": float(value), "tags": tags, "ts": ts,
                         "bounds": bounds})

    hist("rayt_serve_queue_wait_s", queue_wait_s)
    hist("rayt_serve_ttft_s", ttft_s)
    hist("rayt_serve_tpot_s", tpot_s)
    hist("rayt_serve_prefill_s", prefill_s)
    return recs


def serve_engine_metric_records(app: str, deployment: str, replica: str,
                                *, prefills: int = 0,
                                prefill_chunks: int = 0,
                                decode_steps: int = 0, occupancy=None,
                                ts: float = 0.0) -> list:
    """Engine health metrics, derived by the GCS serve manager from the
    DELTAS between consecutive cumulative replica engine reports
    (counter records carry deltas; the store sums them). One counter
    series per (app, deployment); the occupancy gauge adds the replica
    tag so a lopsided decode batch is attributable."""
    tags = {"app": app, "deployment": deployment}
    recs = []

    def rec(name, kind, value, tg):
        recs.append({"name": name, "kind": kind, "value": float(value),
                     "tags": tg, "ts": ts})

    if prefills:
        rec("rayt_serve_engine_prefills_total", "counter", prefills, tags)
    if prefill_chunks:
        rec("rayt_serve_engine_prefill_chunks_total", "counter",
            prefill_chunks, tags)
    if decode_steps:
        rec("rayt_serve_engine_decode_steps_total", "counter",
            decode_steps, tags)
    if occupancy is not None:
        rec("rayt_serve_decode_batch_occupancy", "gauge", occupancy,
            {**tags, "replica": replica})
    return recs


def serve_data_plane_metric_records(app: str, *, prefix_outcome=None,
                                    proxy=None, kv_bytes: int = 0,
                                    edge_kind: str = "",
                                    ts: float = 0.0) -> list:
    """Serve data-plane counters, derived by the GCS serve manager from
    every finalized request record (before tail-biased sampling):
    prefix-cache routing outcome (hit / spill / cold), per-proxy
    admission attribution across the sharded ingress fleet, and KV
    handoff volume per edge kind for disaggregated prefill/decode."""
    recs = []
    if prefix_outcome:
        recs.append({"name": "rayt_serve_prefix_cache_total",
                     "kind": "counter", "value": 1.0,
                     "tags": {"app": app, "outcome": str(prefix_outcome)},
                     "ts": ts})
    if proxy:
        recs.append({"name": "rayt_serve_proxy_admitted_total",
                     "kind": "counter", "value": 1.0,
                     "tags": {"proxy": str(proxy)}, "ts": ts})
    if kv_bytes:
        recs.append({"name": "rayt_serve_kv_handoff_bytes_total",
                     "kind": "counter", "value": float(kv_bytes),
                     "tags": {"edge_kind": edge_kind or "shm"}, "ts": ts})
    return recs


def heartbeat_gap_records(gaps: dict, *, ts: float) -> list:
    """Per-node heartbeat-gap gauges (seconds since the node's last
    heartbeat reached the GCS) — the liveness staleness `rayt status`
    renders, graphable from Prometheus. Emitted by the GCS's own gap
    loop (raw records; no core worker in that process)."""
    return [{"name": "rayt_node_heartbeat_gap_s", "kind": "gauge",
             "value": float(gap), "tags": {"node": node_hex}, "ts": ts}
            for node_hex, gap in gaps.items()]


def train_step_metric_records(experiment: str, *, step_s=None,
                              data_wait_s=None, h2d_s=None,
                              ckpt_block_s=None, ts: float = 0.0) -> list:
    """Per-step train waterfall histograms, derived by the GCS train
    manager from every step record BEFORE retention/eviction decisions
    (the GCS process has no core worker, so — like the dag/serve
    managers — it builds raw records and feeds its own metrics store).
    Each record is one raw observation bucketed into LATENCY_BOUNDS."""
    tags = {"experiment": experiment}
    bounds = list(LATENCY_BOUNDS)
    recs = []

    def hist(name, value):
        if value is not None:
            recs.append({"name": name, "kind": "histogram",
                         "value": float(value), "tags": tags, "ts": ts,
                         "bounds": bounds})

    hist("rayt_train_step_s", step_s)
    hist("rayt_train_data_wait_s", data_wait_s)
    hist("rayt_train_h2d_s", h2d_s)
    hist("rayt_train_ckpt_block_s", ckpt_block_s)
    return recs


def train_compile_metric_records(experiment: str, *, event: str,
                                 ts: float = 0.0) -> list:
    """One XLA compile/retrace event -> rayt_train_compiles_total delta
    (counter records carry DELTAS; the store sums them). The ``event``
    tag splits first-trace compiles from mid-training retraces — the
    latter going non-zero during steady state is the perf bug."""
    return [{"name": "rayt_train_compiles_total", "kind": "counter",
             "value": 1.0,
             "tags": {"experiment": experiment, "event": event},
             "ts": ts}]


def device_memory_gauge_records(node_hex: str, devices, *,
                                ts: float = 0.0) -> list:
    """Per-device memory gauges from a worker's memory
    snapshot: bytes in use + peak, tagged (node, device) so one hot
    device on one host is attributable from Prometheus alone."""
    recs = []
    for d in devices or ():
        tags = {"node": node_hex, "device": str(d.get("device") or "")}
        for name, key in (("rayt_device_memory_used_bytes",
                           "bytes_in_use"),
                          ("rayt_device_memory_peak_bytes",
                           "peak_bytes")):
            if d.get(key) is not None:
                recs.append({"name": name, "kind": "gauge",
                             "value": float(d[key]), "tags": tags,
                             "ts": ts})
    return recs
