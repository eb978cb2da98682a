"""CLI (ref analog: python/ray/scripts/scripts.py command set +
util/state/state_cli.py). Invoke as `python -m ray_tpu_torch <command>`.

Commands: start, stop, status, summary [tasks], list {nodes,actors,jobs,
pgs,workers,tasks,objects,dags,events,requests}, dag <id>, why-pending
<task_id>, memory, timeline, microbenchmark, job
{submit,status,logs,stop,list} (ref analog for jobs:
dashboard/modules/job/cli.py). `list requests` renders per-request
serve latency waterfalls; `serve status` appends the per-app stage
p50/p99 table.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

# the head's state, apart from the JAX package's /tmp/ray_tpu (a `stop` of
# one package's head never reads the other's), under $TMPDIR
STATE_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
PIDFILE = os.path.join(STATE_DIR, "head.pid")
ADDRFILE = os.path.join(STATE_DIR, "head.addr")
DASHFILE = os.path.join(STATE_DIR, "head.dashboard")


def _write_state(pid: int, address: str):
    os.makedirs(os.path.dirname(PIDFILE), exist_ok=True)
    with open(PIDFILE, "w") as f:
        f.write(str(pid))
    with open(ADDRFILE, "w") as f:
        f.write(address)


def _read_dashboard(args) -> str:
    if getattr(args, "dashboard_address", None):
        return args.dashboard_address
    try:
        with open(DASHFILE) as f:
            return f.read().strip()
    except OSError:
        raise SystemExit("no dashboard found (start with "
                         "`python -m ray_tpu_torch start --head`)")


def _read_address(args) -> str:
    if getattr(args, "address", None):
        return args.address
    if os.environ.get("RAYT_ADDRESS"):
        return os.environ["RAYT_ADDRESS"]
    try:
        with open(ADDRFILE) as f:
            return f.read().strip()
    except OSError:
        raise SystemExit("no running cluster found (start one with "
                         "`python -m ray_tpu_torch start --head`)")


def cmd_start(args):
    if not args.head:
        raise SystemExit("only --head is supported in-process; worker nodes "
                         "join via cluster_utils or "
                         "`ray_tpu_torch.init(address=)`")
    from ray_tpu_torch._internal.spawn import child_env, fast_python_argv

    resources = {"CPU": float(args.num_cpus or os.cpu_count() or 1)}
    labels = {}
    if args.num_gpus is not None:
        if args.num_gpus:
            resources["GPU"] = float(args.num_gpus)
    else:
        # GPU autodetect, as rt.init() does (ref analog:
        # _private/accelerators/nvidia_gpu.py): `start --head` on a GPU
        # host advertises GPU and labels the node with the part's name
        from ray_tpu_torch._internal.accelerators import detect_gpus

        info = detect_gpus()
        if info is not None:
            resources.update(info.resources())
            labels.update(info.labels())
            print(f"detected {info.count} GPU(s): {info.name or 'unknown'}")
    resources.setdefault("memory", 8 << 30)
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    os.makedirs(os.path.dirname(PIDFILE), exist_ok=True)
    # head stderr goes to a session log, NOT an inherited pipe (a caller
    # waiting on this CLI's pipes would otherwise block until the head
    # daemon exits)
    log = open(os.path.join(os.path.dirname(PIDFILE), "head.log"), "ab")
    proc = subprocess.Popen(
        fast_python_argv("ray_tpu_torch.core.head_main")
        + ["--resources", json.dumps(resources),
           "--gcs-port", str(args.port),
           "--labels", json.dumps(labels),
           "--dashboard-port", str(args.dashboard_port)],
        stdout=subprocess.PIPE, stderr=log, env=child_env(pkg_root),
        text=True, start_new_session=True)
    log.close()
    line = proc.stdout.readline()
    if not line:
        raise SystemExit("head process failed to start")
    info = json.loads(line)
    address = f"127.0.0.1:{info['gcs_port']}"
    _write_state(proc.pid, address)
    dash_port = info.get("dashboard_port", -1)
    if dash_port and dash_port > 0:
        with open(DASHFILE, "w") as f:
            f.write(f"127.0.0.1:{dash_port}")
    print(f"ray_tpu_torch head started (pid {proc.pid})")
    print(f"  address: {address}")
    if dash_port and dash_port > 0:
        print(f"  dashboard: http://127.0.0.1:{dash_port} "
              f"(/metrics, /api/jobs)")
    print(f"  attach:  ray_tpu_torch.init(address='{address}')")


def cmd_stop(args):
    try:
        with open(PIDFILE) as f:
            pid = int(f.read().strip())
    except OSError:
        print("no pidfile; nothing to stop")
        return
    try:
        os.kill(pid, signal.SIGTERM)
        for _ in range(50):
            try:
                os.kill(pid, 0)
                time.sleep(0.1)
            except ProcessLookupError:
                break
        print(f"stopped head (pid {pid})")
    except ProcessLookupError:
        print("head already gone")
    for f in (PIDFILE, ADDRFILE):
        try:
            os.remove(f)
        except OSError:
            pass


def _attach(args):
    import ray_tpu_torch as rt

    rt.init(address=_read_address(args))
    return rt


def cmd_status(args):
    """`ray status` analog: cluster summary + node table (resources,
    pending leases, heartbeat age), aggregate pending lease demand by
    shape, and recent WARNING+ cluster events."""
    from ray_tpu_torch import state_api

    _attach(args)
    status = state_api.cluster_status()
    summary = state_api.summary()
    print(f"uptime: {status['uptime_s']:.0f}s  nodes: "
          f"{summary['nodes_alive']}/{summary['nodes_total']}  actors: "
          f"{status['num_actors']}  placement groups: "
          f"{status['num_placement_groups']}")
    print("resources:")
    for k, total in sorted(summary["resources_total"].items()):
        avail = summary["resources_available"].get(k, 0.0)
        if k == "memory":
            print(f"  {k}: {avail / 1e9:.1f}/{total / 1e9:.1f} GB available")
        else:
            print(f"  {k}: {avail:g}/{total:g} available")
    _print_cluster_status(status)


def _fmt_shape(demand: dict) -> str:
    return ",".join(f"{k}:{demand[k]:g}" for k in sorted(demand)) \
        or "(none)"


def _print_cluster_status(status: dict):
    """Node table + pending demand + recent events from the enriched
    cluster_status reply (older servers lack the keys: degrade to the
    summary lines alone)."""
    nodes = status.get("nodes")
    if nodes:
        fmt = "{:<14} {:<8} {:>8} {:>8} {:<18}  {}"
        print("nodes:")
        print(fmt.format("node", "state", "hb-age", "pending",
                         "labels", "resources (avail/total)"))
        for n in nodes:
            res = " ".join(
                f"{k}={n['resources_available'].get(k, 0):g}/"
                f"{v:g}"
                for k, v in sorted(n["resources_total"].items())
                if k != "memory")
            hb = n.get("heartbeat_age_s")
            state = n.get("state") or ("ALIVE" if n["alive"] else "DEAD")
            labels = n.get("labels") or {}
            # topology first (ici-slice, dcn-locality), then the rest
            lab = " ".join(
                f"{k}={labels[k]}" for k in sorted(
                    labels, key=lambda k: (
                        k not in ("ici-slice", "dcn-locality"), k)))
            print(fmt.format(
                n["node_id"][:14], state,
                "—" if hb is None else f"{hb:.1f}s",
                str(n.get("pending_leases", 0)), lab[:18] or "—", res))
    drains = status.get("drains") or {}
    active = {h: r for h, r in drains.items()
              if r.get("state") in ("DRAINING", "DRAINED")}
    if active:
        print("drains:")
        for h, rec in sorted(active.items()):
            mig = rec.get("migrated", {})
            mig_s = " ".join(f"{k}={v}" for k, v in sorted(mig.items()))
            if rec.get("state") == "DRAINING":
                left = rec.get("deadline", 0) - time.time()
                print(f"  {h[:14]}  DRAINING ({rec.get('reason', '')}), "
                      f"{max(0.0, left):.0f}s to deadline  [{mig_s}]")
            else:
                took = (rec.get("completed", 0) or 0) - \
                    (rec.get("started", 0) or 0)
                print(f"  {h[:14]}  DRAINED in {took:.1f}s  [{mig_s}]")
    quotas = status.get("quotas") or {}
    if quotas:
        throttled = status.get("quota_throttled") or {}
        print("job quotas (fair share):")
        qfmt = "  {:<14} {:>8} {:>10} {:>10} {:>10}"
        print(qfmt.format("job", "weight", "share", "used",
                          "throttled"))
        for j, q in sorted(quotas.items()):
            share = (f"{q['share']:g} {q['resource']}"
                     if q.get("resource") else f"{q['share']:g}")
            print(qfmt.format(
                j[:14], f"{q['weight']:g}", share,
                f"{q['used']:g}", str(throttled.get(j, 0))))
    pending = status.get("pending_demand") or {}
    if pending:
        print("pending lease demand by shape:")
        for sk, e in sorted(pending.items()):
            print(f"  {{{sk}}}: {e['count']} queued on "
                  f"{len(e['nodes'])} node(s)")
    sched = status.get("scheduling") or {}
    if sched.get("spillback") or sched.get("infeasible") \
            or sched.get("queued"):
        print(f"scheduling: {sched.get('granted', 0)} granted, "
              f"{sched.get('queued', 0)} queued "
              f"({sched.get('queue_wait_s_total', 0.0):.2f}s total "
              f"wait), {sched.get('spillback', 0)} spillbacks "
              f"(max {sched.get('max_spill_hops', 0)} hops), "
              f"{sched.get('infeasible', 0)} infeasible, "
              f"{sched.get('cancelled', 0)} cancelled")
    events = status.get("recent_events")
    if events:
        import datetime

        print("recent events (warning+):")
        for e in events[:10]:
            ts = datetime.datetime.fromtimestamp(
                e["ts"]).strftime("%H:%M:%S")
            print(f"  {ts}  {e['severity']:<7} {e['source']:<12} "
                  f"{e['kind']:<20} {e['message']}")


def cmd_drain(args):
    from ray_tpu_torch import state_api

    _attach(args)
    ok = state_api.drain_node(args.node, deadline_s=args.deadline,
                              reason=args.reason or "cli")
    if not ok:
        raise SystemExit(f"drain of {args.node} rejected "
                         "(unknown or dead node)")
    print(f"draining {args.node}")
    if not args.wait:
        return
    while True:
        rec = None
        for h, r in state_api.drain_status().items():
            if h.startswith(args.node):
                rec = r
        if rec is None or rec.get("state") != "DRAINING":
            state = rec.get("state") if rec else "?"
            mig = rec.get("migrated", {}) if rec else {}
            print(f"drain finished: {state}  " +
                  " ".join(f"{k}={v}" for k, v in sorted(mig.items())))
            return
        time.sleep(0.5)


def cmd_summary(args):
    from ray_tpu_torch import state_api

    _attach(args)
    if getattr(args, "kind", None) == "tasks":
        _print_task_summary(state_api.summarize_tasks(
            job_id=getattr(args, "job", None)))
        return
    print(json.dumps(state_api.summary(), indent=2, default=str))


def _print_task_summary(s: dict):
    """`ray summary tasks`-style table: per-task-name state counts and
    the scheduling-delay vs execution-time latency split."""
    dropped = sum(s.get("dropped", {}).values())
    print(f"{s['total_tasks']} tasks stored "
          f"({dropped} evicted from the GCS store, "
          f"{s.get('worker_buffer_dropped', 0)} dropped at worker "
          "buffers cluster-wide)")
    if not s["by_name"]:
        return
    fmt = "{:<32} {:>6} {:>12} {:>12}  {}"
    print(fmt.format("name", "count", "sched_mean", "exec_mean",
                     "states"))
    for name, e in s["by_name"].items():
        def dur(v):
            return "—" if v is None else (
                f"{v * 1e3:.1f}ms" if v < 1.0 else f"{v:.2f}s")
        states = " ".join(f"{k}={v}"
                          for k, v in sorted(e["states"].items()))
        print(fmt.format(name[:32], e["count"],
                         dur(e["sched_delay_mean_s"]),
                         dur(e["exec_time_mean_s"]), states))


def _fmt_lat(v) -> str:
    if v is None:
        return "—"
    return f"{v * 1e3:.1f}ms" if v < 1.0 else f"{v:.2f}s"


def _print_requests(out: dict):
    """`rayt list requests` view: one line per request with its stage
    waterfall (proxy tiling first, then the nested replica/engine
    breakdowns when the record has them)."""
    reqs = out.get("requests", ())
    fmt = "{:<12} {:<12} {:<14} {:>9} {:>9} {:>9}  {}"
    print(fmt.format("request", "app", "outcome", "e2e", "ttft",
                     "tpot", "waterfall"))
    for r in reqs:
        st = r.get("stages") or {}
        wf = " > ".join(
            f"{k[:-2]} {_fmt_lat(st[k])}"
            for k in ("admission_s", "router_s", "dispatch_s",
                      "stream_s")
            if st.get(k) is not None)
        rs = r.get("replica_stages") or {}
        eng = r.get("engine") or {}
        if rs:
            wf += (f" | replica[queue {_fmt_lat(rs.get('queue_s'))} "
                   f"service {_fmt_lat(rs.get('service_s'))}]")
        if eng:
            occ = eng.get("occupancy_mean")
            wf += (f" | engine[queue {_fmt_lat(eng.get('queue_s'))} "
                   f"prefill {_fmt_lat(eng.get('prefill_s'))}"
                   f"x{eng.get('prefill_chunks', 0)} "
                   f"ttft {_fmt_lat(eng.get('ttft_s'))} "
                   f"tpot {_fmt_lat(eng.get('tpot_s'))}"
                   + (f" occ {occ:.2f}" if occ is not None else "")
                   + "]")
        tail = ""
        if r.get("model_id"):
            tail = f" model={r['model_id']}"
            if r.get("affinity"):
                tail += f"({r['affinity']})"
        if r.get("proxy"):
            tail += f" proxy={r['proxy']}"
        # Engine outcome wins: the proxy stamps its routing-affinity view,
        # but only the engine knows whether cached KV was actually grafted.
        pc = eng.get("prefix_cache") or r.get("prefix_cache")
        if pc:
            tail += f" prefix={pc}"
            if eng.get("prefix_hit_tokens"):
                tail += f"(+{eng['prefix_hit_tokens']}tok)"
        if eng.get("kv_handoff_bytes"):
            tail += (f" kv={eng['kv_handoff_bytes']}B/"
                     f"{eng.get('kv_handoff_edge') or 'shm'}")
        print(fmt.format(r.get("request_id", "")[:12],
                         (r.get("app") or "")[:12],
                         r.get("outcome") or "ok",
                         _fmt_lat(r.get("e2e_s")),
                         _fmt_lat(r.get("ttft_s")),
                         _fmt_lat(r.get("tpot_s")), wf + tail))
    dropped = sum((out.get("dropped") or {}).values())
    sampled = sum((out.get("sampled_out") or {}).values())
    print(f"-- {out.get('total', 0)} matched "
          f"({out.get('truncated', 0)} truncated, {dropped} evicted, "
          f"{sampled} sampled out)")


def _print_steps(out: dict):
    """`rayt list steps` view: one line per step with its waterfall —
    data_wait > h2d > step > ckpt_block tiling the step wall."""
    from ray_tpu_torch.core.gcs_train_manager import TRAIN_STAGES

    fmt = "{:<10} {:<14} {:>4} {:>6} {:>9}  {}"
    print(fmt.format("run", "experiment", "rank", "step", "wall",
                     "waterfall"))
    for s in out.get("steps", ()):
        st = s.get("stages") or {}
        wf = " > ".join(f"{k[:-2]} {_fmt_lat(st[k])}"
                        for k in TRAIN_STAGES
                        if st.get(k) is not None)
        tail = ""
        if s.get("ckpt_commit_s") is not None:
            tail += f" | commit {_fmt_lat(s['ckpt_commit_s'])}"
        if s.get("loss") is not None:
            tail += f" loss={s['loss']:.4g}"
        print(fmt.format(s.get("run_id", "")[:10],
                         (s.get("experiment") or "")[:14],
                         s.get("rank", 0), s.get("step", 0),
                         _fmt_lat(s.get("wall_s")), wf + tail))
    dropped = sum((out.get("dropped") or {}).values())
    print(f"-- {out.get('total', 0)} matched "
          f"({out.get('truncated', 0)} truncated, {dropped} evicted)")


def cmd_list(args):
    from ray_tpu_torch import state_api

    _attach(args)
    kind = args.kind
    if kind == "tasks":
        out = state_api.list_tasks(
            job_id=args.job or None, state=args.state or None,
            name=args.task_name or None, limit=args.limit, detail=True)
        print(json.dumps(out, indent=2, default=str))
        return
    if kind == "objects":
        out = state_api.list_objects(
            job_id=args.job or None, node_id=args.node or None,
            callsite=args.callsite or None,
            leaked_only=bool(args.leaked), limit=args.limit, detail=True)
        print(json.dumps(out, indent=2, default=str))
        return
    if kind == "events":
        out = state_api.list_cluster_events(
            job_id=args.job or None, node_id=args.node or None,
            severity=args.severity or None,
            source=getattr(args, "source", None) or None,
            limit=args.limit, detail=True)
        print(json.dumps(out, indent=2, default=str))
        return
    if kind == "requests":
        out = state_api.list_serve_requests(
            app=args.app or None,
            outcome=getattr(args, "outcome", None) or None,
            model_id=getattr(args, "model_id", None) or None,
            errors_only=bool(getattr(args, "errors", False)),
            slow=bool(getattr(args, "slow", False)),
            limit=args.limit, detail=True)
        _print_requests(out)
        return
    if kind == "steps":
        out = state_api.list_train_steps(
            run_id=getattr(args, "run", None) or None,
            rank=(int(args.worker)
                  if getattr(args, "worker", None) is not None else None),
            slow=bool(getattr(args, "slow", False)),
            limit=args.limit, detail=True)
        _print_steps(out)
        return
    if kind == "dags":
        out = state_api.list_dags(
            job_id=args.job or None,
            stalled_only=bool(getattr(args, "stalled", False)),
            limit=args.limit, detail=True)
        # the list view drops per-edge sparkline history (rayt dag <id>
        # keeps it) so the JSON stays scannable
        for rec in out.get("dags", ()):
            for e in rec.get("edges", ()):
                e.pop("history", None)
        print(json.dumps(out, indent=2, default=str))
        return
    fn = {"nodes": state_api.list_nodes, "actors": state_api.list_actors,
          "jobs": state_api.list_jobs,
          "pgs": state_api.list_placement_groups,
          "workers": state_api.list_workers}[kind]
    print(json.dumps(fn(), indent=2, default=str))


def cmd_stack(args):
    """All-worker thread dump (ref analog: `ray stack`)."""
    from ray_tpu_torch import state_api

    _attach(args)
    for d in state_api.dump_stacks():
        who = d.get("actor_id") or d.get("worker_id", "")[:12]
        print(f"=== pid {d['pid']} ({who}) node={d['node_id'][:8]}")
        for t in d["threads"]:
            print(f"-- thread {t['thread']}")
            print(t["stack"].rstrip())


def cmd_profile(args):
    """On-demand profile of one live worker (ref analog: the dashboard's
    py-spy/memray attach): CPU samples -> collapsed stacks (flamegraph
    input with -o), memory -> top allocation sites."""
    from ray_tpu_torch import state_api
    from ray_tpu_torch._internal import profiler

    _attach(args)
    result = state_api.profile_worker(
        args.worker, mode=args.mode, duration_s=args.duration,
        interval_s=args.interval)
    if args.mode == "memory":
        print(f"net new bytes over {result['duration_s']}s: "
              f"{result['total_new_bytes']}")
        for a in result["top_allocations"]:
            print(f"{a['size_diff_bytes']:>12}  {a['location']}")
        return
    if args.output:
        with open(args.output, "w") as f:
            f.write(profiler.render_collapsed(result))
        print(f"collapsed stacks -> {args.output} "
              f"({result['num_samples']} samples)")
    print(profiler.render_top(result))


def cmd_memory(args):
    """Object report (ref analog: `ray memory`): live per-node totals
    plus the GCS object manager's per-callsite / per-node rollups and
    leak-watchdog flags. Column glossary: README "Object observability"."""
    from ray_tpu_torch import state_api

    _attach(args)
    if getattr(args, "job", None):
        _print_object_summary(state_api.summarize_objects(
            job_id=args.job))
        return
    s = state_api.memory_summary()
    print(f"{s['num_objects']} objects, {s['total_bytes'] / 1e6:.1f} MB "
          f"({s['spilled_objects']} spilled, {s['pinned_objects']} pinned)")
    for o in s["objects"][:50]:
        flags = ("S" if o["spilled"] else "-") + \
            ("P" if o["pinned"] else "-")
        print(f"  {o['object_id'][:16]}  {o['size']:>12}  {flags}  "
              f"node={o['node_id'][:8]}  {o.get('callsite') or ''}")
    if s.get("summary"):
        _print_object_summary(s["summary"])


def _print_object_summary(summary: dict):
    """`ray memory --group-by` style tables from summarize_objects."""
    t = summary.get("totals", {})
    dropped = sum(summary.get("dropped", {}).values())
    print(f"\ncluster object state: {t.get('objects', 0)} tracked, "
          f"{t.get('bytes', 0) / 1e6:.1f} MB "
          f"({t.get('pinned_bytes', 0) / 1e6:.1f} MB pinned, "
          f"{t.get('spilled_bytes', 0) / 1e6:.1f} MB spilled, "
          f"{t.get('leaked_objects', 0)} leaked"
          + (f", {dropped} evicted from the GCS store" if dropped else "")
          + ")")
    by_site = summary.get("by_callsite", {})
    if by_site:
        fmt = "{:<44} {:>6} {:>12} {:>12} {:>12} {:>7}"
        print(fmt.format("callsite", "count", "bytes", "pinned",
                         "spilled", "leaked"))
        for site, e in by_site.items():
            print(fmt.format(site[:44], e["count"], e["total_bytes"],
                             e["pinned_bytes"], e["spilled_bytes"],
                             e["leaked_count"]))
    by_node = summary.get("by_node", {})
    if by_node:
        print("\nper node:")
        for node, e in sorted(by_node.items()):
            store = e.get("store", {})
            extra = ""
            if store:
                extra = (f"  store {store.get('used_bytes', 0) / 1e6:.1f}"
                         f"/{store.get('capacity_bytes', 0) / 1e6:.0f} MB"
                         f"  zombies={store.get('zombie_segments', 0)}"
                         f" (swept {store.get('zombies_swept_total', 0)})")
                if store.get("fallback_bytes"):
                    extra += (f"  fallback="
                              f"{store['fallback_bytes'] / 1e6:.1f} MB")
            print(f"  {node[:12]}  {e['objects']} objects  "
                  f"{e['total_bytes'] / 1e6:.1f} MB  "
                  f"leaked={e['leaked_count']}{extra}")


def cmd_dag(args):
    """One DAG's edge table (ref analog: the reference's compiled-graph
    visualization, rendered as text): topology, per-edge throughput,
    ring occupancy, blocked time, and stall-watchdog attribution.
    Column glossary: README "Execution-plane observability"."""
    from ray_tpu_torch import state_api

    _attach(args)
    out = state_api.list_dags(dag_id=args.dag_id, limit=1, detail=True)
    dags = out.get("dags", [])
    if not dags:
        # allow a hex prefix, like other id-taking commands
        dags = [d for d in state_api.list_dags(limit=0)
                if d["dag_id"].startswith(args.dag_id)]
    if not dags:
        raise SystemExit(f"no dag record matches {args.dag_id!r}")
    _print_dag(dags[0])


def _print_dag(rec: dict):
    kinds = " ".join(f"{k}={v}" for k, v in
                     sorted(rec["channel_kinds"].items()) if v)
    print(f"dag {rec['dag_id']}  state={rec['state']}  "
          f"job={rec['job_id'][:12]}  edges={rec['num_edges']} ({kinds})"
          + (f"  stalled={len(rec['stalled_edges'])}"
             if rec["stalled_edges"] else ""))
    fmt = ("{:<4} {:<7} {:<30} {:<10} {:>8} {:>12} {:>6} {:>5} "
           "{:>9} {:>9}  {}")
    print(fmt.format("edge", "role", "producer->consumer", "kind",
                     "ticks", "bytes", "arrs", "occ", "w-block",
                     "r-block", "stall"))
    for e in rec["edges"]:
        pair = f"{e['producer']['label']}->{e['consumer']['label']}"
        s = e.get("stall")
        badge = "—"
        if s:
            badge = f"{s['blocked']}-blocked {s['blocked_s']:.1f}s"
            if s.get("dead_peer"):
                badge += f" peer {s['culprit']} DEAD"
        kind = e["kind"]
        if kind == "device" and e.get("transport"):
            # a device edge's bytes column IS its shard-bytes
            # throughput; name the transport it rides
            kind = f"device/{e['transport']}"
        arrs = (str(e.get("device_arrays", 0))
                if e["kind"] == "device" else "—")
        print(fmt.format(
            e["edge"], e["role"], pair[:30], kind,
            max(e["ticks"], e["reads"]), e["bytes"], arrs,
            e["occupancy"],
            f"{e['write_block_s']:.1f}s", f"{e['read_block_s']:.1f}s",
            badge))


def cmd_why_pending(args):
    """Explain what a pending task is waiting for: joins the GCS task
    record with the live resource view + lease decision traces —
    feasible-but-busy (which nodes fit, behind how deep a queue) vs
    infeasible cluster-wide (which resource is short)."""
    from ray_tpu_torch import state_api

    _attach(args)
    _print_why_pending(state_api.why_pending(args.task_id))


def _print_why_pending(out: dict):
    if not out.get("found"):
        print(out.get("explanation", "task not found"))
        return
    head = (f"task {out['task_id'][:16]} ({out['name']}) "
            f"state={out['state']} attempt={out['attempt']}")
    print(head)
    print(f"verdict: {out.get('verdict', '—')}")
    print(out.get("explanation", ""))
    q = out.get("quota")
    if q:
        print(f"quota: weight={q['weight']:g} floor={q['floor']:g} "
              f"share={q['share']:g} used={q['used']:g} "
              f"{q.get('resource', '')}")
    if out.get("pending"):
        nodes = out.get("nodes") or {}
        if nodes:
            fmt = "  {:<14} {:>9} {:>10} {:>8}  {}"
            print(fmt.format("node", "fits-now", "fits-ever", "pending",
                             "available (of demand)"))
            for nid, v in nodes.items():
                avail = " ".join(f"{k}={a:g}"
                                 for k, a in v["available"].items())
                print(fmt.format(nid[:14],
                                 "yes" if v["fits_now"] else "no",
                                 "yes" if v["fits_ever"] else "no",
                                 str(v.get("pending_leases", 0)),
                                 avail))
        trace = out.get("trace")
        if trace:
            print(f"shape {out.get('shape')}: "
                  f"{trace.get('granted', 0)} granted, "
                  f"{trace.get('queued', 0)} queued "
                  f"(max wait {trace.get('queue_wait_max_s', 0):.2f}s), "
                  f"{trace.get('spillback', 0)} spillbacks, "
                  f"{trace.get('infeasible', 0)} infeasible"
                  + (f"; last reason: {trace['last_reason']}"
                     if trace.get("last_reason") else ""))


def cmd_timeline(args):
    """Chrome-trace export of the GCS task lifecycle store (ref analog:
    `ray timeline`, scripts/scripts.py): nested per-phase slices,
    filtered server-side by job / time window / limit."""
    from ray_tpu_torch import state_api

    _attach(args)
    n = state_api.export_timeline(
        args.out, job_id=args.job or None, limit=args.limit or None,
        start_s=args.start or None, end_s=args.end or None)
    print(f"wrote {n} events to {args.out} "
          "(open in chrome://tracing or ui.perfetto.dev)")


def cmd_microbenchmark(args):
    import ray_tpu_torch as rt
    from ray_tpu_torch._internal.perf import run_microbenchmarks

    rt.init(num_cpus=args.num_cpus or None)
    try:
        rows = run_microbenchmarks(duration=args.duration,
                                   device=args.device)
        for row in rows:
            print(f"{row['benchmark']}: {row['rate_per_s']}")
    finally:
        rt.shutdown()
    if args.json_out:
        import platform

        doc = {"suite": "rayt microbenchmark",
               "host": {"cpus": os.cpu_count(),
                        "platform": platform.platform()},
               "results": rows}
        with open(args.json_out, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {args.json_out}")


def _dash_request(args, path, data=None):
    import urllib.request

    addr = _read_dashboard(args)
    req = urllib.request.Request(
        f"http://{addr}{path}",
        data=json.dumps(data).encode() if data is not None else None,
        headers={"Content-Type": "application/json"},
        method="POST" if data is not None else "GET")
    with urllib.request.urlopen(req, timeout=30) as r:
        body = r.read().decode()
    return body


def _serve_connect(args):
    import ray_tpu_torch as rt

    addr = _read_address(args)
    rt.init(address=addr)
    return rt


def cmd_serve_deploy(args):
    rt = _serve_connect(args)
    from ray_tpu_torch.serve.schema import deploy_config

    handles = deploy_config(args.config_file)
    print(json.dumps({"deployed": sorted(handles)}))


def cmd_serve_status(args):
    rt = _serve_connect(args)
    from ray_tpu_torch.serve import _controller

    ctl = _controller(create=False)
    apps = rt.get(ctl.list_applications.remote(), timeout=30)
    out = {}
    for app in apps:
        out[app] = rt.get(ctl.get_deployments.remote(app), timeout=30)
    print(json.dumps(out, indent=1))
    try:
        from ray_tpu_torch import state_api

        _print_serve_waterfall(state_api.summarize_serve_requests())
    except Exception:
        pass  # pre-observability GCS / no requests yet: plain status


def _print_serve_waterfall(summ: dict):
    """Per-app p50/p99/mean table over the waterfall stages (from the
    GCS serve manager's retained records)."""
    from ray_tpu_torch.core.gcs_serve_manager import (NESTED_STAGES,
                                                WATERFALL_STAGES)

    apps = summ.get("apps") or {}
    if not apps:
        return
    fmt = "  {:<20} {:>9} {:>9} {:>9} {:>6}"
    for app, e in apps.items():
        oc = " ".join(f"{k}={v}"
                      for k, v in sorted(e.get("outcomes", {}).items()))
        print(f"\napp {app!r}: {e.get('count', 0)} requests ({oc})")
        print(fmt.format("stage", "p50", "p99", "mean", "n"))
        stages = e.get("stages") or {}
        rows = [("e2e", e.get("e2e")), ("ttft", e.get("ttft")),
                ("tpot", e.get("tpot"))]
        rows += [(k, stages.get(k))
                 for k in WATERFALL_STAGES + NESTED_STAGES]
        for name, roll in rows:
            if not roll or not roll.get("n"):
                continue
            print(fmt.format(name, _fmt_lat(roll.get("p50")),
                             _fmt_lat(roll.get("p99")),
                             _fmt_lat(roll.get("mean")), roll["n"]))
    dropped = sum((summ.get("dropped") or {}).values())
    sampled = sum((summ.get("sampled_out") or {}).values())
    print(f"\n{summ.get('finalized_total', 0)} requests finalized, "
          f"{summ.get('total_requests', 0)} retained "
          f"({dropped} evicted, {sampled} sampled out)")


def cmd_train_status(args):
    """`rayt train status`: per-run waterfall table (p50/p99/mean per
    stage), compile/retrace counts, stalled workers with attribution,
    starved dp ranks, and device-memory totals — from the GCS train
    manager's retained step records."""
    _serve_connect(args)
    from ray_tpu_torch import state_api

    _print_train_waterfall(state_api.summarize_train_runs(
        run_id=getattr(args, "run", None) or None))


def _print_train_waterfall(summ: dict):
    from ray_tpu_torch.core.gcs_train_manager import TRAIN_STAGES

    runs = summ.get("runs") or {}
    if not runs:
        print("no train runs recorded")
        return
    fmt = "  {:<14} {:>9} {:>9} {:>9} {:>6}"
    for rid, e in runs.items():
        print(f"\nrun {rid[:12]} experiment={e.get('experiment')!r} "
              f"state={e.get('state')} workers={e.get('world_size')} "
              f"steps={e.get('steps')} (last step {e.get('last_step')})")
        print(fmt.format("stage", "p50", "p99", "mean", "n"))
        rows = [("wall", e.get("wall"))]
        stages = e.get("stages") or {}
        rows += [(k[:-2], stages.get(k)) for k in TRAIN_STAGES]
        for name, roll in rows:
            if not roll or not roll.get("n"):
                continue
            print(fmt.format(name, _fmt_lat(roll.get("p50")),
                             _fmt_lat(roll.get("p99")),
                             _fmt_lat(roll.get("mean")), roll["n"]))
        print(f"  compiles={e.get('compile_count', 0)} "
              f"retraces={e.get('retrace_count', 0)} "
              f"mem_used={e.get('memory_used_bytes', 0) / 1e6:.1f}MB "
              f"mem_peak={e.get('memory_peak_bytes', 0) / 1e6:.1f}MB")
        for rank, stall in sorted(
                (e.get("stalled_workers") or {}).items()):
            print(f"  STALLED rank {rank}: {stall.get('attribution')} "
                  f"(step {stall.get('step')} blocked "
                  f"{stall.get('blocked_s', 0):.1f}s in "
                  f"{stall.get('phase')})")
        for rank, sv in sorted((e.get("starved_workers") or {}).items()):
            print(f"  STARVED rank {rank}: ingest wait "
                  f"{sv.get('share', 0) * 100:.0f}% of wall "
                  f"({sv.get('data_wait_s', 0):.2f}s / "
                  f"{sv.get('wall_s', 0):.2f}s)")
    dropped = sum((summ.get("dropped") or {}).values())
    print(f"\n{summ.get('steps_total', 0)} steps recorded, "
          f"{summ.get('total_steps', 0)} retained ({dropped} evicted, "
          f"{summ.get('stalled', 0)} workers stalled)")


def cmd_serve_shutdown(args):
    _serve_connect(args)
    from ray_tpu_torch import serve

    # full teardown: apps deleted, proxies unregistered, detached
    # controller killed (serve/__init__.py shutdown)
    serve.shutdown()
    print(json.dumps({"shutdown": True}))


def cmd_client_server(args):
    from ray_tpu_torch.client.server import main as client_main

    client_main(args.address, port=args.port)


def cmd_job_submit(args):
    import shlex

    parts = list(args.entrypoint)
    if parts and parts[0] == "--":  # strip only the leading separator
        parts = parts[1:]
    entry = " ".join(shlex.quote(p) for p in parts)
    if not entry:
        raise SystemExit("usage: ray_tpu_torch job submit -- <entrypoint...>")
    payload = {"entrypoint": entry}
    if args.submission_id:
        payload["submission_id"] = args.submission_id
    if args.runtime_env_json:
        payload["runtime_env"] = json.loads(args.runtime_env_json)
    if args.working_dir:
        payload.setdefault("runtime_env", {})["working_dir"] = \
            args.working_dir
    print(_dash_request(args, "/api/jobs", payload))


def cmd_job_status(args):
    print(_dash_request(args, f"/api/jobs/{args.submission_id}"))


def cmd_job_logs(args):
    if not getattr(args, "follow", False):
        print(_dash_request(args, f"/api/jobs/{args.submission_id}/logs"))
        return
    import sys
    import time as _time

    offset = 0
    while True:  # poll the incremental tail endpoint until the job exits
        body = json.loads(_dash_request(
            args, f"/api/jobs/{args.submission_id}/logs?offset={offset}"))
        if body.get("data"):
            sys.stdout.write(body["data"])
            sys.stdout.flush()
        offset = body.get("offset", offset)
        if not body.get("running"):
            return
        _time.sleep(0.5)


def cmd_job_stop(args):
    print(_dash_request(args, f"/api/jobs/{args.submission_id}/stop"))


def cmd_job_list(args):
    print(_dash_request(args, "/api/jobs"))


def cmd_up(args):
    from ray_tpu_torch.scripts import launcher

    launcher.up(args.config_file)


def cmd_down(args):
    from ray_tpu_torch.scripts import launcher

    launcher.down(args.cluster_name)


def cmd_exec(args):
    from ray_tpu_torch.scripts import launcher

    command = args.command[1:] if args.command[:1] == ["--"] \
        else args.command
    sys.exit(launcher.exec_cmd(args.cluster_name, command))


def cmd_attach(args):
    from ray_tpu_torch.scripts import launcher

    sys.exit(launcher.attach(args.cluster_name))


def main(argv=None):
    p = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("start", help="start a head node")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--port", type=int, default=0)
    sp.add_argument("--num-cpus", type=int)
    sp.add_argument("--num-gpus", type=int,
                    help="GPUs to advertise (default: autodetect)")
    sp.add_argument("--dashboard-port", type=int, default=0)
    sp.set_defaults(fn=cmd_start)

    jp = sub.add_parser("job", help="submit / inspect driver jobs")
    jsub = jp.add_subparsers(dest="job_command", required=True)
    for name, fn in (("submit", cmd_job_submit), ("status", cmd_job_status),
                     ("logs", cmd_job_logs), ("stop", cmd_job_stop),
                     ("list", cmd_job_list)):
        jsp = jsub.add_parser(name)
        jsp.add_argument("--dashboard-address")
        if name == "submit":
            jsp.add_argument("entrypoint", nargs=argparse.REMAINDER)
            jsp.add_argument("--submission-id")
            jsp.add_argument("--runtime-env-json",
                             help='e.g. \'{"pip": ["six"]}\'')
            jsp.add_argument("--working-dir")
        elif name != "list":
            jsp.add_argument("submission_id")
            if name == "logs":
                jsp.add_argument("--follow", action="store_true")
        jsp.set_defaults(fn=fn)

    up = sub.add_parser("up", help="launch a cluster from a JSON or YAML "
                        "config")
    up.add_argument("config_file")
    up.set_defaults(fn=cmd_up)

    dn = sub.add_parser("down", help="tear a launched cluster down")
    dn.add_argument("cluster_name", nargs="?", default="default")
    dn.set_defaults(fn=cmd_down)

    ex = sub.add_parser("exec", help="run a command against a cluster")
    ex.add_argument("cluster_name")
    ex.add_argument("command", nargs=argparse.REMAINDER)
    ex.set_defaults(fn=cmd_exec)

    at = sub.add_parser("attach", help="shell with RAYT_ADDRESS exported")
    at.add_argument("cluster_name", nargs="?", default="default")
    at.set_defaults(fn=cmd_attach)

    svp = sub.add_parser("serve", help="deploy/inspect serve apps")
    svsub = svp.add_subparsers(dest="serve_command", required=True)
    for name, fn in (("deploy", cmd_serve_deploy),
                     ("status", cmd_serve_status),
                     ("shutdown", cmd_serve_shutdown)):
        ssp = svsub.add_parser(name)
        ssp.add_argument("--address", help="GCS host:port")
        if name == "deploy":
            ssp.add_argument("config_file")
        ssp.set_defaults(fn=fn)

    tp = sub.add_parser("train", help="inspect training runs")
    tsub = tp.add_subparsers(dest="train_command", required=True)
    tsp = tsub.add_parser("status")
    tsp.add_argument("--address", help="GCS host:port")
    tsp.add_argument("--run", help="filter to one run id (hex prefix)")
    tsp.set_defaults(fn=cmd_train_status)

    sp = sub.add_parser("client-server",
                        help="remote-driver proxy (ray-client analog)")
    sp.add_argument("--address", required=True, help="GCS host:port")
    sp.add_argument("--port", type=int, default=10001)
    sp.set_defaults(fn=cmd_client_server)

    sp = sub.add_parser("stop", help="stop the head node")
    sp.set_defaults(fn=cmd_stop)

    sp = sub.add_parser("status")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser(
        "drain",
        help="gracefully drain a node: stop new placement, migrate "
             "actors/replicas/bundles/objects, then DRAINED")
    sp.add_argument("node", help="node id (hex, prefix ok)")
    sp.add_argument("--deadline", type=float, default=None,
                    help="drain deadline in seconds "
                         "(default: RAYT_DRAIN_DEADLINE_S)")
    sp.add_argument("--reason", default="")
    sp.add_argument("--wait", action="store_true",
                    help="block until the drain leaves DRAINING")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_drain)

    sp = sub.add_parser("summary",
                        help="cluster rollup, or `summary tasks` for "
                             "per-task-name states + latency split")
    sp.add_argument("kind", nargs="?", choices=["tasks"])
    sp.add_argument("--job", help="filter task summary by job id (hex)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_summary)

    sp = sub.add_parser("list", help="list cluster state")
    sp.add_argument("kind", choices=["nodes", "actors", "jobs", "pgs",
                                     "workers", "tasks", "objects",
                                     "dags", "events", "requests",
                                     "steps"])
    sp.add_argument("--app", help="requests: filter by serve app")
    sp.add_argument("--outcome",
                    help="requests: filter by outcome (ok/error/shed/"
                         "timeout/queue_full/no_replicas/"
                         "stream_aborted)")
    sp.add_argument("--model-id", dest="model_id",
                    help="requests: filter by multiplexed model id")
    sp.add_argument("--errors", action="store_true",
                    help="requests: only non-ok outcomes")
    sp.add_argument("--slow", action="store_true",
                    help="requests/steps: order by latency descending")
    sp.add_argument("--run", help="steps: filter by train run id "
                                  "(hex prefix)")
    sp.add_argument("--worker", help="steps: filter by dp rank")
    sp.add_argument("--job", help="tasks/objects/dags/events: filter "
                                  "by job id (hex)")
    sp.add_argument("--state", help="tasks: filter by lifecycle state")
    sp.add_argument("--task-name", help="tasks: filter by task name")
    sp.add_argument("--node", help="objects/events: filter by node id "
                                   "(hex; prefix ok for events)")
    sp.add_argument("--callsite", help="objects: filter by creation "
                                       "callsite (exact)")
    sp.add_argument("--leaked", action="store_true",
                    help="objects: only leak-watchdog-flagged records")
    sp.add_argument("--stalled", action="store_true",
                    help="dags: only DAGs with stall-flagged edges")
    sp.add_argument("--severity",
                    help="events: minimum severity (DEBUG/INFO/"
                         "WARNING/ERROR)")
    sp.add_argument("--source",
                    help="events: filter by emitting plane (gcs/"
                         "node_manager/autoscaler/serve/dag)")
    sp.add_argument("--limit", type=int, default=100)
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser(
        "why-pending",
        help="explain what a pending task waits for: feasible-but-busy "
             "(which nodes, queue depth) vs infeasible (short resource)")
    sp.add_argument("task_id", help="task id (hex, prefix ok)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_why_pending)

    sp = sub.add_parser("dag",
                        help="one compiled DAG's edge table: topology, "
                             "throughput, occupancy, stall attribution")
    sp.add_argument("dag_id", help="dag id (hex, prefix ok)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_dag)

    sp = sub.add_parser("microbenchmark", help="core perf suite")
    sp.add_argument("--duration", type=float, default=2.0)
    sp.add_argument("--num-cpus", type=int)
    sp.add_argument("--device",
                    help="where the device legs' tensors live (default: "
                         "the CUDA card; `cpu` on a host without one)")
    sp.add_argument("--json-out", metavar="PATH",
                    help="also write results as JSON (MICROBENCH.json "
                         "format)")
    sp.set_defaults(fn=cmd_microbenchmark)

    sp = sub.add_parser("stack", help="stack traces of all workers")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_stack)

    sp = sub.add_parser("profile",
                        help="sample one worker's CPU or memory live")
    sp.add_argument("worker", help="worker or actor id (hex prefix)")
    sp.add_argument("--mode", choices=("cpu", "memory"), default="cpu")
    sp.add_argument("--duration", type=float, default=5.0)
    sp.add_argument("--interval", type=float, default=0.01)
    sp.add_argument("-o", "--output",
                    help="write collapsed stacks for flamegraph.pl")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_profile)

    sp = sub.add_parser("memory",
                        help="object store contents + per-callsite / "
                             "per-node rollups and leak flags")
    sp.add_argument("--job", help="summarize one job's objects only")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_memory)

    sp = sub.add_parser("timeline",
                        help="export task-lifecycle Chrome trace")
    sp.add_argument("--out", default="timeline.json")
    sp.add_argument("--job", help="filter by job id (hex)")
    sp.add_argument("--limit", type=int, default=0)
    sp.add_argument("--start", type=float,
                    help="window start (unix seconds)")
    sp.add_argument("--end", type=float, help="window end (unix seconds)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_timeline)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
