"""Dashboard head service: runs inside the head process next to the GCS
(ref analogs: dashboard/head.py:65 aiohttp head, modules/job/
job_manager.py:59 + job_supervisor.py subprocess-driver jobs,
_private/metrics_agent.py:483 Prometheus text export).

Endpoints:
  GET  /metrics                 — Prometheus text (cluster-consolidated
                                  from the GCS time-series store, full
                                  histogram buckets included)
  GET  /api/cluster_status      — GCS cluster summary
  GET  /api/nodes | /api/actors | /api/jobs | /api/serve
  GET  /api/serve/requests      — ?app=&outcome=&model_id=&errors=&slow=
                                  &limit= per-request latency waterfalls
                                  (GCS serve manager) + per-app stage
                                  p50/p99 rollup
  GET  /api/metrics/names       — metric directory (name/kind/tag keys)
  GET  /api/metrics/query       — ?name=&window=&step=&agg=&merge=&tag.K=V
                                  aligned time series from the store
  GET  /api/tasks               — ?job=&state=&task_name=&limit= filtered
                                  task lifecycle records (GCS task manager)
  GET  /api/tasks/summary       — ?job= per-task-name state counts +
                                  sched-vs-exec latency split
  GET  /api/objects             — ?job=&node=&callsite=&leaked=&limit=
                                  coalesced object records (GCS object
                                  manager: size/callsite/refs/pins/leaks)
  GET  /api/objects/summary     — ?job= per-callsite + per-node memory
                                  rollups with store stats + leak flags
  GET  /api/dags                — ?job=&stalled=&limit= compiled-DAG
                                  records (GCS dag manager: edge
                                  topology, per-edge tick/byte/occupancy
                                  rollups + history, stall attribution)
                                  with a summary rollup attached
  GET  /api/events              — ?job=&node=&severity=&source=&limit=
                                  cluster event log (GCS event manager:
                                  node/worker/actor lifecycle, OOM
                                  reaps, autoscaler decisions, DAG
                                  stalls, serve shed episodes)
  GET  /api/cluster             — enriched cluster status: node table
                                  (resources, pending leases, heartbeat
                                  age), pending lease demand by shape,
                                  scheduling decision rollup, recent
                                  WARNING+ events (the Cluster tab feed)
  GET  /api/timeline            — Chrome trace JSON of the GCS task
                                  lifecycle store: nested per-phase slices
                                  (load in Perfetto / chrome://tracing)
  POST /api/jobs                — {"entrypoint": "...", "env": {...}}
  GET  /api/jobs/{id}           — submission status
  GET  /api/jobs/{id}/logs      — captured stdout+stderr (?offset= tails)
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import tempfile
import time
import uuid
from typing import Any, Optional


class JobManager:
    """Driver-script jobs: the entrypoint runs as a subprocess with
    RAYT_ADDRESS pointing at this cluster; stdout/stderr captured to a
    per-job log file (ref: job_manager.py:59 + JobSupervisor). The logs
    live under this process's temp dir, beside the CLI's head state, so
    two heads on one machine never share a job's log file."""

    def __init__(self, gcs_address: str, log_dir: Optional[str] = None):
        self.gcs_address = gcs_address
        log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                          "ray_tpu_torch", "jobs")
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.jobs: dict[str, dict] = {}

    def submit(self, entrypoint: str, env: Optional[dict] = None,
               submission_id: Optional[str] = None,
               runtime_env: Optional[dict] = None) -> str:
        sub_id = submission_id or f"raytjob-{uuid.uuid4().hex[:8]}"
        if sub_id in self.jobs:
            raise ValueError(f"submission id {sub_id!r} already exists")
        log_path = os.path.join(self.log_dir, f"{sub_id}.log")
        job_env = dict(os.environ)
        job_env.update(env or {})
        job_env["RAYT_ADDRESS"] = self.gcs_address
        cwd = None
        runtime_env = dict(runtime_env) if runtime_env else None
        container = (runtime_env or {}).pop("container", None)
        if container and runtime_env:
            # host-path-dependent keys can't cross the container
            # boundary; failing loudly beats a silently wrong env
            bad = {"pip", "py_modules"} & set(runtime_env)
            if bad:
                raise ValueError(
                    f"runtime_env keys {sorted(bad)} cannot combine with "
                    "'container' (they splice HOST paths; bake them into "
                    "the image instead)")
        if runtime_env:
            cwd = self._apply_runtime_env(runtime_env, job_env)
        if container:
            entrypoint = self._containerize(
                entrypoint, container, cwd,
                env_vars=(runtime_env or {}).get("env_vars"))
        log_f = open(log_path, "wb")
        proc = subprocess.Popen(
            entrypoint, shell=True, stdout=log_f, stderr=subprocess.STDOUT,
            env=job_env, cwd=cwd)
        self.jobs[sub_id] = {
            "proc": proc, "log_path": log_path, "entrypoint": entrypoint,
            "start_time": time.time(), "log_file": log_f,
            "runtime_env": {k: v for k, v in (runtime_env or {}).items()
                            if k != "env_vars"},
        }
        return sub_id

    @staticmethod
    def _apply_runtime_env(renv: dict, job_env: dict) -> Optional[str]:
        """Materialize the job driver's runtime env (the same machinery
        tasks/actors use — ref: job submissions route through the
        runtime-env agent in job_manager.py:59): pip installs into the
        content-addressed venv cache and rides PATH/PYTHONPATH;
        working_dir becomes the driver cwd; py_modules join PYTHONPATH.
        NOTE: pip installation blocks — callers on an event loop must run
        submit() in an executor."""
        from ray_tpu_torch._internal import runtime_env as renv_mod

        renv_mod.validate(renv)
        job_env.update(renv.get("env_vars") or {})
        py_paths: list[str] = []
        cwd = None
        wd = renv.get("working_dir")
        if wd:
            cwd = os.path.abspath(wd)
            if not os.path.isdir(cwd):
                raise ValueError(f"working_dir {wd!r} does not exist")
            py_paths.append(cwd)
        for m in renv.get("py_modules") or []:
            p = os.path.abspath(m)
            # the IMPORT ROOT: a package dir's parent, a .py file's dir
            py_paths.append(os.path.dirname(p))
        pip = renv.get("pip")
        if pip:
            spec = renv_mod.package({"pip": pip},
                                    kv_put=lambda *a: None)["pip"]
            venv_dir = renv_mod.ensure_pip_venv(spec)
            renv_mod.mark_pip_venv_in_use(venv_dir)
            job_env["VIRTUAL_ENV"] = venv_dir
            job_env["PATH"] = (os.path.join(venv_dir, "bin") + os.pathsep
                               + job_env.get("PATH", ""))
            py_paths.append(renv_mod._venv_site_packages(venv_dir))
        if py_paths:
            existing = job_env.get("PYTHONPATH", "")
            job_env["PYTHONPATH"] = os.pathsep.join(
                py_paths + ([existing] if existing else []))
        return cwd

    @staticmethod
    def _containerize(entrypoint: str, container: dict,
                      cwd: Optional[str],
                      env_vars: Optional[dict] = None) -> str:
        """Wrap the driver entrypoint in a container run (ref analog:
        _private/runtime_env/image_uri.py — job-level isolation; the
        host-network flag keeps the driver able to dial the GCS).
        Requires podman or docker (override: RAYT_CONTAINER_RUNTIME)."""
        import shlex
        import shutil

        if not isinstance(container, dict) or not container.get("image"):
            raise ValueError(
                "runtime_env['container'] must be a dict with an 'image'")
        runtime = os.environ.get("RAYT_CONTAINER_RUNTIME") or \
            shutil.which("podman") or shutil.which("docker")
        if not runtime:
            raise RuntimeError(
                "runtime_env['container'] requires podman or docker on "
                "the head node (or RAYT_CONTAINER_RUNTIME); none found")
        cmd = [runtime, "run", "--rm", "--network=host",
               "--env", "RAYT_ADDRESS"]
        for k, v in (env_vars or {}).items():
            cmd += ["--env", f"{k}={v}"]
        if cwd:
            cmd += ["-v", f"{cwd}:/workdir", "-w", "/workdir"]
        cmd += list(container.get("run_options") or [])
        cmd += [container["image"], "sh", "-c", entrypoint]
        return " ".join(shlex.quote(c) for c in cmd)

    def status(self, sub_id: str) -> Optional[dict]:
        job = self.jobs.get(sub_id)
        if job is None:
            return None
        rc = job["proc"].poll()
        if rc is None:
            status = "RUNNING"
        elif rc == 0:
            status = "SUCCEEDED"
        else:
            status = "FAILED"
        return {"submission_id": sub_id, "status": status,
                "entrypoint": job["entrypoint"], "returncode": rc,
                "start_time": job["start_time"]}

    def logs(self, sub_id: str) -> Optional[str]:
        job = self.jobs.get(sub_id)
        if job is None:
            return None
        try:
            with open(job["log_path"], "rb") as f:
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    def tail_logs(self, sub_id: str, offset: int = 0) -> Optional[dict]:
        """Incremental log read for follow-mode streaming (ref: the job
        log tailing the state API exposes): returns the bytes after
        `offset` plus the next offset and whether the job still runs."""
        job = self.jobs.get(sub_id)
        if job is None:
            return None
        # poll BEFORE reading: a job that flushes its last lines and
        # exits between a read-then-poll would report running=False with
        # the final bytes unread, ending a --follow loop early
        running = job["proc"].poll() is None
        data = b""
        try:
            with open(job["log_path"], "rb") as f:
                f.seek(offset)
                data = f.read()
        except OSError:
            pass
        return {"data": data.decode(errors="replace"),
                "offset": offset + len(data),
                "running": running}

    def stop_job(self, sub_id: str) -> bool:
        job = self.jobs.get(sub_id)
        if job is None or job["proc"].poll() is not None:
            return False
        job["proc"].terminate()
        return True

    def list(self) -> list[dict]:
        return [self.status(s) for s in self.jobs]

    def shutdown(self):
        for job in self.jobs.values():
            if job["proc"].poll() is None:
                try:
                    job["proc"].terminate()
                except Exception:
                    pass
            try:
                job["log_file"].close()
            except Exception:
                pass


def _prom_escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"')


def prometheus_text(snapshot: list[dict]) -> str:
    """Render the GCS time-series store snapshot in Prometheus
    exposition format — cluster-consolidated (every process's records
    aggregated by the store), histograms with full cumulative buckets
    (ref: _private/metrics_agent.py:483 text export)."""
    lines: list[str] = []
    seen_types: set[str] = set()
    for m in snapshot:
        name = m["name"].replace(".", "_").replace("-", "_")
        kind = {"counter": "counter", "gauge": "gauge",
                "histogram": "histogram"}.get(m["kind"], "untyped")
        if name not in seen_types:
            seen_types.add(name)
            lines.append(f"# TYPE {name} {kind}")
        tag_items = sorted(m.get("tags", {}).items())
        tags = ",".join(f'{k}="{_prom_escape(str(v))}"'
                        for k, v in tag_items)
        label = f"{{{tags}}}" if tags else ""
        if m["kind"] == "histogram":
            for le, cum in m.get("buckets", []):
                bt = ",".join([tags, f'le="{le}"'] if tags
                              else [f'le="{le}"'])
                lines.append(f"{name}_bucket{{{bt}}} {cum}")
            lines.append(f"{name}_count{label} {m['count']}")
            lines.append(f"{name}_sum{label} {m['sum']}")
        else:
            lines.append(f"{name}{label} {m['value']}")
    return "\n".join(lines) + "\n"


class DashboardHead:
    """aiohttp app colocated with the GCS (same process, direct table
    access — the single-head analog of the reference's head + agents)."""

    def __init__(self, gcs_server, gcs_address: str):
        self.gcs = gcs_server
        self.job_manager = JobManager(gcs_address)
        self._runner = None
        self.port: Optional[int] = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        from aiohttp import web

        app = web.Application()
        app.router.add_get("/", self._index)
        app.router.add_get("/metrics", self._metrics)
        app.router.add_get("/api/cluster_status", self._cluster_status)
        app.router.add_get("/api/nodes", self._nodes)
        app.router.add_get("/api/actors", self._actors)
        app.router.add_get("/api/serve", self._serve)
        app.router.add_get("/api/serve/requests", self._serve_requests)
        app.router.add_get("/api/train", self._train_state)
        app.router.add_get("/api/data", self._data)
        app.router.add_get("/api/metrics/names", self._metrics_names)
        app.router.add_get("/api/metrics/query", self._metrics_query)
        app.router.add_get("/api/tasks", self._tasks)
        app.router.add_get("/api/tasks/summary", self._tasks_summary)
        app.router.add_get("/api/objects", self._objects)
        app.router.add_get("/api/objects/summary", self._objects_summary)
        app.router.add_get("/api/dags", self._dags)
        app.router.add_get("/api/events", self._events)
        app.router.add_get("/api/cluster", self._cluster)
        app.router.add_get("/api/timeline", self._timeline)
        app.router.add_get("/api/jobs", self._jobs_list)
        app.router.add_post("/api/jobs", self._jobs_submit)
        app.router.add_get("/api/jobs/{sub_id}", self._job_status)
        app.router.add_get("/api/jobs/{sub_id}/logs", self._job_logs)
        app.router.add_get("/api/jobs/{sub_id}/stop", self._job_stop)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, host, port)
        await site.start()
        for s in site._server.sockets:
            self.port = s.getsockname()[1]
            break
        return self.port

    async def stop(self):
        self.job_manager.shutdown()
        if self._runner is not None:
            await self._runner.cleanup()

    # ---------------------------------------------------------- handlers
    async def _index(self, request):
        """The operator page: one static HTML file (no build step)
        rendering nodes/actors/jobs from the JSON endpoints (ref analog:
        the reference's React dashboard client, scoped to overview)."""
        from aiohttp import web

        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "static", "index.html")
        return web.FileResponse(path)  # async file serve, no loop stall

    async def _metrics(self, request):
        from aiohttp import web

        snapshot = self.gcs.rpc_metrics_snapshot(None)
        return web.Response(text=prometheus_text(snapshot),
                            content_type="text/plain")

    async def _cluster_status(self, request):
        from aiohttp import web

        return web.json_response(
            json.loads(json.dumps(self.gcs.rpc_cluster_status(None),
                                  default=str)))

    async def _nodes(self, request):
        from aiohttp import web

        def state_of(nid, info):
            if not info.alive:
                return "DEAD"
            rec = self.gcs.draining.get(nid)
            if rec is not None and rec.get("state") in ("DRAINING",
                                                        "DRAINED"):
                return rec["state"]
            return "ALIVE"

        nodes = [
            {"node_id": nid.hex(), "alive": info.alive,
             "state": state_of(nid, info),
             "address": f"{info.address.host}:{info.address.port}",
             "resources_total": info.resources_total,
             "resources_available": self.gcs.node_resources_available.get(
                 nid, {}),
             "labels": info.labels}
            for nid, info in self.gcs.nodes.items()
        ]
        return web.json_response(nodes)

    async def _actors(self, request):
        from aiohttp import web

        actors = [
            {"actor_id": aid.hex(), "state": info.state,
             "name": info.name, "class_name": info.class_name,
             "num_restarts": info.num_restarts}
            for aid, info in self.gcs.actors.items()
        ]
        return web.json_response(actors)

    async def _serve(self, request):
        """Serve overview derived from the metrics pipeline + actor
        table: per-deployment QPS / latency percentiles from the
        time-series store, replica-actor liveness from the GCS (no actor
        RPC needed — the head stays a pure reader)."""
        from aiohttp import web

        store = self.gcs.metrics_store

        def last_value(points):
            """Prefer the last COMPLETE step: the final point covers the
            partially-elapsed current minute, so its rate undercounts by
            the un-elapsed fraction (sawtooth at minute boundaries)."""
            full = [v for _, v in points[:-1] if v is not None]
            if full:
                return full[-1]
            return next((v for _, v in reversed(points)
                         if v is not None), None)

        deployments: dict[tuple, dict] = {}
        qps = store.query("rayt_serve_requests_total", window_s=120.0,
                          step_s=60.0)
        for s in qps["series"]:
            t = s["tags"]
            key = (t.get("app", ""), t.get("deployment", ""))
            deployments.setdefault(key, {})["qps"] = \
                last_value(s["points"]) or 0.0
        for agg in ("p50", "p99"):
            lat = store.query("rayt_serve_request_latency_s",
                              window_s=120.0, step_s=60.0, agg=agg)
            for s in lat["series"]:
                t = s["tags"]
                key = (t.get("app", ""), t.get("deployment", ""))
                deployments.setdefault(key, {})[f"latency_{agg}_s"] = \
                    last_value(s["points"])
        totals = {tuple(sorted(m["tags"].items())): m["value"]
                  for m in store.snapshot()
                  if m["name"] == "rayt_serve_requests_total"}
        for key, entry in deployments.items():
            app, dep = key
            entry["requests_total"] = totals.get(
                tuple(sorted({"app": app,
                              "deployment": dep}.items())), 0.0)
        replicas_alive = sum(
            1 for info in self.gcs.actors.values()
            if info.class_name == "ReplicaActor" and info.state == "ALIVE")
        return web.json_response({
            "deployments": [
                {"app": app, "deployment": dep, **entry}
                for (app, dep), entry in sorted(deployments.items())],
            "replicas_alive": replicas_alive,
        })

    async def _serve_requests(self, request):
        """Per-request latency waterfalls + per-app stage rollup (GCS
        serve manager; the Serve tab's waterfall feed and the
        `rayt list requests` twin). Query params mirror the CLI:
        ?app=&outcome=&model_id=&errors=1&slow=1&limit=."""
        from aiohttp import web

        q = request.query
        try:
            out = self.gcs.serve_manager.list(
                app=q.get("app") or None,
                outcome=q.get("outcome") or None,
                model_id=q.get("model_id") or None,
                errors_only=q.get("errors", "") in ("1", "true", "yes"),
                slow=q.get("slow", "") in ("1", "true", "yes"),
                limit=int(q.get("limit", 50)))
        except (ValueError, TypeError) as e:
            return web.json_response({"error": str(e)}, status=400)
        out["summary"] = self.gcs.serve_manager.summarize(
            app=q.get("app") or None)
        return web.json_response(out)

    async def _train_state(self, request):
        """Train-plane state (GCS train manager; the Train tab's feed
        and the `rayt train status` twin): filtered run records with
        per-worker step histories, plus recent step waterfalls and the
        per-run summary rollup. Query params mirror the CLI:
        ?experiment=&state=&run=&worker=&slow=1&limit=."""
        from aiohttp import web

        q = request.query
        try:
            out = self.gcs.train_manager.list_runs(
                experiment=q.get("experiment") or None,
                state=q.get("state") or None,
                limit=int(q.get("limit", 20)))
            out["steps"] = self.gcs.train_manager.list_steps(
                run_id=q.get("run") or None,
                rank=(int(q["worker"]) if q.get("worker") else None),
                slow=q.get("slow", "") in ("1", "true", "yes"),
                limit=int(q.get("steps_limit", 50)))["steps"]
        except (ValueError, TypeError) as e:
            return web.json_response({"error": str(e)}, status=400)
        out["summary"] = self.gcs.train_manager.summarize(
            run_id=q.get("run") or None)
        return web.json_response(out)

    async def _data(self, request):
        """Data-plane overview from the metrics pipeline: per-op exchange
        totals (bytes / partitions / reduce-wait from the
        rayt_data_exchange_* counters) plus ingest delivery throughput —
        the head stays a pure reader of the time-series store."""
        from aiohttp import web

        store = self.gcs.metrics_store
        fields = {"rayt_data_exchange_bytes_total": "bytes_total",
                  "rayt_data_exchange_partitions_total": "partitions_total",
                  "rayt_data_exchange_reduce_wait_s": "reduce_wait_s"}
        exchanges: dict[str, dict] = {}
        ingest = {}
        for m in store.snapshot():  # one walk serves both tables
            field = fields.get(m["name"])
            if field is not None:
                op = m["tags"].get("op", "")
                exchanges.setdefault(op, {})[field] = m["value"]
            elif m["name"] == "rayt_ingest_tokens_per_s":
                ingest[m["tags"].get("rank", "")] = m["value"]
        # recent exchange bandwidth: counter->rate over the last window
        rates = store.query("rayt_data_exchange_bytes_total",
                            window_s=300.0, step_s=60.0)
        for s in rates["series"]:
            op = s["tags"].get("op", "")
            pts = [v for _, v in s["points"] if v is not None]
            if op in exchanges and pts:
                exchanges[op]["bytes_per_s"] = pts[-1]
        return web.json_response({
            "exchanges": [{"op": op, **vals}
                          for op, vals in sorted(exchanges.items())],
            "ingest_tokens_per_s": ingest,
        })

    async def _metrics_names(self, request):
        from aiohttp import web

        return web.json_response(self.gcs.metrics_store.names())

    async def _metrics_query(self, request):
        from aiohttp import web

        q = request.query
        name = q.get("name")
        if not name:
            return web.json_response({"error": "name required"},
                                     status=400)
        tags = {k[4:]: v for k, v in q.items() if k.startswith("tag.")}
        try:
            out = self.gcs.metrics_store.query(
                name,
                window_s=float(q.get("window", 300.0)),
                step_s=float(q["step"]) if "step" in q else None,
                agg=q.get("agg") or None,
                merge=q.get("merge", "") in ("1", "true", "yes"),
                tags=tags or None)
        except (ValueError, KeyError) as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response(out)

    async def _tasks(self, request):
        """Filtered task lifecycle records (GCS task manager; ref:
        `ray list tasks` state API endpoint)."""
        from aiohttp import web

        q = request.query
        try:
            out = self.gcs.task_manager.list(
                job_id=q.get("job") or None,
                state=q.get("state") or None,
                name=q.get("task_name") or None,
                actor_id=q.get("actor") or None,
                limit=int(q.get("limit", 100)))
        except (ValueError, TypeError) as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response(out)

    async def _tasks_summary(self, request):
        from aiohttp import web

        out = self.gcs.task_manager.summarize(
            job_id=request.query.get("job") or None)
        return web.json_response(out)

    async def _objects(self, request):
        """Filtered object-plane records (GCS object manager; ref:
        `ray memory` / the Objects tab feed)."""
        from aiohttp import web

        q = request.query
        try:
            out = self.gcs.object_manager.list(
                job_id=q.get("job") or None,
                node_id=q.get("node") or None,
                callsite=q.get("callsite") or None,
                leaked_only=q.get("leaked", "") in ("1", "true", "yes"),
                limit=int(q.get("limit", 100)))
        except (ValueError, TypeError) as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response(out)

    async def _objects_summary(self, request):
        from aiohttp import web

        out = self.gcs.object_manager.summarize(
            job_id=request.query.get("job") or None)
        return web.json_response(out)

    async def _dags(self, request):
        """Compiled-DAG records + rollup (GCS dag manager; the DAGs tab
        feed: edge tables, occupancy/throughput sparklines from each
        edge's history ring, stall badges)."""
        from aiohttp import web

        q = request.query
        try:
            out = self.gcs.dag_manager.list(
                job_id=q.get("job") or None,
                stalled_only=q.get("stalled", "") in ("1", "true", "yes"),
                limit=int(q.get("limit", 50)))
        except (ValueError, TypeError) as e:
            return web.json_response({"error": str(e)}, status=400)
        out["summary"] = self.gcs.dag_manager.summarize(
            job_id=q.get("job") or None)
        return web.json_response(out)

    async def _events(self, request):
        """Filtered cluster event log (GCS event manager; the Cluster
        tab's event stream + `rayt list events` twin)."""
        from aiohttp import web

        q = request.query
        try:
            out = self.gcs.event_manager.list(
                job_id=q.get("job") or None,
                node_id=q.get("node") or None,
                severity=q.get("severity") or None,
                source=q.get("source") or None,
                kind=q.get("kind") or None,
                limit=int(q.get("limit", 100)))
        except (ValueError, TypeError) as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response(out)

    async def _cluster(self, request):
        """Enriched cluster status: node table with heartbeat age +
        pending-lease depth, per-shape pending demand, the scheduling
        decision rollup, and recent WARNING+ events."""
        from aiohttp import web

        out = self.gcs.rpc_cluster_status(None)
        return web.json_response(json.loads(json.dumps(out,
                                                       default=str)))

    async def _timeline(self, request):
        from aiohttp import web

        from ray_tpu_torch._internal.tracing import to_chrome_trace

        # ?count=1: cheap poll for the SPA — converting + serializing
        # the full lifecycle store on the GCS event loop per 2s refresh
        # would stall heartbeat/lease handling
        if request.query.get("count"):
            return web.json_response(
                {"events": self.gcs.task_manager.num_transitions(),
                 "tasks": self.gcs.task_manager.num_tasks()})
        # full download: snapshot the filtered records on-loop (cheap),
        # build + serialize the multi-MB trace off-loop so
        # heartbeats/leases don't stall
        records = self.gcs.task_manager.records(
            job_id=request.query.get("job") or None)
        body = await asyncio.get_running_loop().run_in_executor(
            None, lambda: json.dumps(to_chrome_trace(records)))
        return web.Response(text=body, content_type="application/json")

    async def _jobs_list(self, request):
        from aiohttp import web

        return web.json_response(self.job_manager.list())

    async def _jobs_submit(self, request):
        from aiohttp import web

        body = await request.json()
        entrypoint = body.get("entrypoint")
        if not entrypoint:
            return web.json_response({"error": "entrypoint required"},
                                     status=400)
        try:
            # executor thread: a pip runtime_env blocks on install
            sub_id = await asyncio.get_running_loop().run_in_executor(
                None, lambda: self.job_manager.submit(
                    entrypoint, env=body.get("env"),
                    submission_id=body.get("submission_id"),
                    runtime_env=body.get("runtime_env")))
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response({"submission_id": sub_id})

    async def _job_status(self, request):
        from aiohttp import web

        status = self.job_manager.status(request.match_info["sub_id"])
        if status is None:
            return web.json_response({"error": "not found"}, status=404)
        return web.json_response(status)

    async def _job_logs(self, request):
        from aiohttp import web

        sub_id = request.match_info["sub_id"]
        if "offset" in request.query:  # incremental tail for --follow
            out = self.job_manager.tail_logs(
                sub_id, int(request.query["offset"]))
            if out is None:
                return web.json_response({"error": "not found"}, status=404)
            return web.json_response(out)
        logs = self.job_manager.logs(sub_id)
        if logs is None:
            return web.json_response({"error": "not found"}, status=404)
        return web.Response(text=logs, content_type="text/plain")

    async def _job_stop(self, request):
        from aiohttp import web

        ok = self.job_manager.stop_job(request.match_info["sub_id"])
        return web.json_response({"stopped": ok})
