"""GCS serve manager — the per-request serve-path observability store
(ref analog: the Serve data plane's request-level telemetry; same
store contract as gcs_task_manager.h: coalesce, memory bound with
per-key eviction + dropped accounting, server-side filtered queries).

The ingress proxies and replicas publish PARTIAL request records on the
``serve_state`` channel, keyed by the request id the proxy minted
(echoed to clients as ``X-Rayt-Request-Id``): the proxy side carries
the top-level latency waterfall (admission wait, router capacity-gate
park, dispatch, stream) whose stages TILE the end-to-end wall time by
construction; the replica side nests its own queue/service split and —
for LLM deployments — the engine phase breakdown (prefill time + chunk
count, TTFT, per-token decode time, decode-batch occupancy). Partials
from the two processes arrive in either order on independent flush
cadences; this module coalesces them by request id.

Retention is TAIL-BIASED and decided at finalize time (when the
outcome and e2e latency are known): errors, sheds, and stream aborts
are always retained, the slowest decile (per-app rolling p90) is
always retained, and the happy path is sampled at
``RAYT_SERVE_REQUEST_SAMPLE``. Prometheus derivation happens BEFORE
the sampling drop, from every finalized record, so the
``rayt_serve_{ttft_s,tpot_s,queue_wait_s,prefill_s}`` histograms are
unskewed by sampling. Replicas additionally publish cumulative engine
counter reports; the manager differences consecutive reports into
``rayt_serve_engine_*_total`` counters and the
``rayt_serve_decode_batch_occupancy`` gauge (the GCS process has no
core worker, so — like the dag/event managers — it builds raw records
and feeds its own metrics store via drain_metric_records()).
"""

from __future__ import annotations

import collections
import random
import time
from typing import Optional

from ray_tpu_torch.util.builtin_metrics import (serve_data_plane_metric_records,
                                                serve_engine_metric_records,
                                                serve_request_metric_records)

# channel convention: the owning manager defines its channel name and
# gcs.py re-exports it next to its siblings (CH_DAGS, CH_EVENTS, ...)
CH_SERVE = "serve_state"

# the waterfall stages whose record keys summarize() rolls p50/p99 for,
# in render order: proxy-side tiling first, then the nested replica /
# engine breakdowns (not part of the tiling sum — cross-process clocks
# don't line up, so they nest under the record instead)
WATERFALL_STAGES = ("admission_s", "router_s", "dispatch_s", "stream_s")
NESTED_STAGES = ("replica_queue_s", "replica_service_s",
                 "engine_queue_s", "engine_prefill_s", "engine_decode_s")

# outcomes that are never sampled out (the tail the store exists for)
_ALWAYS_KEEP = ("error", "shed", "timeout", "queue_full", "no_replicas",
                "stream_aborted")

# per-app rolling e2e window backing the slowest-decile threshold
_E2E_WINDOW = 200
# finalized-then-sampled-out ids remembered so a late replica partial
# doesn't resurrect a dropped record as a phantom pending entry
_RECENT_FINAL = 512


def _pct(values: list, q: float) -> Optional[float]:
    if not values:
        return None
    vs = sorted(values)
    i = min(len(vs) - 1, max(0, int(q * (len(vs) - 1) + 0.5)))
    return vs[i]


class GcsServeManager:
    def __init__(self, max_requests: int = 2000, sample: float = 1.0):
        self.max_requests = max_requests
        self.sample = sample
        # request_id -> coalesced FINALIZED record; insertion-ordered so
        # the oldest record of an app is cheap to find via the app index
        self._requests: dict[str, dict] = {}
        # app -> insertion-ordered set of its request_ids
        self._by_app: dict[str, dict[str, None]] = {}
        # store-side eviction accounting (memory cap), per app
        self._dropped_per_app: collections.Counter = collections.Counter()
        # finalize-time sampling drops (distinct from eviction: these
        # were deliberately not retained; their metrics still emitted)
        self._sampled_per_app: collections.Counter = collections.Counter()
        # partials awaiting their proxy-final sibling, FIFO-bounded
        # (a crashed proxy's orphan partial must not leak forever)
        self._pending: dict[str, dict] = {}
        # finalized-but-dropped ids (bounded): late partials for these
        # are discarded instead of re-opening a pending entry
        self._recent_final: collections.OrderedDict = \
            collections.OrderedDict()
        # per-app rolling e2e window for the slowest-decile threshold
        self._e2e: dict[str, collections.deque] = {}
        # (app, deployment, replica) -> last cumulative engine counters
        self._engine_last: dict[tuple, dict] = {}
        self._metric_buf: list[dict] = []
        self._finalized = 0

    # ------------------------------------------------------------ ingest
    def ingest(self, message):
        """One pubsub payload: a record dict or a batched list of them
        (proxies/replicas flush lists on the metrics cadence)."""
        if isinstance(message, dict):
            message = [message]
        for m in message or ():
            try:
                kind = m.get("kind")
                if kind == "request":
                    self._apply_request(m)
                elif kind == "engine":
                    self._apply_engine(m)
                elif kind == "app_deleted":
                    self.on_app_deleted(m.get("app") or "")
            except Exception:
                continue  # observability must not take down the GCS

    @staticmethod
    def _merge(rec: dict, part: dict):
        """Coalesce one partial into a record: nested stage dicts merge
        key-wise, scalars last-write-win (None never overwrites)."""
        for k, v in part.items():
            if k in ("kind", "side", "final"):
                continue
            if isinstance(v, dict):
                # key-wise, None never overwrites — a disagg request's
                # decode partial (prefill_s: None) and prefill partial
                # (decode keys absent) coalesce into ONE engine
                # waterfall whichever flush lands first
                dst = rec.setdefault(k, {})
                for kk, vv in v.items():
                    if vv is not None:
                        dst[kk] = vv
            elif v is not None:
                rec[k] = v

    def _apply_request(self, part: dict):
        rid = part.get("request_id") or ""
        if not rid:
            return
        rec = self._requests.get(rid)
        if rec is not None:           # late partial for a retained record
            self._merge(rec, part)
            if part.get("side") == "replica":
                self._emit_replica_metrics(rec, part)
            return
        if rid in self._recent_final:  # late partial, record sampled out
            if part.get("side") == "replica":
                self._emit_replica_metrics(part, part)
            return
        pend = self._pending.get(rid)
        if pend is None:
            pend = self._pending[rid] = {"request_id": rid}
            # orphan bound: drop the OLDEST pending partial beyond 2x
            # the retained cap (proxies crash; replicas outlive calls)
            while len(self._pending) > max(256, 2 * self.max_requests):
                self._pending.pop(next(iter(self._pending)))
        self._merge(pend, part)
        if part.get("side") == "replica":
            self._emit_replica_metrics(pend, part)
        if part.get("final"):
            self._pending.pop(rid, None)
            self._finalize(pend)

    # ----------------------------------------------------- finalize path
    def _finalize(self, rec: dict):
        self._finalized += 1
        app = rec.get("app") or ""
        e2e = float(rec.get("e2e_s") or 0.0)
        outcome = rec.get("outcome") or "ok"
        ts = float(rec.get("start_ts") or time.time())
        # Prometheus derivation from EVERY finalized record, before any
        # sampling decision — retention shapes the store, not the series
        self._metric_buf.extend(serve_request_metric_records(
            app,
            queue_wait_s=(float((rec.get("stages") or {})
                                .get("admission_s") or 0.0)
                          + float((rec.get("stages") or {})
                                  .get("router_s") or 0.0)),
            ttft_s=rec.get("ttft_s"), tpot_s=rec.get("tpot_s"), ts=ts))
        eng = rec.get("engine") or {}
        # data-plane counters: router-level prefix classification
        # (hit|spill|cold — the engine's own hit/cold is the fallback
        # when the record predates the router stamp) and per-proxy
        # admission attribution (sheds never held a window slot). KV
        # handoff bytes derive at replica-partial INGEST instead
        # (_emit_replica_metrics) — a disagg replica's flush may land
        # after the proxy final
        self._metric_buf.extend(serve_data_plane_metric_records(
            app,
            prefix_outcome=(rec.get("prefix_cache")
                            or eng.get("prefix_cache")),
            proxy=(rec.get("proxy") if outcome != "shed" else None),
            ts=ts))
        win = self._e2e.get(app)
        if win is None:
            win = self._e2e[app] = collections.deque(maxlen=_E2E_WINDOW)
        win.append(e2e)
        if not self._retain(outcome, e2e, win):
            self._sampled_per_app[app] += 1
            self._recent_final[rec["request_id"]] = None
            while len(self._recent_final) > _RECENT_FINAL:
                self._recent_final.popitem(last=False)
            return
        self._requests[rec["request_id"]] = rec
        self._by_app.setdefault(app, {})[rec["request_id"]] = None
        self._maybe_evict()

    def _retain(self, outcome: str, e2e: float,
                win: collections.deque) -> bool:
        if outcome in _ALWAYS_KEEP:
            return True
        if len(win) < 20:
            return True       # window warming up: keep everything
        p90 = _pct(list(win), 0.9)
        if p90 is not None and e2e >= p90:
            return True       # slowest decile always kept
        if self.sample >= 1.0:
            return True
        return random.random() < max(0.0, self.sample)

    def _maybe_evict(self):
        """Per-app eviction under the global cap: the app holding the
        most records gives up its OLDEST one (one flood app can't evict
        every other app's history)."""
        while len(self._requests) > self.max_requests:
            victim = max(self._by_app, key=lambda a: len(self._by_app[a]))
            ids = self._by_app[victim]
            rid = next(iter(ids))
            del ids[rid]
            if not ids:
                del self._by_app[victim]
            self._requests.pop(rid, None)
            self._dropped_per_app[victim] += 1

    # --------------------------------------------- engine report deltas
    def _emit_replica_metrics(self, rec: dict, part: dict):
        """Per-request engine-phase histograms, derived from the replica
        partial at ITS ingest (ordering vs the proxy final doesn't
        matter — the series never waits on coalescing)."""
        eng = part.get("engine") or {}
        if not eng:
            return
        app = rec.get("app") or part.get("app") or ""
        ts = float(part.get("ts") or time.time())
        self._metric_buf.extend(serve_request_metric_records(
            app, prefill_s=eng.get("prefill_s"), ts=ts))
        # KV handoff volume (disagg): only the prefill pool's partial
        # carries the bytes, so ingest-time derivation counts each
        # handoff exactly once whatever the flush order
        self._metric_buf.extend(serve_data_plane_metric_records(
            app, kv_bytes=int(eng.get("kv_handoff_bytes") or 0),
            edge_kind=str(eng.get("kv_handoff_edge") or ""), ts=ts))

    def _apply_engine(self, m: dict):
        """Cumulative engine counters from a replica report → deltas
        into the rayt_serve_engine_* family (counter records carry
        DELTAS; the metrics store sums them). A counter that went
        BACKWARD means the replica restarted its engine — treat the new
        cumulative value as the delta."""
        app = m.get("app") or ""
        dep = m.get("deployment") or ""
        rep = m.get("replica") or ""
        cur = {k: int(m.get(k) or 0)
               for k in ("prefills", "prefill_chunks", "decode_steps")}
        key = (app, dep, rep)
        last = self._engine_last.get(key) or {}
        deltas = {k: (v - last.get(k, 0) if v >= last.get(k, 0) else v)
                  for k, v in cur.items()}
        self._engine_last[key] = cur
        self._metric_buf.extend(serve_engine_metric_records(
            app, dep, rep,
            prefills=deltas["prefills"],
            prefill_chunks=deltas["prefill_chunks"],
            decode_steps=deltas["decode_steps"],
            occupancy=m.get("occupancy"),
            ts=float(m.get("ts") or time.time())))

    def drain_metric_records(self) -> list[dict]:
        out, self._metric_buf = self._metric_buf, []
        return out

    # -------------------------------------------------------- app purge
    def on_app_deleted(self, app: str):
        """serve.delete() purge: the app's retained records, pending
        partials, windows, engine baselines, and dropped accounting all
        go — a redeployed app starts with a clean ledger."""
        for rid in list(self._by_app.pop(app, ())):
            self._requests.pop(rid, None)
        for rid in [r for r, p in self._pending.items()
                    if (p.get("app") or "") == app]:
            self._pending.pop(rid, None)
        self._e2e.pop(app, None)
        self._dropped_per_app.pop(app, None)
        self._sampled_per_app.pop(app, None)
        for key in [k for k in self._engine_last if k[0] == app]:
            self._engine_last.pop(key, None)

    # ------------------------------------------------------------ queries
    def get(self, request_id: str) -> Optional[dict]:
        """One record by request id (hex prefix accepted, like the other
        id-taking CLI surfaces)."""
        rec = self._requests.get(request_id)
        if rec is None and request_id:
            rec = next((r for rid, r in self._requests.items()
                        if rid.startswith(request_id)), None)
        if rec is None:
            return None
        return self._snap(rec)

    @staticmethod
    def _snap(rec: dict) -> dict:
        # snapshot the mutable sub-dicts: consumers serialize off the
        # GCS loop while live records keep coalescing late partials
        out = dict(rec)
        for k in ("stages", "replica_stages", "engine"):
            if isinstance(out.get(k), dict):
                out[k] = dict(out[k])
        return out

    def _iter_filtered(self, app=None, outcome=None, model_id=None,
                       errors_only=False, min_e2e_s=None):
        if app is not None:
            source = (self._requests[r]
                      for r in self._by_app.get(app, ()))
        else:
            source = iter(self._requests.values())
        for rec in source:
            oc = rec.get("outcome") or "ok"
            if outcome is not None and oc != outcome:
                continue
            if errors_only and oc == "ok":
                continue
            if model_id is not None and \
                    (rec.get("model_id") or "") != model_id:
                continue
            if min_e2e_s is not None and \
                    float(rec.get("e2e_s") or 0.0) < min_e2e_s:
                continue
            yield rec

    def list(self, *, app: Optional[str] = None,
             outcome: Optional[str] = None,
             model_id: Optional[str] = None, errors_only: bool = False,
             min_e2e_s: Optional[float] = None, slow: bool = False,
             limit: int = 100) -> dict:
        """Filtered request records with truncation + per-app dropped /
        sampled accounting. Newest first; ``slow=True`` orders by e2e
        descending instead (the `rayt list requests --slow` view)."""
        matched = list(self._iter_filtered(app, outcome, model_id,
                                           errors_only, min_e2e_s))
        if slow:
            matched.sort(key=lambda r: float(r.get("e2e_s") or 0.0),
                         reverse=True)
        else:
            matched.reverse()  # insertion order -> newest first
        limit = max(0, limit or 0)  # <= 0 means unlimited
        truncated = max(0, len(matched) - limit) if limit else 0
        return {
            "requests": [self._snap(r)
                         for r in (matched[:limit] if limit else matched)],
            "total": len(matched),
            "truncated": truncated,
            "dropped": self.dropped_counts(app),
            "sampled_out": self.sampled_counts(app),
        }

    def summarize(self, *, app: Optional[str] = None) -> dict:
        """Per-app rollup: request/outcome counts plus p50/p99/mean per
        waterfall stage and for ttft/tpot/e2e — the `rayt serve status`
        table and the dashboard Serve tab's data source."""
        apps: dict[str, dict] = {}
        for rec in self._iter_filtered(app):
            a = rec.get("app") or ""
            e = apps.get(a)
            if e is None:
                e = apps[a] = {"count": 0,
                               "outcomes": collections.Counter(),
                               "stages": collections.defaultdict(list),
                               "e2e": [], "ttft": [], "tpot": []}
            e["count"] += 1
            e["outcomes"][rec.get("outcome") or "ok"] += 1
            e["e2e"].append(float(rec.get("e2e_s") or 0.0))
            if rec.get("ttft_s") is not None:
                e["ttft"].append(float(rec["ttft_s"]))
            if rec.get("tpot_s") is not None:
                e["tpot"].append(float(rec["tpot_s"]))
            stages = rec.get("stages") or {}
            for k in WATERFALL_STAGES:
                if stages.get(k) is not None:
                    e["stages"][k].append(float(stages[k]))
            rs = rec.get("replica_stages") or {}
            eng = rec.get("engine") or {}
            for k, src, kk in (("replica_queue_s", rs, "queue_s"),
                               ("replica_service_s", rs, "service_s"),
                               ("engine_queue_s", eng, "queue_s"),
                               ("engine_prefill_s", eng, "prefill_s"),
                               ("engine_decode_s", eng, "decode_s")):
                if src.get(kk) is not None:
                    e["stages"][k].append(float(src[kk]))
        out = {}
        for a, e in sorted(apps.items()):
            def roll(vals):
                return {"p50": _pct(vals, 0.5), "p99": _pct(vals, 0.99),
                        "mean": (sum(vals) / len(vals)) if vals else None,
                        "n": len(vals)}
            out[a] = {
                "count": e["count"],
                "outcomes": dict(e["outcomes"]),
                "e2e": roll(e["e2e"]),
                "ttft": roll(e["ttft"]),
                "tpot": roll(e["tpot"]),
                "stages": {k: roll(v) for k, v in e["stages"].items()},
            }
        return {
            "apps": out,
            "total_requests": sum(e["count"] for e in out.values())
            if out else 0,
            "finalized_total": self._finalized,
            "dropped": self.dropped_counts(app),
            "sampled_out": self.sampled_counts(app),
        }

    def dropped_counts(self, app: Optional[str] = None) -> dict:
        if app is not None:
            return {app: self._dropped_per_app.get(app, 0)}
        return dict(self._dropped_per_app)

    def sampled_counts(self, app: Optional[str] = None) -> dict:
        if app is not None:
            return {app: self._sampled_per_app.get(app, 0)}
        return dict(self._sampled_per_app)

    def num_requests(self) -> int:
        return len(self._requests)
