"""The serve benchmarks of ``ray_tpu_torch.serve`` (the port's twin of the
JAX package's ``tools/serve_bench.py``, with the same legs and the same
result keys).

Leg ``engine`` drives ``LLMEngine`` in process with N concurrent
closed-loop streams: generated tokens/s, TTFT and inter-token latency
p50/p99, and the late-join TTFT. Leg ``sustained`` drives the whole serve
data plane (cluster, controller, autoscaled replicas, the HTTP ingress)
open-loop: a steady phase, a burst at ~2x the minimum capacity that must
shed with 503 and scale up, and a drain back to the minimum. Leg
``latency`` times a paced streaming app's TTFT and TPOT through the proxy
and reads the server-side waterfall records. Leg ``multi_proxy`` runs the
sharded-ingress fan-out with one proxy killed mid-burst, then the prefix
KV-reuse comparison and the disaggregated prefill/decode comparison, whose
engines are tensor-parallel at ``tp=2`` (two cards on the card; two gloo
ranks each with ``--device cpu``): a prefill engine hands each prompt's KV
rows, every kv head, over the shm device edge to a decode engine.

Run it as ``python -m ray_tpu_torch.tools.serve_bench [--leg LEG]``. The
engines run on the CUDA card unless ``--device cpu`` is given; with no
card and no ``--device cpu`` it raises. It prints one JSON object on one
line, and writes it only to the ``--out`` path the caller names.
"""

from __future__ import annotations

import asyncio
import json
import time


def _pct(xs, p):
    if not xs:
        return None
    xs = sorted(xs)
    i = min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))
    return xs[i]


async def _run_bench(preset: str, concurrency: int, requests: int,
                     max_new: int, prompt_len: int, device=None):
    import numpy as np

    from ray_tpu_torch.serve.llm import LLMEngine

    # one engine on one card (tp=None would take every card the process
    # sees, and the debug preset's 2 kv heads do not split over 4)
    eng = LLMEngine(preset, tp=1, max_batch=concurrency,
                    prompt_buckets=(32, 128), max_seq_len=512,
                    device=device)
    rng = np.random.default_rng(0)

    # warmup: trace prefill + decode + insert paths once
    async for _ in eng.generate(list(rng.integers(1, 100, prompt_len)),
                                max_new_tokens=4):
        pass

    ttfts: list[float] = []
    itls: list[float] = []
    done = 0

    async def one_stream():
        nonlocal done
        while done < requests:
            done += 1
            prompt = list(rng.integers(1, 100, prompt_len))
            t0 = time.perf_counter()
            last = None
            async for _tok in eng.generate(prompt, max_new_tokens=max_new):
                now = time.perf_counter()
                if last is None:
                    ttfts.append(now - t0)
                else:
                    itls.append(now - last)
                last = now

    t_start = time.perf_counter()
    gen0 = eng.generated_tokens
    await asyncio.gather(*[one_stream() for _ in range(concurrency)])
    elapsed = time.perf_counter() - t_start
    tokens = eng.generated_tokens - gen0

    # late-join probe: saturate all slots with long generations, then
    # inject one short request and time its first token
    async def long_stream():
        async for _ in eng.generate(list(rng.integers(1, 100, prompt_len)),
                                    max_new_tokens=max_new * 4):
            pass

    base_steps = eng.batches
    background = [asyncio.ensure_future(long_stream())
                  for _ in range(max(1, concurrency - 1))]
    # wait until the background streams are admitted and well into
    # decode, so the probe measures joining a SATURATED batch
    while (eng.batches - base_steps < 5
           and not all(b.done() for b in background)):
        await asyncio.sleep(0.005)
    t0 = time.perf_counter()
    late_ttft = None
    async for _tok in eng.generate(list(rng.integers(1, 100, prompt_len)),
                                   max_new_tokens=2):
        if late_ttft is None:
            late_ttft = time.perf_counter() - t0
    await asyncio.gather(*background)

    def _ms(v, nd=2):
        return None if v is None else round(v * 1e3, nd)

    return {
        "metric": "serve_llm_engine_throughput",
        "preset": preset,
        "platform": eng.device.type,
        "concurrency": concurrency,
        "requests": requests,
        "prompt_len": prompt_len,
        "max_new_tokens": max_new,
        "tokens_per_sec": round(tokens / elapsed, 1),
        "ttft_p50_ms": _ms(_pct(ttfts, 50)),
        "ttft_p99_ms": _ms(_pct(ttfts, 99)),
        "itl_p50_ms": _ms(_pct(itls, 50), 3),
        "itl_p99_ms": _ms(_pct(itls, 99), 3),
        "late_join_ttft_ms": _ms(late_ttft),
        "decode_steps": eng.batches,
        "prefills": eng.prefills,
    }


# --------------------------------------------------------- sustained leg
def run_sustained(*, service_time_s: float = 0.15, max_ongoing: int = 4,
                  min_replicas: int = 1, max_replicas: int = 3,
                  steady_s: float = 30.0, burst_s: float = 10.0,
                  steady_util: float = 0.5, burst_factor: float = 2.0,
                  request_timeout_s: float = 5.0,
                  drain_wait_s: float = 20.0,
                  app_name: str = "sustained") -> dict:
    """Sustained-load serve data-plane leg (call inside a started
    cluster; deploys its own app + HTTP proxy and deletes the app when
    done). Returns the result dict (see module docstring)."""
    import asyncio as aio

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    port = serve.start(http_port=0, request_timeout_s=request_timeout_s)

    @serve.deployment(max_ongoing_requests=max_ongoing,
                      autoscaling_config={
                          "min_replicas": min_replicas,
                          "max_replicas": max_replicas,
                          "target_ongoing_requests":
                              max(1, int(max_ongoing * 0.75)),
                          "upscale_delay_s": 0.5,
                          "downscale_delay_s": 2.0})
    class SustainedTarget:
        async def __call__(self, payload):
            import asyncio

            await asyncio.sleep(service_time_s)
            return "ok"

    serve.run(SustainedTarget.bind(), name=app_name)
    controller = serve._controller(create=False)
    url = f"http://127.0.0.1:{port}/{app_name}"

    capacity_at_min = min_replicas * max_ongoing / service_time_s
    steady_rate = steady_util * capacity_at_min
    burst_rate = burst_factor * capacity_at_min

    replica_samples: list[int] = []

    async def _sample_replicas(stop: "aio.Event"):
        loop = aio.get_running_loop()
        while not stop.is_set():
            try:
                deps = await loop.run_in_executor(
                    None, lambda: rt.get(
                        controller.get_deployments.remote(app_name),
                        timeout=10))
                replica_samples.append(deps[0]["num_replicas"])
            except Exception:
                pass
            try:
                await aio.wait_for(stop.wait(), 0.5)
            except aio.TimeoutError:
                pass

    async def _drive(session, rate: float, duration: float) -> list:
        """Open-loop: one request per 1/rate seconds on the wall clock,
        never gated on completions."""
        loop = aio.get_running_loop()
        results: list = []

        async def one():
            t0 = time.perf_counter()
            try:
                async with session.post(url, json={}) as resp:
                    await resp.read()
                    results.append((resp.status,
                                    time.perf_counter() - t0,
                                    resp.headers.get("X-Rayt-Reason", "")))
            except Exception as e:
                results.append((-1, time.perf_counter() - t0, repr(e)))

        interval = 1.0 / rate
        t_end = loop.time() + duration
        next_t = loop.time()
        tasks = []
        while loop.time() < t_end:
            tasks.append(aio.ensure_future(one()))
            next_t += interval
            delay = next_t - loop.time()
            if delay > 0:
                await aio.sleep(delay)
        await aio.gather(*tasks)
        return results

    def _phase_stats(results: list, duration: float) -> dict:
        admitted = [r for r in results if r[0] == 200]
        shed = [r for r in results if r[0] == 503
                and r[2] in ("shed", "queue_full", "no_replicas")]
        timeouts = [r for r in results if r[0] == 503
                    and r[2] == "timeout"]
        errors = [r for r in results
                  if r[0] not in (200, 503)]
        lats = sorted(r[1] for r in admitted)
        total = max(1, len(results))
        return {
            "offered": len(results),
            "admitted": len(admitted),
            "achieved_qps": round(len(admitted) / duration, 1),
            "shed": len(shed),
            "shed_rate": round(len(shed) / total, 3),
            "timeouts": len(timeouts),
            "errors": len(errors),
            "latency_p50_ms": round(1e3 * _pct(lats, 50), 1) if lats
            else None,
            "latency_p99_ms": round(1e3 * _pct(lats, 99), 1) if lats
            else None,
        }

    async def _run() -> dict:
        import aiohttp

        stop = aio.Event()
        sampler = aio.ensure_future(_sample_replicas(stop))
        conn = aiohttp.TCPConnector(limit=0)
        async with aiohttp.ClientSession(connector=conn) as session:
            steady = await _drive(session, steady_rate, steady_s)
            burst_start = len(replica_samples)
            burst = await _drive(session, burst_rate, burst_s)
            peak = max(replica_samples[burst_start:] or [min_replicas])
            # drain: no traffic; wait for scale-down to min
            t0 = time.perf_counter()
            final = peak
            while time.perf_counter() - t0 < drain_wait_s:
                deps = await aio.get_running_loop().run_in_executor(
                    None, lambda: rt.get(
                        controller.get_deployments.remote(app_name),
                        timeout=10))
                final = deps[0]["num_replicas"]
                if final <= min_replicas:
                    break
                await aio.sleep(0.5)
            drain_s = time.perf_counter() - t0
        stop.set()
        await sampler
        return {
            "metric": "serve_sustained_load",
            "config": {
                "service_time_s": service_time_s,
                "max_ongoing_requests": max_ongoing,
                "min_replicas": min_replicas,
                "max_replicas": max_replicas,
                "steady_rate_qps": round(steady_rate, 1),
                "burst_rate_qps": round(burst_rate, 1),
                "steady_s": steady_s, "burst_s": burst_s,
                "request_timeout_s": request_timeout_s,
            },
            "steady": _phase_stats(steady, steady_s),
            "burst": {**_phase_stats(burst, burst_s),
                      "peak_replicas": peak},
            "drain": {"final_replicas": final,
                      "seconds": round(drain_s, 1)},
            "metrics": _serve_metric_totals(),
        }

    try:
        return asyncio.run(_run())
    finally:
        try:
            serve.delete(app_name)
        except Exception:
            pass


# ----------------------------------------------------------- latency leg
def run_latency(*, rate_qps: float = 8.0, duration_s: float = 15.0,
                chunks: int = 8, chunk_interval_s: float = 0.01,
                app_name: str = "latbench") -> dict:
    """Streaming request-path latency leg (call inside a started
    cluster; deploys its own paced streaming app + HTTP proxy and
    deletes the app when done)."""
    import asyncio as aio

    from ray_tpu_torch import serve

    port = serve.start(http_port=0)

    @serve.deployment(max_ongoing_requests=32)
    class Paced:
        async def __call__(self, payload):
            import asyncio

            for i in range(chunks):
                if i:
                    await asyncio.sleep(chunk_interval_s)
                yield {"i": i}

    serve.run(Paced.bind(), name=app_name)
    url = f"http://127.0.0.1:{port}/{app_name}?stream=1"

    ttfts: list[float] = []
    tpots: list[float] = []
    e2es: list[float] = []
    outcomes: dict = {}

    async def _one(session):
        t0 = time.perf_counter()
        last = None
        n = 0
        try:
            async with session.post(url, json={}) as resp:
                if resp.status != 200:
                    outcomes[f"http_{resp.status}"] = outcomes.get(
                        f"http_{resp.status}", 0) + 1
                    await resp.read()
                    return
                async for chunk in resp.content.iter_any():
                    if not chunk:
                        continue
                    now = time.perf_counter()
                    if last is None:
                        ttfts.append(now - t0)
                    else:
                        tpots.append(now - last)
                    last = now
                    n += chunk.count(b"data:")
            e2es.append(time.perf_counter() - t0)
            outcomes["ok"] = outcomes.get("ok", 0) + 1
        except Exception as e:
            outcomes[type(e).__name__] = outcomes.get(
                type(e).__name__, 0) + 1

    async def _run():
        import aiohttp

        conn = aiohttp.TCPConnector(limit=0)
        async with aiohttp.ClientSession(connector=conn) as session:
            loop = aio.get_running_loop()
            interval = 1.0 / rate_qps
            t_end = loop.time() + duration_s
            next_t = loop.time()
            tasks = []
            while loop.time() < t_end:
                tasks.append(aio.ensure_future(_one(session)))
                next_t += interval
                delay = next_t - loop.time()
                if delay > 0:
                    await aio.sleep(delay)
            await aio.gather(*tasks)

    def _waterfall_means() -> dict:
        """Server-side stage means from the GCS serve-state store."""
        try:
            from ray_tpu_torch.core.object_ref import get_core_worker

            cw = get_core_worker()
            summ = cw.io.run(cw.gcs.call(
                "summarize_serve_requests", {"app": app_name}))
            app = summ.get("apps", {}).get(app_name)
            if not app:
                return {}
            out = {"count": app.get("count", 0),
                   "outcomes": app.get("outcomes", {})}
            for k in ("e2e", "ttft", "tpot"):
                st = app.get(k) or {}
                if st.get("mean") is not None:
                    out[f"{k}_mean_ms"] = round(1e3 * st["mean"], 2)
            for stage, st in app.get("stages", {}).items():
                if st.get("mean") is not None:
                    out[f"{stage.removesuffix('_s')}_mean_ms"] = round(
                        1e3 * st["mean"], 2)
            return out
        except Exception:
            return {}

    def _ms(v, nd=2):
        return None if v is None else round(v * 1e3, nd)

    try:
        asyncio.run(_run())
        time.sleep(2.5)  # serve-state recorder flush cadence
        return {
            "metric": "serve_request_latency",
            "config": {
                "rate_qps": rate_qps, "duration_s": duration_s,
                "chunks": chunks,
                "chunk_interval_s": chunk_interval_s,
            },
            "requests": sum(outcomes.values()),
            "outcomes": outcomes,
            "ttft_p50_ms": _ms(_pct(ttfts, 50)),
            "ttft_p99_ms": _ms(_pct(ttfts, 99)),
            "tpot_p50_ms": _ms(_pct(tpots, 50), 3),
            "tpot_p99_ms": _ms(_pct(tpots, 99), 3),
            "e2e_p50_ms": _ms(_pct(e2es, 50)),
            "e2e_p99_ms": _ms(_pct(e2es, 99)),
            "waterfall": _waterfall_means(),
        }
    finally:
        try:
            serve.delete(app_name)
        except Exception:
            pass


# -------------------------------------------------------- multi-proxy leg
def run_multi_proxy_fanout(*, num_proxies: int = 3, replicas: int = 4,
                           max_ongoing: int = 8,
                           service_time_s: float = 0.01,
                           rate_qps: float = 250.0,
                           duration_s: float = 10.0,
                           chaos_at_s: float = 3.0,
                           request_timeout_s: float = 10.0,
                           app_name: str = "fan") -> dict:
    """Sharded-ingress fan-out leg (call inside a started cluster):
    open-loop arrivals round-robined across N HTTP proxies against a
    fixed-replica echo app, per-proxy admission-window shares checked
    against the cluster window, and one proxy killed mid-burst (the
    chaos drill) — surviving members must pick up the dead member's
    share within one heartbeat TTL, with zero admitted-request
    timeouts or 500s end to end."""
    import asyncio as aio

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    serve.start(http_port=0, request_timeout_s=request_timeout_s,
                num_proxies=num_proxies)
    ports = serve.proxy_ports()

    @serve.deployment(num_replicas=replicas,
                      max_ongoing_requests=max_ongoing)
    class Echo:
        async def __call__(self, payload):
            import asyncio

            await asyncio.sleep(service_time_s)
            return "ok"

    serve.run(Echo.bind(), name=app_name)

    def _admission(port: int) -> dict:
        import urllib.request

        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/-/admission", timeout=10) as r:
            return json.loads(r.read())

    def _window_share(ports_: list) -> dict:
        """Per-proxy windows for the app + the cluster window they
        shard (every live member must agree on the denominator)."""
        snaps = []
        for p in ports_:
            try:
                snaps.append(_admission(p))
            except Exception:
                continue
        wins = [s[app_name]["window"] for s in snaps
                if app_name in s]
        cluster = max((s[app_name]["cluster_window"] for s in snaps
                      if app_name in s), default=0)
        return {"windows": wins, "window_sum": sum(wins),
                "cluster_window": cluster,
                "live_proxies": max((s.get("live_proxies", 1)
                                     for s in snaps), default=0),
                "share_error": (abs(sum(wins) - cluster) / cluster
                                if cluster else None)}

    # prime every proxy's capacity cache so the share math is live
    import urllib.request
    for p in ports:
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{p}/{app_name}", data=b"{}"),
            timeout=30).read()
    time.sleep(1.5)  # one heartbeat so live_proxies covers the fleet
    shares_before = _window_share(ports)

    results: list = []          # (status, latency_s, reason)
    conn_errors = [0]
    live_ports = list(ports)

    async def _drive() -> dict:
        import aiohttp

        loop = aio.get_running_loop()
        killed = {"t": None, "redistributed_s": None}

        async def one(session, port):
            t0 = time.perf_counter()
            url = f"http://127.0.0.1:{port}/{app_name}"
            try:
                async with session.post(url, json={}) as resp:
                    await resp.read()
                    results.append(
                        (resp.status, time.perf_counter() - t0,
                         resp.headers.get("X-Rayt-Reason", "")))
            except Exception:
                # a client aimed at the killed member: fail over —
                # never counted as an admitted failure (it never held
                # a window slot)
                conn_errors[0] += 1
                if port in live_ports and len(live_ports) > 1:
                    live_ports.remove(port)

        async def chaos():
            await aio.sleep(chaos_at_s)
            victim = serve.proxy_name(1)
            rt.kill(rt.get_actor(victim))
            killed["t"] = time.perf_counter()
            # watch a survivor's admission view: redistribution lands
            # when it sees the shrunken fleet (heartbeat TTL)
            deadline = time.perf_counter() + 20.0
            while time.perf_counter() < deadline:
                try:
                    snap = await loop.run_in_executor(
                        None, _admission, live_ports[0])
                    if snap.get("live_proxies", 99) <= num_proxies - 1:
                        killed["redistributed_s"] = round(
                            time.perf_counter() - killed["t"], 2)
                        return
                except Exception:
                    pass
                await aio.sleep(0.25)

        conn = aiohttp.TCPConnector(limit=0)
        # client-side cap: a request in flight on the killed proxy
        # would otherwise wait forever (counts as a failover error)
        tmo = aiohttp.ClientTimeout(total=request_timeout_s + 5.0)
        async with aiohttp.ClientSession(connector=conn,
                                         timeout=tmo) as session:
            chaos_task = aio.ensure_future(chaos())
            interval = 1.0 / rate_qps
            t_end = loop.time() + duration_s
            next_t = loop.time()
            tasks = []
            i = 0
            while loop.time() < t_end:
                port = live_ports[i % len(live_ports)]
                i += 1
                tasks.append(aio.ensure_future(one(session, port)))
                next_t += interval
                delay = next_t - loop.time()
                if delay > 0:
                    await aio.sleep(delay)
            await aio.gather(*tasks)
            await chaos_task
        return killed

    try:
        killed = asyncio.run(_drive())
        shares_after = _window_share(live_ports)
        admitted = [r for r in results if r[0] == 200]
        shed = [r for r in results if r[0] == 503 and r[2] != "timeout"]
        timeouts = [r for r in results
                    if r[0] == 503 and r[2] == "timeout"]
        errors = [r for r in results if r[0] not in (200, 503)]
        lats = sorted(r[1] for r in admitted)
        return {
            "metric": "serve_multi_proxy_fanout",
            "config": {"num_proxies": num_proxies,
                       "replicas": replicas,
                       "max_ongoing_requests": max_ongoing,
                       "service_time_s": service_time_s,
                       "rate_qps": rate_qps, "duration_s": duration_s,
                       "chaos_at_s": chaos_at_s},
            "offered": len(results) + conn_errors[0],
            "admitted": len(admitted),
            "admitted_qps": round(len(admitted) / duration_s, 1),
            "shed": len(shed),
            "admitted_timeouts": len(timeouts),
            "errors_5xx": len(errors),
            "conn_errors_failover": conn_errors[0],
            "latency_p50_ms": (round(1e3 * _pct(lats, 50), 1)
                               if lats else None),
            "latency_p99_ms": (round(1e3 * _pct(lats, 99), 1)
                               if lats else None),
            "window_shares_before": shares_before,
            "window_shares_after_chaos": shares_after,
            "chaos_redistributed_s": killed.get("redistributed_s"),
        }
    finally:
        try:
            serve.delete(app_name)
        except Exception:
            pass


def run_prefix_reuse(*, prompt_len: int = 120, warm_requests: int = 12,
                     cold_requests: int = 6, max_new: int = 4,
                     device=None) -> dict:
    """Prefix KV-reuse leg (in-process engine): TTFT of repeated-prefix
    prompts (engine grafts the cached leading blocks and prefills only
    the tail) vs distinct cold prompts, plus the engine's hit-rate
    counters. One request at a time — TTFT here is pure prefill cost."""
    import numpy as np

    from ray_tpu_torch.serve.llm import LLMEngine

    # prefill_chunk MUST be on: the hit path skips the grafted chunks
    # (a hit prefills only the tail past the cached blocks), while cold
    # walks every chunk — chunk=0 would prefill the full bucket either
    # way and the graft would only add copy cost
    eng = LLMEngine("debug", tp=2, max_batch=2, prompt_buckets=(32, 128),
                    max_seq_len=512, prefill_chunk=16, device=device)
    rng = np.random.default_rng(7)

    async def _ttft(prompt) -> float:
        t0 = time.perf_counter()
        first = None
        async for _tok in eng.generate(prompt, max_new_tokens=max_new):
            if first is None:
                first = time.perf_counter() - t0
        return first

    async def _run():
        # warmup: trace prefill + insert + decode once
        await _ttft(list(rng.integers(1, 200, prompt_len)))
        cold = [await _ttft(list(rng.integers(1, 200, prompt_len)))
                for _ in range(cold_requests)]
        warm_prompt = list(rng.integers(1, 200, prompt_len))
        await _ttft(warm_prompt)          # seeds the prefix store
        warm = [await _ttft(list(warm_prompt))
                for _ in range(warm_requests)]
        return cold, warm

    try:
        cold, warm = asyncio.run(_run())
        stats = eng.stats()
    finally:
        eng.shutdown()
    hits = stats["prefix_hits"]
    misses = stats["prefix_misses"]
    cold_p50 = _pct(cold, 50)
    warm_p50 = _pct(warm, 50)
    return {
        "metric": "serve_prefix_reuse",
        "config": {"prompt_len": prompt_len,
                   "prefix_block": eng._prefix_block,
                   "warm_requests": warm_requests,
                   "cold_requests": cold_requests},
        "prefix_hits": hits,
        "prefix_misses": misses,
        "hit_rate": round(hits / max(1, hits + misses), 3),
        "prefix_hit_tokens": stats["prefix_hit_tokens"],
        "cold_ttft_p50_ms": round(1e3 * cold_p50, 2),
        "warm_ttft_p50_ms": round(1e3 * warm_p50, 2),
        "warm_over_cold_ttft": round(warm_p50 / cold_p50, 3),
    }


def run_disagg(*, streams: int = 4, stream_new_tokens: int = 100,
               long_prompts: int = 6, long_prompt_len: int = 120,
               device=None) -> dict:
    """Disaggregated prefill/decode leg (in-process engines): a full
    batch of short decode streams with long prompts injected mid-run.
    Fused baseline: the long prompts prefill INSIDE the decode engine
    (chunked), holding slots that emit nothing — the streams' decode
    occupancy dips. Disagg: every prompt prefills in a separate engine
    and hands its KV rows over the shm device edge as one packed tick
    (raw shard bytes, zero pickle fallbacks), so the decode pool's
    occupancy holds. Reports per-mode occupancy plus handoff bytes /
    edge kind / packed-leaf counts."""
    import numpy as np

    from ray_tpu_torch.dag.channel import ShmChannel
    from ray_tpu_torch.dag.dcn_channel import attach_channel
    from ray_tpu_torch.dag.device_channel import (DeviceChannelSpec,
                                            DeviceTransportChannel,
                                            tree_nbytes)
    from ray_tpu_torch.serve.llm import _edge_kind, LLMEngine
    from ray_tpu_torch.serve.request_context import (_reset_request_obs,
                                               _set_request_obs)

    kw = dict(tp=2, max_batch=streams, prompt_buckets=(32, 128),
              max_seq_len=512, prefill_chunk=16, device=device)
    engines: list = []      # every engine made, shut down at the end
    rng = np.random.default_rng(3)
    short = [list(rng.integers(1, 200, 8)) for _ in range(streams)]
    longs = [list(rng.integers(1, 200, long_prompt_len))
             for _ in range(long_prompts)]

    def _spawn_with_obs(coro_fn):
        """ensure_future in a context carrying a fresh obs dict (the
        engine stamps per-step occupancy into it)."""
        obs = {}
        token = _set_request_obs(obs)
        try:
            task = asyncio.ensure_future(coro_fn())
        finally:
            _reset_request_obs(token)
        return obs, task

    async def _fused() -> list:
        eng = LLMEngine("debug", **kw)
        engines.append(eng)
        for p in (longs[0], short[0]):  # warm both prefill buckets
            async for _ in eng.generate(p, max_new_tokens=2):
                pass

        async def stream(p):
            async for _ in eng.generate(p,
                                        max_new_tokens=stream_new_tokens):
                pass

        async def inject():
            for p in longs:
                async for _ in eng.generate(p, max_new_tokens=2):
                    pass

        pairs = [_spawn_with_obs(lambda p=p: stream(p)) for p in short]
        inj = asyncio.ensure_future(inject())
        await asyncio.gather(inj, *[t for _, t in pairs])
        return [o for o, _ in pairs]

    handoffs: list = []

    async def _disagg() -> list:
        pre = LLMEngine("debug", **kw)
        engines.append(pre)
        dec = LLMEngine("debug", **kw)
        engines.append(dec)
        for p in (longs[0], short[0]):  # warm both buckets, both engines
            h0 = await pre.prefill_only(p)
            async for _ in dec.generate_prefilled(p, h0,
                                                  max_new_tokens=2):
                pass
        loop = asyncio.get_running_loop()
        kv = 2 * dec.cfg.n_layers * 128 * dec.cfg.n_kv_heads * \
            dec.cfg.head_dim * 4
        slot = kv + kv // 4 + (1 << 16)

        async def handoff(tokens) -> dict:
            """prefill_only -> ONE packed tick over the shm device edge
            -> decode-side read (the serve path, minus the actors)."""
            h = await pre.prefill_only(tokens)
            shm = ShmChannel.create(slot_size=slot, n_slots=2)
            spec = DeviceChannelSpec(name=shm.spec.name,
                                     inner=shm.spec)
            ch = DeviceTransportChannel(shm, spec)
            prod = attach_channel(spec)
            try:
                await loop.run_in_executor(
                    None, lambda: prod.write(dict(h), timeout=30.0))
                tick = await loop.run_in_executor(
                    None, lambda: ch.read(timeout=30.0))
                handoffs.append(
                    {"bytes": int(tree_nbytes({"k": h["k"],
                                               "v": h["v"]})),
                     "edge_kind": _edge_kind(prod, spec),
                     "n_arrays": int(prod.device_arrays)})
                return tick
            finally:
                prod.close()
                ch.close()

        async def stream(p, tick):
            async for _ in dec.generate_prefilled(
                    p, tick, max_new_tokens=stream_new_tokens):
                pass

        async def inject():
            for p in longs:
                tick = await handoff(p)
                async for _ in dec.generate_prefilled(p, tick,
                                                      max_new_tokens=2):
                    pass

        # prefill pool runs AHEAD of decode: every stream's KV lands
        # before its decode slot is claimed, so the pool starts full —
        # that head start is the disagg contract under test
        ticks = await asyncio.gather(*[handoff(p) for p in short])
        pairs = [_spawn_with_obs(lambda p=p, t=t: stream(p, t))
                 for p, t in zip(short, ticks)]
        inj = asyncio.ensure_future(inject())
        await asyncio.gather(inj, *[t for _, t in pairs])
        return [o for o, _ in pairs]

    def _occ(obs_list: list):
        vals = [o["occupancy_sum"] / o["decode_steps"]
                for o in obs_list if o.get("decode_steps")]
        return round(sum(vals) / len(vals), 3) if vals else None

    try:
        fused_obs = asyncio.run(_fused())
        disagg_obs = asyncio.run(_disagg())
    finally:
        for eng in engines:
            eng.shutdown()
    return {
        "metric": "serve_disagg_prefill_decode",
        "config": {"streams": streams,
                   "stream_new_tokens": stream_new_tokens,
                   "long_prompts": long_prompts,
                   "long_prompt_len": long_prompt_len,
                   "prefill_chunk": kw["prefill_chunk"]},
        "fused_occupancy_mean": _occ(fused_obs),
        "disagg_occupancy_mean": _occ(disagg_obs),
        "kv_handoffs": len(handoffs),
        "kv_handoff_bytes_total": sum(h["bytes"] for h in handoffs),
        "edge_kinds": sorted({h["edge_kind"] for h in handoffs}),
        "pickle_fallbacks": sum(1 for h in handoffs
                                if h["n_arrays"] < 2),
    }


def run_multi_proxy(device=None) -> dict:
    """The full PR-19 data-plane leg: sharded-ingress fan-out (with the
    chaos drill) inside a cluster, then the in-process prefix-reuse and
    disagg comparisons."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    rt.init(num_cpus=4)
    try:
        fanout = run_multi_proxy_fanout()
    finally:
        serve.shutdown()
        rt.shutdown()
    return {"fanout": fanout,
            "prefix": run_prefix_reuse(device=device),
            "disagg": run_disagg(device=device)}


def _serve_metric_totals() -> dict:
    """Cluster-wide serve counters from the GCS metrics store (proves
    the Prometheus family is emitting: rayt_serve_{shed,admitted}_total
    + the autoscale decision gauge)."""
    out: dict = {}
    try:
        from ray_tpu_torch.core.object_ref import get_core_worker

        cw = get_core_worker()
        snap = cw.io.run(cw.gcs.conn.call("metrics_snapshot"))
        for rec in snap:
            name = rec.get("name", "")
            if name in ("rayt_serve_shed_total",
                        "rayt_serve_admitted_total"):
                out[name] = out.get(name, 0.0) + float(
                    rec.get("value", 0.0))
            elif name == "rayt_serve_autoscale_decision":
                out[name] = float(rec.get("value", 0.0))
    except Exception:
        pass
    return out


def main(argv=None):
    import argparse

    from ray_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.tools.serve_bench",
        description="The serve benchmarks of ray_tpu_torch.serve; prints "
                    "one JSON line.")
    ap.add_argument("--leg",
                    choices=("engine", "sustained", "latency",
                             "multi_proxy", "all"),
                    default="all")
    ap.add_argument("--preset", default="debug")
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--steady-s", type=float, default=30.0)
    ap.add_argument("--burst-s", type=float, default=10.0)
    ap.add_argument("--device", default=None,
                    help="the engines' device: the CUDA card by default "
                         "(raises without one); cpu on purpose")
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    out: dict = {"device": device.type}
    if args.leg in ("engine", "all"):
        out["engine"] = asyncio.run(_run_bench(
            args.preset, args.concurrency, args.requests, args.max_new,
            args.prompt_len, device=device))
    if args.leg in ("sustained", "all"):
        import ray_tpu_torch as rt
        from ray_tpu_torch import serve

        rt.init(num_cpus=4)
        try:
            out["sustained_load"] = run_sustained(
                steady_s=args.steady_s, burst_s=args.burst_s)
        finally:
            serve.shutdown()
            rt.shutdown()
    if args.leg in ("latency", "all"):
        import ray_tpu_torch as rt
        from ray_tpu_torch import serve

        rt.init(num_cpus=4)
        try:
            out["request_latency"] = run_latency()
        finally:
            serve.shutdown()
            rt.shutdown()
    if args.leg in ("multi_proxy", "all"):
        out["multi_proxy"] = run_multi_proxy(device=device)
    out["captured_at"] = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                       time.gmtime())
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
