"""The serving driver: the port's ``LLMEngine`` in this process, fed by a
closed or an open loop of requests from ``traffic.py``, measured at the
consumer, and checked against the plain reference.

* Closed loop: ``max_batch + queued_beyond_slots`` clients, each sending
  its next request when its last finishes. The window opens once the first
  ``max_batch`` requests all decode (their first tokens are out).
* Open loop: arrivals at their due times whether or not earlier requests
  finished; the window opens ``lead_in_s`` after the first arrival. A
  request is timed from when it was due, and the generator's lateness is
  kept.

Each request runs under a request-observation dict (the port's
``serve.request_context``), which the engine stamps with its queue and
prefill times. After the window (and, with a trace, a traced slice under
the same load), the loop's tasks are cancelled, the peak memory is read,
the engine is dropped, and the reference judges a sample of the finished
requests.
"""

from __future__ import annotations

import asyncio
import gc
import random
import time

import torch

from benchmark import model, reference, traffic
from benchmark.trace import Trace

TRACE_SLICE_S = 3.0
WAIT_AFTER_CLOSE_S = 60.0
ENGINE_PRESET = "bench:{}"


def build_engine(conf_name: str, conf: dict, params: dict, device):
    """The port's engine over this configuration. ``LLMEngine`` takes a
    preset name, so the configuration's sizes are entered into the port's
    preset table under a name of the benchmark's own (nothing of the port is
    edited: the table is a dict it reads at construction)."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LLMEngine

    name = ENGINE_PRESET.format(conf_name)
    llama.PRESETS[name] = model.llama_kwargs(conf)
    eng = conf["assumed"]["engine"]
    return LLMEngine(name, tp=eng["tp"], max_batch=eng["max_batch"],
                     prompt_buckets=tuple(eng["prompt_buckets"]),
                     prefill_chunk=eng["prefill_chunk"],
                     prefix_cache_entries=eng["prefix_cache_entries"],
                     eos_token_id=eng["eos"], params=params, seed=0,
                     device=device)


def _bucket(n: int, buckets) -> int:
    return next(b for b in buckets if n <= b)


class _Client:
    """Sends requests to the engine and keeps what each one saw."""

    def __init__(self, engine, temperature: float):
        self.engine = engine
        self.temperature = temperature
        self.records: list[dict] = []

    async def send(self, req: traffic.Request, due: float) -> dict:
        from ray_tpu_torch.serve import request_context as rc

        rec = {"index": req.index, "prompt": req.prompt,
               "answer": req.answer, "due": due,
               "sent": time.perf_counter(), "t": [], "ids": [],
               "error": None, "obs": {}, "done": False}
        self.records.append(rec)
        token = rc._set_request_obs(rec["obs"])
        try:
            async for tok in self.engine.generate(
                    req.prompt, max_new_tokens=req.answer,
                    temperature=self.temperature):
                rec["t"].append(time.perf_counter())
                rec["ids"].append(int(tok))
            rec["done"] = len(rec["ids"]) == req.answer
            if not rec["done"]:
                rec["error"] = (f"{len(rec['ids'])} of {req.answer} tokens")
        except Exception as e:         # a failed request is counted, not fatal
            rec["error"] = repr(e)
        finally:
            rc._reset_request_obs(token)
        return rec


async def _warm_up(engine, mix: dict, requests: list, temperature: float,
                   vocab: int, seed: int):
    """One request alone per prompt bucket that the traffic uses, each long
    enough to fill its bucket, with two tokens out: every prefill and
    chunk shape, the insert and the decode step run once."""
    rng = random.Random(seed ^ 0xA11CE)
    buckets = sorted({_bucket(len(r.prompt), engine.prompt_buckets)
                      for r in requests})
    for b in buckets:
        prompt = [rng.randrange(vocab) for _ in range(b)]
        async for _ in engine.generate(prompt, max_new_tokens=2,
                                       temperature=temperature):
            pass


async def _closed_loop(engine, client, mix, requests, seconds, tr):
    max_batch = engine.max_batch
    pending = iter(requests)
    state = {"closing": False}

    async def worker():
        while not state["closing"]:
            req = next(pending, None)
            if req is None:
                raise RuntimeError("the closed loop ran out of requests; "
                                   "raise the mix's pool")
            await client.send(req, time.perf_counter())

    workers = [asyncio.ensure_future(worker())
               for _ in range(max_batch + mix["queued_beyond_slots"])]
    # the window opens once the first max_batch requests all decode
    while sum(1 for r in client.records if r["t"]) < max_batch:
        await asyncio.sleep(0.01)
        for w in workers:
            if w.done():
                w.result()
    t_open = time.perf_counter()
    stats_open = engine.stats()
    await asyncio.sleep(seconds)
    t_close = time.perf_counter()
    stats_close = engine.stats()
    if tr.on:
        with tr:
            with tr.slice():
                await asyncio.sleep(TRACE_SLICE_S)
    # the requests in flight at the close finish under the same load, a
    # minute at most, until the check has a sample to draw
    check, deadline = mix["check"], t_close + WAIT_AFTER_CLOSE_S
    while time.perf_counter() < deadline:
        done = [r for r in client.records if r["done"]]
        if (len(done) >= check["min_requests"]
                and sum(len(r["ids"]) for r in done)
                >= check["min_served_tokens"]):
            break
        await asyncio.sleep(0.05)
    state["closing"] = True
    for w in workers:
        if w.done() and w.exception() is not None:
            raise w.exception()
        w.cancel()
    return t_open, t_close, stats_close, {"stats_open": stats_open,
                                          "late_s": []}


async def _open_loop(engine, client, mix, requests, seconds, tr):
    t_start = time.perf_counter() + 0.05
    t_open = t_start + mix["lead_in_s"]
    t_close = t_open + seconds
    stop_at = t_close + (TRACE_SLICE_S + 1.0 if tr.on else 0.0)
    late, tasks = [], []

    async def generator():
        for req in requests:
            due = t_start + req.due
            if due >= stop_at:
                return
            await asyncio.sleep(max(0.0, due - time.perf_counter()))
            if t_open <= due < t_close:
                late.append(time.perf_counter() - due)
            tasks.append(asyncio.ensure_future(client.send(req, due)))

    gen = asyncio.ensure_future(generator())
    await asyncio.sleep(max(0.0, t_open - time.perf_counter()))
    stats_open = engine.stats()
    await asyncio.sleep(max(0.0, t_close - time.perf_counter()))
    stats_close = engine.stats()
    if tr.on:
        with tr:
            with tr.slice():
                await asyncio.sleep(TRACE_SLICE_S)
    # every request due in the window is waited for, a minute at most
    deadline = t_close + WAIT_AFTER_CLOSE_S
    while time.perf_counter() < deadline:
        due_in = [r for r in client.records if t_open <= r["due"] < t_close]
        if all(r["done"] or r["error"] for r in due_in):
            break
        await asyncio.sleep(0.05)
    gen.cancel()
    for t in tasks:
        t.cancel()
    return t_open, t_close, stats_close, {"stats_open": stats_open,
                                          "late_s": late}


def run(conf_name: str, conf: dict, mix: dict, seed: int, seconds: float,
        trace_on: bool, device, t_start: float, control: bool = False
        ) -> dict:
    """One run of a serving cell. Returns the readers' context. With
    ``control``, the checks also hold the control's reading (the fp8
    reference in the program's place, on the same sample)."""
    d = model.dims(conf)
    params = model.make_params(d, seed, torch.bfloat16, device)
    engine = build_engine(conf_name, conf, params, device)
    temperature = float(mix["temperature"])
    if mix["loop"] == "closed":
        requests = traffic.serve_requests(mix, seed, mix["pool"], d.vocab)
    else:       # one schedule, traced or not: the slice runs past close
        n = traffic.open_loop_count(mix, seconds + TRACE_SLICE_S + 1.0)
        requests = traffic.serve_requests(mix, seed, n, d.vocab)
    client = _Client(engine, temperature)
    tr = Trace(trace_on)

    async def main():
        await _warm_up(engine, mix, requests, temperature, d.vocab, seed)
        loop_fn = _closed_loop if mix["loop"] == "closed" else _open_loop
        return await loop_fn(engine, client, mix, requests, seconds, tr)

    t_open, t_close, stats_close, extra = asyncio.run(main())
    if device.type == "cuda":
        torch.cuda.synchronize()
    memory_peak = (torch.cuda.max_memory_allocated()
                   if device.type == "cuda" else 0)
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    records = client.records
    checks = judge(params, d, mix, records, seed, control)
    return {"kind": "serve", "dims": d, "mix": mix, "conf": conf,
            "records": records, "t_open": t_open, "t_close": t_close,
            "window_s": t_close - t_open, "setup_s": t_open - t_start,
            "stats_open": extra["stats_open"], "stats_close": stats_close,
            "late_s": extra["late_s"],
            "max_batch": conf["assumed"]["engine"]["max_batch"],
            "memory_peak_bytes": memory_peak, "trace": tr.summary,
            "checks": checks}


def sample_finished(records: list, check: dict, seed: int) -> list:
    """A sample of the finished requests, drawn from the seed, with the
    longest answer in it: at least ``min_requests`` and
    ``min_served_tokens``, at most ``max_requests``."""
    done = sorted((r for r in records if r["done"]),
                  key=lambda r: r["index"])
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r["ids"]), -r["index"]))
    rest = [r for r in done if r is not longest]
    random.Random(seed ^ 0xC0FFEE).shuffle(rest)
    out = [longest]
    for r in rest:
        if (len(out) >= check["min_requests"]
                and sum(len(x["ids"]) for x in out)
                >= check["min_served_tokens"]):
            break
        if len(out) >= check["max_requests"]:
            break
        out.append(r)
    return out


def logit_gaps(params, d, sample: list, quant: str | None = None):
    """Per request, the gaps by which each served token's reference logit
    lies below the reference's best at its position; with ``quant``, also
    the gaps of the tokens the quantized reference puts first."""
    seqs = [r["prompt"] + r["ids"][:-1] for r in sample]
    first = [len(r["prompt"]) - 1 for r in sample]
    ref = reference.answer_logits(params, d, seqs, first)
    served = []
    for r, lg in zip(sample, ref):
        ids = torch.tensor(r["ids"], device=lg.device)
        served.append((lg.max(-1).values - lg.gather(-1, ids[:, None])[:, 0]))
    ctrl = None
    if quant is not None:
        low = reference.answer_logits(params, d, seqs, first, quant=quant)
        ctrl = []
        for lg, lq in zip(ref, low):
            top = lq.argmax(-1)
            ctrl.append(lg.max(-1).values - lg.gather(-1, top[:, None])[:, 0])
    return served, ctrl


def judge(params, d, mix, records, seed: int, control: bool = False
          ) -> dict:
    """The readings that decide ``correct``: the widest logit gap of the
    served tokens of a seeded sample of finished requests. ``problems``
    lists what fails a run whatever the limits."""
    failed = [r["error"] for r in records if r["error"]]
    problems = ([f"{len(failed)} requests failed, first: {failed[0]}"]
                if failed else [])
    sample = sample_finished(records, mix["check"], seed)
    if not sample:
        return {"readings": {}, "problems": problems + [
            "no request finished"], "info": {}}
    served, ctrl = logit_gaps(params, d, sample, "fp8" if control else None)
    readings = {"max_logit_gap": max(float(g.max()) for g in served)}
    if control:
        readings["control.max_logit_gap"] = max(float(g.max()) for g in ctrl)
    return {"readings": readings, "problems": problems,
            "info": {"requests_checked": len(sample),
                     "served_tokens_checked": sum(len(r["ids"])
                                                  for r in sample)}}
