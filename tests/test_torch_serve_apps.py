"""The port's LLM apps behind its Serve plane (ray_tpu_torch.serve: the
controller, a replica, the router and the HTTP proxy on a local cluster)
against the JAX package's engine.

``llm_app("debug", device="cpu", params=<the JAX engine's weights as
numpy>)`` is served in f32: chip_smoke.served wraps the app's callable so
that the replica builds its engine with ``llama.config_for`` returning
float32, in the replica's own process (the wrap the `f32` fixture of
tests/test_torch_serve_llm.py applies in process). Its greedy streams
through the handle equal ``ray_tpu``'s in-process ``LLMEngine("debug",
tp=1)`` streams on the same weights, token for token, and the same requests
over HTTP server-sent events equal the handle's. ``lora_llm_app`` is held
as the reference's tests/test_serve_llm.py holds it: adapter tags, a
deterministic repeat, and the LRU's residents before and after a third
adapter."""

import asyncio
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu_torch as rt
from chip_smoke import handle_submit, http_submit, served, sse_events
from chip_smoke import _stream_all
from ray_tpu.models import llama as jllama
from ray_tpu.serve import llm as jllm
from ray_tpu_torch import serve
from ray_tpu_torch.serve.llm import (LlamaService, MultiplexedLoraService,
                                     llm_app, lora_llm_app)
from ray_tpu_torch.serve.replica import ReplicaActor

# one engine for every case: prompts up to the 512 bucket, prefilled in
# chunks of 64 tokens
ENGINE = dict(max_batch=4, max_seq_len=1024, prompt_buckets=(32, 512),
              prefill_chunk=64)
_rng = np.random.default_rng(0)
# case -> [(prompt, new tokens)], sent at once
REQUESTS = {
    "one_prompt": [([5, 9, 11, 42, 7], 8)],
    "three_concurrent": [(_rng.integers(1, 256, n).tolist(), 6)
                         for n in (3, 11, 25)],
    "long_chunked_prompt": [([1 + i % 255 for i in range(300)], 5)],
}


@functools.lru_cache(maxsize=1)
def _params_np():
    cfg = jllama.config_for("debug", dtype=jnp.float32)
    return jax.tree.map(np.asarray, jllama.init_params(cfg,
                                                       jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _jax_streams(case: str) -> list:
    """The JAX package's engine in f32 on the case's requests, at once."""
    config_for = jllm.llama.config_for
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jllm.llama, "config_for", lambda name, **kw: config_for(
            name, **{"dtype": jnp.float32, **kw}))
        eng = jllm.LLMEngine("debug", tp=1, params=_params_np(), **ENGINE)

        async def run():
            async def one(prompt, new):
                return [t async for t in eng.generate(
                    prompt, max_new_tokens=new)]
            return await asyncio.gather(*[one(p, n)
                                          for p, n in REQUESTS[case]])
        return asyncio.run(run())


def _streams(submit, case: str) -> list:
    return asyncio.run(_stream_all(submit, REQUESTS[case]))["streams"]


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, resources={"GPU": 1})
    port = serve.start(http_port=0)
    yield port
    serve.shutdown()
    rt.shutdown()


@pytest.fixture(scope="module")
def llm(cluster):
    """llm_app at the debug preset on the CPU, its engine in f32."""
    app = llm_app("debug", device="cpu", params=_params_np(), **ENGINE)
    app.deployment.func_or_class = served(LlamaService, f32=True)
    handle = serve.run(app, name="llm")
    probe = handle.options(method_name="probe").remote().result(timeout=120)
    assert probe["dtype"] == "torch.float32" and not probe["cuda"]
    yield cluster, handle
    serve.delete("llm")


@pytest.mark.parametrize("case", sorted(REQUESTS))
def test_llm_app_handle_streams_match_jax(llm, case):
    _, handle = llm
    got = _streams(handle_submit(handle), case)
    assert [len(s) for s in got] == [n for _, n in REQUESTS[case]]
    assert got == _jax_streams(case)


@pytest.mark.parametrize("case", sorted(REQUESTS))
def test_llm_app_http_sse_streams_match_handle(llm, case):
    port, handle = llm
    via_http = _streams(http_submit(port, "llm"), case)
    assert via_http == _streams(handle_submit(handle), case)
    assert via_http == _jax_streams(case)


def test_replica_reports_the_port_engines_counters(llm):
    """The replica's get_stats reads the hosted LLMEngine's counters by
    duck typing: they equal the engine's own stats."""
    _, handle = llm
    _streams(handle_submit(handle), "long_chunked_prompt")
    handle._refresh(force=True)
    [replica] = handle._replicas
    engine = rt.get(replica.get_stats.remote(), timeout=30)["engine"]
    own = handle.options(method_name="stats").remote().result(timeout=30)
    assert {k: engine[k] for k in ("batches", "prefills", "prefill_chunks")
            } == {k: own[k] for k in ("batches", "prefills",
                                      "prefill_chunks")}
    assert engine["prefills"] >= 1 and engine["prefill_chunks"] >= 5
    assert engine["max_batch"] == ENGINE["max_batch"]


def test_replica_discovers_the_port_engine():
    """The five attributes the replica's engine discovery reads (batches,
    prefills, prefill_chunks, _slots, max_batch) are the port engine's,
    for one engine and for each resident engine of the LoRA service."""
    import cloudpickle

    replica = ReplicaActor("LlamaService", "app",
                           cloudpickle.dumps(LlamaService), ("debug",),
                           {"device": "cpu", "max_batch": 3})
    assert replica._engine_stats() == {
        "batches": 0, "prefills": 0, "prefill_chunks": 0,
        "active_slots": 0, "max_batch": 3}
    mux = ReplicaActor("MultiplexedLoraService", "app",
                       cloudpickle.dumps(MultiplexedLoraService), ("debug",),
                       {"device": "cpu", "max_batch": 2})
    for model_id in ("ad-a", "ad-b"):
        asyncio.run(mux._callable.get_engine(model_id))
    assert mux._engine_stats()["max_batch"] == 4
    assert mux.get_stats()["models"] == ["ad-a", "ad-b"]


def test_gpu_leased_replica_holds_the_gpu_until_deleted(cluster):
    """ray_actor_options reach the replica: {"num_gpus": 1} leases the
    node's GPU while the app lives, and serve.delete returns it."""
    dep = serve.deployment(LlamaService, ray_actor_options={"num_gpus": 1})
    handle = serve.run(dep.bind("debug", device="cpu", max_batch=2),
                       name="leased")
    tokens = [d["token"] for d in handle.options(stream=True).remote(
        {"tokens": [3, 4, 5], "max_new_tokens": 3})]
    assert len(tokens) == 3
    assert rt.available_resources().get("GPU", 0.0) == 0.0
    serve.delete("leased")
    deadline = time.monotonic() + 30
    while rt.available_resources().get("GPU", 0.0) != 1.0:
        assert time.monotonic() < deadline, "the GPU lease was not returned"
        time.sleep(0.1)


def test_multiplexed_lora_service_e2e(cluster):
    """lora_llm_app (tests/test_serve_llm.py's test, with tp=1): adapters
    route by multiplexed model id, stream adapter-tagged tokens, and the
    per-replica LRU bounds residents (a third adapter evicts the LRU
    one); the multiplexing header of an HTTP request routes the same
    way."""
    port = cluster
    app = lora_llm_app("debug", device="cpu", max_batch=2,
                       max_adapters_per_replica=2)
    h = serve.run(app, name="lora")
    try:
        def gen(adapter):
            return list(h.options(
                multiplexed_model_id=adapter, stream=True).remote(
                {"tokens": [4, 8, 15], "max_new_tokens": 4}))

        a = gen("ad-a")
        assert len(a) == 4 and all(d["adapter"] == "ad-a" for d in a)
        b = gen("ad-b")
        assert len(b) == 4 and all(d["adapter"] == "ad-b" for d in b)
        # repeat traffic for one adapter is deterministic (cached engine)
        assert gen("ad-a") == a
        h._refresh(force=True)
        replica = h._replicas[0]
        models = rt.get(replica.get_stats.remote(), timeout=30)["models"]
        assert sorted(models) == ["ad-a", "ad-b"]
        gen("ad-c")
        models = rt.get(replica.get_stats.remote(), timeout=30)["models"]
        assert len(models) == 2 and "ad-c" in models
        via_http = list(sse_events(port, "lora", {
            "tokens": [4, 8, 15], "max_new_tokens": 4}, model_id="ad-a"))
        assert via_http == a
    finally:
        serve.delete("lora")


def test_health_probes_spare_a_replica_still_constructing(cluster, tmp_path):
    """A replica whose constructor outlasts two failed probes (as one
    building the 410m engine on the card can) is not probed, so not
    replaced, until it is up: it is constructed once and serves. Each
    reconcile pass first waits up to 5 s for a constructing replica's
    stats, so two probes fail only past ~12 s of construction; without
    the wait for construction the controller replaces the replica
    every ~6 s and it never comes up."""
    starts = tmp_path / "starts"

    @serve.deployment(health_check_period_s=0.3, health_check_timeout_s=0.3,
                      health_check_failure_threshold=2)
    class SlowStart:
        def __init__(self, path):
            import os
            import time

            with open(path, "a") as f:
                f.write(f"{os.getpid()}\n")
            time.sleep(13.0)

        def __call__(self):
            import os

            return os.getpid()

    handle = serve.run(SlowStart.bind(str(starts)), name="slow")
    pid = handle.remote().result(timeout=60)
    time.sleep(1.0)                  # a few probe periods once it is up
    assert handle.remote().result(timeout=30) == pid
    assert starts.read_text().split() == [str(pid)]
    serve.delete("slow")
