"""KV handoff from and to tensor-parallel engines, and several such engines
in one process, on gloo CPU ranks.

Each port engine at ``tp=2`` owns a process group of its own (rank 0 in
this test's process, one follower process), so two of them, a ``tp=1``
engine and a training mesh on the default group live here at once. A
handoff payload carries every kv head in the tp=1 layout: tp=2 -> tp=2,
tp=2 -> tp=1 and tp=1 -> tp=2 give the JAX package's
``prefill_only`` + ``generate_prefilled`` greedy streams of
``LLMEngine("debug", tp=2)`` (a 2-device mesh of the 8 virtual CPU devices)
on the same numpy weights, token for token, in f32. ``disagg_llm_app(tp=2)``
served from CPU replicas streams what the JAX package's disaggregated pair
at tp=2 streams.
"""

import asyncio
import contextlib
import functools
import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from chip_smoke import _stream_all, collect, handle_submit, served
from ray_tpu.serve import llm as jllm
from ray_tpu_torch import serve
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve.llm_tp import FollowerDied
from test_torch_serve_disagg import _PrefillHandle
from test_torch_serve_llm import _agen_list, _params_np

ENGINE = dict(max_batch=4, max_seq_len=256, prompt_buckets=(32, 128),
              prefill_chunk=64)
# (prompt, new tokens): one bucket of 32, and one prefilled in two chunks
REQUESTS = [([5, 9, 11, 42, 7], 8), ([1 + i % 251 for i in range(100)], 6)]
ROUTES = {"tp2_to_tp2": ("tp2", "tp2_b"), "tp2_to_tp1": ("tp2", "tp1"),
          "tp1_to_tp2": ("tp1", "tp2")}


@contextlib.contextmanager
def _f32():
    """Both packages' llama.config_for returning float32 while engines are
    built (rank 0 hands its config to its follower, which runs f32 too)."""
    jcfg, tcfg = jllm.llama.config_for, tllm.llama.config_for
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jllm.llama, "config_for", lambda name, **kw: jcfg(
            name, **{"dtype": jnp.float32, **kw}))
        mp.setattr(tllm.llama, "config_for", lambda name, **kw: tcfg(
            name, **{"dtype": torch.float32, **kw}))
        yield


def _engine(tp: int, **kw):
    with _f32():
        return tllm.LLMEngine("debug", tp=tp, device="cpu",
                              params=_params_np(), **{**ENGINE, **kw})


@pytest.fixture(scope="module")
def engines():
    """Two tp=2 engines and a tp=1 engine, alive together."""
    made = {}
    try:
        for name, tp in (("tp2", 2), ("tp2_b", 2), ("tp1", 1)):
            made[name] = _engine(tp)
        yield made
    finally:
        for eng in made.values():
            eng.shutdown()


async def _handoff(src, dst, prompt, new):
    payload = await src.prefill_only(prompt)
    return await _agen_list(dst.generate_prefilled(prompt, payload,
                                                   max_new_tokens=new))


def _handoff_streams(src, dst) -> list:
    async def run():
        return [await _handoff(src, dst, p, n) for p, n in REQUESTS]
    return asyncio.run(run())


@functools.lru_cache(maxsize=1)
def _jax_streams() -> list:
    """The JAX package's tp=2 prefill_only -> tp=2 generate_prefilled."""
    with _f32():
        src = jllm.LLMEngine("debug", tp=2, params=_params_np(), **ENGINE)
        dst = jllm.LLMEngine("debug", tp=2, params=_params_np(), **ENGINE)
    return _handoff_streams(src, dst)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_handoff_gives_the_reference_streams(engines, route):
    src, dst = (engines[n] for n in ROUTES[route])
    handoffs, prefills = dst.kv_handoffs, dst.prefills
    got = _handoff_streams(src, dst)
    assert [len(s) for s in got] == [n for _, n in REQUESTS]
    assert got == _jax_streams()
    assert dst.kv_handoffs - handoffs == len(REQUESTS)
    assert dst.prefills == prefills      # the decoding side ran no prompt


def test_tp2_payload_holds_every_head_as_tp1s(engines):
    """The tp=2 engine's payload is the tp=1 engine's: every kv head in the
    tp=1 layout, to 1e-5, while each of its ranks caches half the heads."""
    prompt = REQUESTS[1][0]
    cfg = engines["tp1"].cfg

    async def payloads():
        return (await engines["tp2"].prefill_only(prompt),
                await engines["tp1"].prefill_only(prompt))

    got, want = asyncio.run(payloads())
    for key in ("first", "bucket", "start"):
        assert got[key] == want[key], key
    for key in ("k", "v"):
        assert got[key].shape == want[key].shape
        assert got[key].shape[3] == cfg.n_kv_heads
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert engines["tp2"]._decode_cache["k"].shape[3] == cfg.n_kv_heads // 2


def test_a_payload_of_another_model_is_refused(engines):
    payload = asyncio.run(engines["tp1"].prefill_only([1, 2, 3]))
    half = {**payload, "k": payload["k"][..., :1, :],
            "v": payload["v"][..., :1, :]}
    with pytest.raises(ValueError, match="kv heads"):
        asyncio.run(_agen_list(engines["tp2"].generate_prefilled(
            [1, 2, 3], half, max_new_tokens=2)))


def test_shutdown_of_one_leaves_the_others_serving(engines):
    """A third tp=2 engine comes and goes; the fixture's engines go on
    serving the same streams, and the default process group was never
    started."""
    prompt, new = REQUESTS[0]
    want = collect(engines["tp2"], prompt, max_new_tokens=new)
    extra = _engine(2)
    try:
        assert collect(extra, prompt, max_new_tokens=new) == want
    finally:
        extra.shutdown()
    assert collect(engines["tp2"], prompt, max_new_tokens=new) == want
    assert collect(engines["tp2_b"], prompt, max_new_tokens=new) == want
    assert not torch.distributed.is_initialized()


def test_an_engine_beside_a_training_mesh(engines):
    """A training mesh on the default process group and a tp=2 engine in
    one process: each runs its own collectives."""
    prompt, new = REQUESTS[0]
    want = collect(engines["tp1"], prompt, max_new_tokens=new)
    tmesh.init_process_group(1, 0, tmesh.free_address(), device="cpu")
    try:
        mesh = tmesh.build_mesh({"data": -1}, "cpu")
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 1}
        x = torch.ones(3)
        torch.distributed.all_reduce(x)
        assert collect(engines["tp2"], prompt, max_new_tokens=new) == want
        assert x.tolist() == [1.0, 1.0, 1.0]
    finally:
        torch.distributed.destroy_process_group()


def test_dead_follower_fails_only_its_engine(engines):
    """A follower killed under one engine fails that engine's requests with
    an error naming it; the other tp=2 engine serves on."""
    prompt, new = REQUESTS[0]
    want = collect(engines["tp2_b"], prompt, max_new_tokens=new)
    doomed = _engine(2)
    try:
        (pid,) = doomed._tp.pids()
        assert collect(doomed, prompt, max_new_tokens=new) == want
        os.kill(pid, signal.SIGKILL)
        with pytest.raises(FollowerDied, match=f"rank 1 \\(pid {pid}\\)"):
            collect(doomed, prompt, max_new_tokens=new)
        with pytest.raises(FollowerDied, match="rank 1"):
            asyncio.run(doomed.prefill_only(prompt))
        assert collect(engines["tp2_b"], prompt, max_new_tokens=new) == want
    finally:
        doomed.shutdown()


@functools.lru_cache(maxsize=1)
def _jax_disagg() -> list:
    """The JAX package's PrefillWorker + DecodeLlamaService at tp=2, in
    f32, on REQUESTS at once."""
    with _f32():
        prefill = jllm.PrefillWorker("debug", tp=2, params=_params_np(),
                                     **ENGINE)

        async def run():
            decode = jllm.DecodeLlamaService(
                _PrefillHandle(prefill, asyncio.get_running_loop()),
                "debug", tp=2, params=_params_np(), **ENGINE)

            async def one(prompt, new):
                return [d["token"] async for d in decode(
                    {"tokens": prompt, "max_new_tokens": new})]
            return await asyncio.gather(*[one(p, n) for p, n in REQUESTS])
        return asyncio.run(run())


def test_disagg_llm_app_tp2_serves_from_replicas():
    """disagg_llm_app("debug", tp=2, device="cpu"): each pool's replica
    hosts a tp=2 engine (rank 0 there, its follower started from the
    replica's process); every request's rows cross as a full-head payload,
    and the streams equal the JAX package's disaggregated pair at tp=2."""
    rt.init(num_cpus=4)
    try:
        app = tllm.disagg_llm_app("debug", tp=2, device="cpu",
                                  params=_params_np(), **ENGINE)
        for node in app.walk():
            node.deployment.func_or_class = served(
                node.deployment.func_or_class, f32=True)
            assert node.deployment.ray_actor_options in (None, {})
        h = serve.run(app, name="disagg_tp2")
        got = asyncio.run(_stream_all(handle_submit(h), REQUESTS))["streams"]
        stats = h.options(method_name="stats").remote().result(timeout=60)
    finally:
        serve.shutdown()
        rt.shutdown()
    assert stats["tp"] == 2 and stats["prefills"] == 0
    assert stats["kv_handoffs"] == len(REQUESTS)
    assert got == _jax_disagg()


def test_disagg_llm_app_tp_leases_its_cards():
    """On the card each replica of both pools leases tp GPUs."""
    app = tllm.disagg_llm_app("debug", tp=2)
    assert [n.deployment.ray_actor_options for n in app.walk()] == \
        [{"num_gpus": 2}] * 2
