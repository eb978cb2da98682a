"""Disaggregated prefill/decode serving in the port (ray_tpu_torch.serve.llm:
PrefillWorker, DecodeLlamaService, disagg_llm_app) against the JAX
package's.

``disagg_llm_app("debug", device="cpu", params=<the JAX engine's weights as
numpy>)`` is served in f32 on a local cluster (chip_smoke.served wraps both
deployments' callables, so each replica builds its engine in f32 in its own
process) with greedy decoding. Its streams through the handle equal the
JAX package's disaggregated pair on the same weights, and the port's
``llm_app``, token for token: for a short prompt, a prompt past one prefill
chunk, and three at once. The JAX package's pair runs in this process: its
PrefillWorker and DecodeLlamaService classes, the decode side's prefill
handle answered on the same event loop (the same calls its Serve replica
makes, without the JAX package's cluster).

The handoff summary (bytes, bucket, start, arrays) of the served prefill
pool equals the JAX package's PrefillWorker's on the same prompt, its KV
rows agree, and the edge kind is "shm" between processes and "device" over
an in-process DeviceChannel.
"""

import asyncio
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from chip_smoke import _stream_all, f32_presets, handle_submit, served
from ray_tpu.dag import channel as jchannel
from ray_tpu.dag import device_channel as jdevice
from ray_tpu.models import llama as jllama
from ray_tpu.serve import llm as jllm
from ray_tpu_torch import serve
from ray_tpu_torch.dag.channel import ShmChannel
from ray_tpu_torch.dag.device_channel import (DeviceChannel, DeviceChannelSpec,
                                              DeviceTransportChannel,
                                              attach_device)
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve.handle import DeploymentHandle

ENGINE = dict(max_batch=4, max_seq_len=1024, prompt_buckets=(32, 512),
              prefill_chunk=64)
_rng = np.random.default_rng(0)
# case -> [(prompt, new tokens)], sent at once
REQUESTS = {
    "short_prompt": [([5, 9, 11, 42, 7], 8)],
    "past_one_chunk": [([1 + i % 255 for i in range(100)], 6)],
    "three_at_once": [(_rng.integers(1, 256, n).tolist(), 5)
                      for n in (3, 40, 90)],
}
HANDOFF_PROMPT = [2 + i % 200 for i in range(70)]


@functools.lru_cache(maxsize=1)
def _params_np():
    cfg = jllama.config_for("debug", dtype=jnp.float32)
    return jax.tree.map(np.asarray, jllama.init_params(cfg,
                                                       jax.random.PRNGKey(0)))


@contextlib.contextmanager
def _jax_f32():
    """The JAX package's llama.config_for returning float32 (the debug
    preset in f32), while engines are built."""
    config_for = jllm.llama.config_for
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jllm.llama, "config_for", lambda name, **kw: config_for(
            name, **{"dtype": jnp.float32, **kw}))
        yield


class _PrefillHandle:
    """The decode side's prefill handle, in process: ``.remote(req)`` runs
    the prefill worker on the event loop the decode side runs on and
    returns a future with ``.result(timeout)``, as a DeploymentHandle's
    response has."""

    def __init__(self, worker, loop):
        self.worker, self.loop = worker, loop

    def options(self, **_):
        return self

    def remote(self, req):
        return asyncio.run_coroutine_threadsafe(self.worker(req), self.loop)


@functools.lru_cache(maxsize=None)
def _jax_disagg(case: str) -> list:
    """The JAX package's PrefillWorker + DecodeLlamaService in f32 on the
    case's requests, at once."""
    with _jax_f32():
        prefill = jllm.PrefillWorker("debug", tp=1, params=_params_np(),
                                     **ENGINE)

        async def run():
            decode = jllm.DecodeLlamaService(
                _PrefillHandle(prefill, asyncio.get_running_loop()),
                "debug", tp=1, params=_params_np(), **ENGINE)

            async def one(prompt, new):
                return [d["token"] async for d in decode(
                    {"tokens": prompt, "max_new_tokens": new})]
            return await asyncio.gather(*[one(p, n)
                                          for p, n in REQUESTS[case]])
        return asyncio.run(run())


def _jax_handoff() -> tuple[dict, dict]:
    """The JAX package's PrefillWorker on HANDOFF_PROMPT: its summary and
    the KV rows read off the ring, as numpy."""
    with _jax_f32():
        worker = jllm.PrefillWorker("debug", tp=1, params=_params_np(),
                                    **ENGINE)
    ring = jchannel.ShmChannel.create(slot_size=16 << 20, n_slots=2)
    spec = jdevice.DeviceChannelSpec(name=ring.spec.name, inner=ring.spec)
    ch = jdevice.DeviceTransportChannel(ring, spec)
    try:
        summary = asyncio.run(worker({"tokens": HANDOFF_PROMPT,
                                      "chan": spec}))
        tick = ch.read(timeout=30)
    finally:
        ch.close()
    return summary, {k: np.asarray(tick[k]) for k in ("k", "v")}


def _streams(submit, case: str) -> list:
    return asyncio.run(_stream_all(submit, REQUESTS[case]))["streams"]


@pytest.fixture(scope="module")
def apps():
    """disagg_llm_app and llm_app at the debug preset on the CPU, every
    engine in f32."""
    rt.init(num_cpus=4)
    serve.start(http_port=0)
    try:
        app = tllm.disagg_llm_app("debug", device="cpu", params=_params_np(),
                                  **ENGINE)
        for node in app.walk():
            node.deployment.func_or_class = served(
                node.deployment.func_or_class, f32=True)
        disagg = serve.run(app, name="disagg")
        single = tllm.llm_app("debug", device="cpu", params=_params_np(),
                              **ENGINE)
        single.deployment.func_or_class = served(tllm.LlamaService, f32=True)
        llm = serve.run(single, name="llm")
        prefill = DeploymentHandle("PrefillWorker", "disagg")
        for handle in (disagg, llm, prefill):
            probe = handle.options(method_name="probe").remote().result(
                timeout=120)
            assert probe["dtype"] == "torch.float32" and not probe["cuda"]
        yield disagg, llm, prefill
    finally:
        serve.shutdown()
        rt.shutdown()


@pytest.mark.parametrize("case", sorted(REQUESTS))
def test_disagg_app_streams_match_jax_and_llm_app(apps, case):
    disagg, llm, _ = apps
    got = _streams(handle_submit(disagg), case)
    assert [len(s) for s in got] == [n for _, n in REQUESTS[case]]
    assert got == _jax_disagg(case)
    assert got == _streams(handle_submit(llm), case)


def test_disagg_app_moves_each_request_over_a_handoff(apps):
    """The decode pool ran no prefill: it admitted every request from a
    KV handoff."""
    disagg, _, _ = apps
    before = disagg.options(method_name="stats").remote().result(timeout=30)
    _streams(handle_submit(disagg), "three_at_once")
    after = disagg.options(method_name="stats").remote().result(timeout=30)
    assert after["prefills"] == before["prefills"] == 0
    assert after["kv_handoffs"] - before["kv_handoffs"] == 3


def test_decode_pool_times_each_handoff_it_reads(apps):
    """The decode pool's stats count the handoffs it read: three over
    "shm", each the f32 KV rows of its prompt's bucket (32, 512, 512),
    with time spent in the call and in the read, rows on the engine's
    device, and the ring's slot sized for the largest bucket."""
    disagg, _, _ = apps

    def stats():
        return disagg.options(method_name="stats").remote().result(
            timeout=30)

    before = stats()
    _streams(handle_submit(disagg), "three_at_once")
    after = stats()
    cfg = tllm.llama.config_for("debug")
    rows = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 4
    assert after["handoff_reads"] - before["handoff_reads"] == 3
    assert (after["handoff_bytes"] - before["handoff_bytes"]
            == rows * (32 + 512 + 512))
    assert (after["handoff_edges"]["shm"]
            - before["handoff_edges"].get("shm", 0)) == 3
    assert (after["handoff_on_engine_device"]
            - before["handoff_on_engine_device"]) == 3
    assert after["handoff_call_s"] > before["handoff_call_s"]
    assert after["handoff_read_s"] > before["handoff_read_s"]
    kv = rows * 512
    assert after["handoff_slot_bytes"] == kv + kv // 4 + (1 << 16)


def test_handoff_summary_matches_jax_between_processes(apps):
    """The served prefill pool fills a ring this process owns: the
    summary's bytes, bucket, start and array count equal the JAX
    package's PrefillWorker's, the edge is "shm", and the KV rows read
    off the ring (tensors rebuilt here) agree with the JAX package's in
    f32 to 1e-4."""
    _, _, prefill = apps
    ring = ShmChannel.create(slot_size=16 << 20, n_slots=2)
    spec = DeviceChannelSpec(name=ring.spec.name, inner=ring.spec)
    ch = DeviceTransportChannel(ring, spec)
    try:
        summary = prefill.remote({"tokens": HANDOFF_PROMPT,
                                  "chan": spec}).result(timeout=120)
        tick = ch.read(timeout=30)
    finally:
        ch.close()
    want, rows = _jax_handoff()
    assert summary["edge_kind"] == want["edge_kind"] == "shm"
    for key in ("bytes", "bucket", "start", "n_arrays"):
        assert summary[key] == want[key], key
    assert summary["bucket"] == 512 and summary["n_arrays"] == 2
    for key in ("k", "v"):
        assert isinstance(tick[key], torch.Tensor)
        assert tick[key].dtype == torch.float32
        np.testing.assert_allclose(tick[key].numpy(), rows[key],
                                   rtol=1e-4, atol=1e-4)


def test_handoff_in_process_is_a_device_edge():
    """A PrefillWorker writing into a DeviceChannel of its own process
    hands the KV tensors over as objects: edge kind "device"."""
    with f32_presets(tllm.llama):
        worker = tllm.PrefillWorker("debug", device="cpu",
                                    params=_params_np(), **ENGINE)
    ch = DeviceChannel.create(n_slots=2)
    peer = attach_device(ch.spec)
    try:
        summary = asyncio.run(worker({"tokens": [5, 9, 11],
                                      "chan": ch.spec}))
        tick = peer.read(timeout=30)
    finally:
        peer.close()
    assert summary["edge_kind"] == "device" and summary["bucket"] == 32
    assert tllm._edge_kind(ch, ch.spec) == "device"
    assert summary["bytes"] == tick["k"].nbytes + tick["v"].nbytes
    assert tick["k"].dtype == torch.float32
