"""The port's LLM engine (ray_tpu_torch.serve.llm) against the JAX package's
(ray_tpu.serve.llm, tp=1 on one virtual CPU device), both built from the
same numpy weights, and mirrors of tests/test_serve_llm.py run on the port.
The engine scenarios come from chip_smoke.serve_scenarios, which also holds
them card vs CPU on the GPU.

Parity runs both engines in f32: the `f32` fixture wraps each package's
`llama.config_for`, as its engine module sees it, with monkeypatch to return
dtype=float32 (no file of ray_tpu/ changes). Tolerance: greedy streams equal
token for token. The bf16 mirror holds the port's engine against its own
unbatched greedy decode_step, also token for token."""

import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.serve import llm as jllm
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import lora as tlora
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve import multiplex
from chip_smoke import collect as _collect
from chip_smoke import lora_numpy, nonzero_adapter, serve_scenarios

SCENARIOS = serve_scenarios()


@pytest.fixture
def f32(monkeypatch):
    jcfg_for, tcfg_for = jllm.llama.config_for, tllm.llama.config_for
    monkeypatch.setattr(jllm.llama, "config_for", lambda name, **kw: jcfg_for(
        name, **{"dtype": jnp.float32, **kw}))
    monkeypatch.setattr(tllm.llama, "config_for", lambda name, **kw: tcfg_for(
        name, **{"dtype": torch.float32, **kw}))


@functools.lru_cache(maxsize=1)
def _params_np():
    cfg = jllama.config_for("debug", dtype=jnp.float32)
    return jax.tree.map(np.asarray, jllama.init_params(cfg,
                                                       jax.random.PRNGKey(0)))


def _jax_engine(**kw):
    return jllm.LLMEngine("debug", tp=1, params=_params_np(), **kw)


def _torch_engine(**kw):
    return tllm.LLMEngine("debug", device="cpu", params=_params_np(), **kw)


async def _agen_list(agen):
    return [t async for t in agen]


def _scenario(name, engine):
    """Run a chip_smoke scenario on engines built by `engine(**kw)`:
    (streams, facts)."""
    kw, run = SCENARIOS[name]
    return run(lambda **o: engine(**{**kw, **o}))


def _concurrent(engine, requests):
    """requests: [(tokens, max_new_tokens)] -> their streams, all sent at
    once."""
    async def run():
        return await asyncio.gather(*[
            _agen_list(engine.generate(t, max_new_tokens=n))
            for t, n in requests])
    return asyncio.run(run())


# ------------------------------------------------- parity with ray_tpu
def test_one_prompt_matches_jax(f32):
    want, _ = _scenario("one_request", _jax_engine)
    got, _ = _scenario("one_request", _torch_engine)
    assert [len(o) for o in got] == [8]
    assert got == want


def test_concurrent_prompts_match_jax(f32):
    want, _ = _scenario("three_concurrent", _jax_engine)
    got, facts = _scenario("three_concurrent", _torch_engine)
    assert [len(o) for o in got] == [6, 6, 6]
    assert got == want
    # continuous batching: the three decode in shared steps (5 each
    # serially would be 15)
    assert facts["prefills"] == 3
    assert facts["batches"] <= 9
    # each stream is deterministic: alone it is the same
    assert facts["alone_equals_batched"]


def test_per_request_lengths_and_eos_match_jax(f32):
    requests = [([1, 2, 3], 2), ([9, 9], 7)]
    full = _concurrent(_jax_engine(max_batch=4), requests)
    assert [len(o) for o in full] == [2, 7]
    eos = full[1][3]                  # stream 1 ends before its 4th token
    want = _concurrent(_jax_engine(max_batch=4, eos_token_id=eos), requests)
    got = _concurrent(_torch_engine(max_batch=4, eos_token_id=eos), requests)
    assert got == want
    for stream, cut in zip(got, full):
        assert stream == (cut[:cut.index(eos)] if eos in cut else cut)


# ------------------------------------- mirrors of tests/test_serve_llm.py
def test_engine_greedy_matches_unbatched_decode():
    """Batched, left-padded generation (bf16, as served) equals a plain
    single-sequence greedy decode_step with the same params."""
    eng = tllm.LLMEngine("debug", max_batch=4, device="cpu")
    cfg = eng.cfg
    assert cfg.dtype == torch.bfloat16
    prompt = [5, 9, 11, 42, 7]
    got = _collect(eng, prompt, max_new_tokens=8)

    cache = tllama.init_kv_cache(cfg, 1, max_len=cfg.max_seq_len,
                                 device="cpu")
    want = []
    with torch.inference_mode():
        logits, cache = tllama.decode_step(eng.params, cache,
                                           torch.tensor([prompt]), cfg)
        for _ in range(8):
            nxt = int(logits[0].argmax())
            want.append(nxt)
            logits, cache = tllama.decode_step(eng.params, cache,
                                               torch.tensor([[nxt]]), cfg)
    assert got == want


def test_late_request_joins_mid_decode():
    """A request arriving while another is mid-generation starts decoding
    within a few steps; it never waits for the first to drain."""
    eng = tllm.LLMEngine("debug", max_batch=4, device="cpu")

    async def run():
        first = asyncio.ensure_future(
            _agen_list(eng.generate([1, 2, 3], max_new_tokens=60)))
        while eng.batches < 5:
            await asyncio.sleep(0.01)
        steps_before = eng.batches
        late = await _agen_list(eng.generate([7, 7], max_new_tokens=3))
        steps_for_late = eng.batches - steps_before
        first_done = first.done()
        return await first, late, steps_for_late, first_done

    out_first, late, steps_for_late, first_done = asyncio.run(run())
    assert len(out_first) == 60
    assert len(late) == 3
    # 3 tokens = 1 prefill token + 2 decode steps
    assert steps_for_late <= 6
    assert not first_done


def test_chunked_prefill_interleaves_with_decode():
    """A 300-token prompt arrives while a short request decodes: its five
    64-token chunks run between decode steps (the reference's test sends
    ids 1..300, past the 256-token vocabulary, which the port refuses; see
    test_invalid_prompts_raise), and a chunked prefill gives the stream a
    monolithic one gives."""
    (first, late, _), facts = _scenario(
        "chunked_long_prompt",
        lambda **kw: tllm.LLMEngine("debug", device="cpu", **kw))
    assert len(first) == 40
    assert len(late) == 3
    # 300 real tokens in a 512 bucket, chunk 64: the 192 leading pad tokens
    # are skipped, leaving ceil(320/64) = 5 chunk rounds
    assert facts["prefill_chunks"] == 5
    assert facts["interleaved"]
    assert facts["chunked_equals_monolithic"]


def test_prefix_hit_grafts_rows_and_keeps_the_cold_stream(f32):
    """A prompt sharing a block-aligned prefix with a finished one grafts the
    stored rows (at its own start offset) and prefills only the tail; the
    stream equals a cold engine's, and the JAX engine's."""
    (cold_first, warm_second), facts = _scenario("prefix_hit", _torch_engine)
    assert facts["misses_after_first"] == 1
    assert facts["entries_after_first"] == 1
    assert facts["hits"] == 1
    assert facts["hit_tokens"] == 32
    assert facts["warm_equals_cold"]
    assert facts["again_equals_first"]
    assert facts["hits_after_again"] == 2
    want, jfacts = _scenario("prefix_hit", _jax_engine)
    assert [cold_first, warm_second] == want
    assert jfacts["hits"] == 1


def test_prefill_only_handoff_equals_generate(f32):
    """prefill_only on one engine, generate_prefilled on another: the same
    stream as generate. The payload aliases nothing a later step writes."""
    (out,), facts = _scenario("prefill_only_handoff", _torch_engine)
    assert facts["payload_keys"] == ["bucket", "first", "k", "start", "v"]
    assert facts["first_streams_first"]
    assert facts["kv_handoffs"] == 1
    # more traffic on both engines, then the payload is unchanged and
    # shares no storage with either decode cache
    assert facts["payload_unchanged"]
    assert not facts["payload_shares_a_cache"]
    assert facts["equals_generate"]
    kw, _ = SCENARIOS["prefill_only_handoff"]
    assert out == _collect(_jax_engine(**kw), list(range(3, 28)),
                           max_new_tokens=8)


def test_failed_step_reseeds_and_recovers(monkeypatch):
    """A decode step that raises fails the active request, re-seeds the
    sampling generator with the reference's counter scheme and resets the
    decode state (_poison_recover); the next request is served."""
    eng = tllm.LLMEngine("debug", max_batch=2, seed=3, device="cpu")
    decode_step = tllm.llama.decode_step
    calls = {"decode": 0}

    def flaky(params, cache, tokens, cfg):
        if tokens.shape[1] == 1:
            calls["decode"] += 1
            if calls["decode"] == 3:
                raise RuntimeError("injected device fault")
        return decode_step(params, cache, tokens, cfg)

    monkeypatch.setattr(tllm.llama, "decode_step", flaky)
    with pytest.raises(RuntimeError, match="decode cache lost"):
        _collect(eng, [1, 2, 3], max_new_tokens=10)
    assert eng._key_reseeds == 1
    assert eng._decode_cache is None
    assert all(s is None for s in eng._slots)
    gen_state = torch.Generator().manual_seed(3 ^ 0x5EED ^ (1 << 16))
    assert torch.equal(eng._gen.get_state(), gen_state.get_state())
    got = _collect(eng, [4, 5, 6], max_new_tokens=5)
    fresh = tllm.LLMEngine("debug", max_batch=2, seed=3, device="cpu")
    assert got == _collect(fresh, [4, 5, 6], max_new_tokens=5)


def test_stats_keys_match_reference():
    teng = tllm.LLMEngine("debug", device="cpu")
    assert set(teng.stats()) == set(_jax_engine().stats())
    assert teng.stats()["tp"] == 1


def test_invalid_prompts_raise():
    """A prompt past the largest bucket raises, as in the reference. An id
    past the vocabulary raises too: the reference embeds it as a NaN row
    (jnp.take's fill mode), and on the card the same gather is a
    device-side assert, so the port refuses the prompt before it reaches
    the device."""
    eng = tllm.LLMEngine("debug", device="cpu")
    with pytest.raises(ValueError, match="largest prefill bucket is 32"):
        _collect(eng, list(range(1, 34)), max_new_tokens=2)
    for bad in ([1, 256, 3], [-1]):
        with pytest.raises(ValueError, match="outside the vocabulary"):
            _collect(eng, bad, max_new_tokens=2)
    with pytest.raises(ValueError, match="outside the vocabulary"):
        asyncio.run(eng.prefill_only([300]))
    assert eng.stats()["prefills"] == 0


def test_a_new_event_loop_rebinds_the_engine():
    """A consumer that stops mid-stream and a new event loop: the engine
    bumps its epoch, drops the old slots and cache, and serves the next
    request as a fresh engine would."""
    eng = tllm.LLMEngine("debug", max_batch=2, device="cpu")

    async def stop_early():
        out = []
        async for t in eng.generate([1, 2, 3], max_new_tokens=50):
            out.append(t)
            if len(out) == 3:
                break
        return out

    assert len(asyncio.run(stop_early())) == 3
    epoch = eng._epoch
    got = _collect(eng, [4, 5, 6], max_new_tokens=5)
    assert eng._epoch == epoch + 1
    fresh = tllm.LLMEngine("debug", max_batch=2, device="cpu")
    assert got == _collect(fresh, [4, 5, 6], max_new_tokens=5)


def test_unported_options_raise():
    """Tensor-parallel serving is ported, its KV handoff too: tp=2 on the
    CPU (a follower process, gloo) serves the tp=1 engine's stream, hands
    its rows to the tp=1 engine, which decodes that stream from them, and
    tp=None is one device on the CPU. (tests/test_torch_serve_tp.py and
    tests/test_torch_serve_tp_handoff.py hold tp=2 against the JAX
    package's.)"""
    assert tllm.LLMEngine("debug", device="cpu").tp == 1
    one = tllm.LLMEngine("debug", max_batch=2, device="cpu")
    eng = tllm.LLMEngine("debug", tp=2, max_batch=2, device="cpu",
                         params=one.params)
    try:
        want = _collect(one, [5, 9, 11], max_new_tokens=5)
        assert _collect(eng, [5, 9, 11], max_new_tokens=5) == want

        async def handoff():
            payload = await eng.prefill_only([5, 9, 11])
            return [t async for t in one.generate_prefilled(
                [5, 9, 11], payload, max_new_tokens=5)]
        assert asyncio.run(handoff()) == want
    finally:
        eng.shutdown()


def test_llama_service_takes_a_string_payload():
    svc = tllm.LlamaService("debug", max_batch=2, device="cpu")

    async def run():
        return [d async for d in svc({"tokens": "hi there",
                                      "max_new_tokens": 4})]

    items = asyncio.run(run())
    assert len(items) == 4
    assert all(isinstance(d["token"], int) for d in items)
    want = _collect(svc.engine, list(b"hi there"), max_new_tokens=4)
    assert [d["token"] for d in items] == want
    assert svc.stats()["generated_tokens"] == 8


# ------------------------------- a fault of the reference, not copied
def test_free_slot_overrun_poisons_the_reference_not_the_port(f32):
    """Slot 1 stays free while slot 0 serves three requests: 21 decode steps
    over a 16-slot cache. The reference's free row advances each step, so it
    gathers NaN rope tables past max_seq_len and parks NaN K/V in the row's
    last slot: the next request grafted into slot 1 decodes NaN logits
    (argmax 0). The port's engine keeps a free row at depth 0: the reused
    slot's stream equals a fresh engine's."""
    jeng_kw, _ = SCENARIOS["free_slot_overrun_reuse"]
    assert (_jax_engine(**jeng_kw).prompt_buckets
            == _torch_engine(**jeng_kw).prompt_buckets == (8,))
    (jx, jy), jfacts = _scenario("free_slot_overrun_reuse", _jax_engine)
    (tx, ty), tfacts = _scenario("free_slot_overrun_reuse", _torch_engine)
    assert jfacts["free_steps"] == tfacts["free_steps"] == 21
    assert jfacts["free_slot_depth"] == 21          # past the table
    assert tfacts["free_slot_depth"] == 0
    assert tx == jx
    assert jy[1:] == [0] * 7                         # NaN logits -> token 0
    assert tfacts["equals_fresh"]
    assert ty != jy


# ------------------------------------------------------ LoRA adapters
def _lora_np(b_scale=0.05):
    """An adapter on the four attention targets, as numpy (b_scale 0: a
    fresh init's zero-B adapter)."""
    return lora_numpy(tllama.config_for("debug"), 4, tlora.DEFAULT_TARGETS,
                      seed=0, b_scale=b_scale)


@pytest.mark.parametrize("name", ["one_request", "three_concurrent"])
def test_engine_with_adapter_matches_jax(f32, name):
    """Both engines over the same base and a nonzero adapter: greedy streams
    equal token for token, and differ from the base model's."""
    params = {**_params_np(), "lora": _lora_np()}
    want, _ = _scenario(name, lambda **kw: jllm.LLMEngine(
        "debug", tp=1, params=params, **kw))
    got, _ = _scenario(name, lambda **kw: tllm.LLMEngine(
        "debug", device="cpu", params=params, **kw))
    assert got == want
    base, _ = _scenario(name, _torch_engine)
    assert got != base


def test_zero_b_adapter_engine_equals_base_engine():
    """A zero-B adapter (bf16, as served) leaves every stream of the
    engine's scenarios as the base engine gives it."""
    params = {**_params_np(), "lora": _lora_np(b_scale=0.0)}
    for name in ("three_concurrent", "prefix_hit"):
        got, _ = _scenario(name, lambda **kw: tllm.LLMEngine(
            "debug", device="cpu", params=params, **kw))
        want, _ = _scenario(name, _torch_engine)
        assert got == want, name


def test_engine_checks_tensor_params_like_numpy_ones():
    tparams = tllm.LLMEngine("debug", device="cpu").params
    eng = tllm.LLMEngine("debug", device="cpu", params=tparams)
    assert eng.params["embed"] is tparams["embed"]        # no copy
    bad = {**tparams, "lora": {"layers": {"wq_a": tparams["layers"]["wq"]}}}
    with pytest.raises(ValueError):
        tllm.LLMEngine("debug", device="cpu", params=bad)
    with pytest.raises(ValueError):
        tllm.LLMEngine("debug", device="cpu",
                       params={**tparams, "final_norm": tparams["embed"]})


class _Host:
    def __init__(self, max_models=None):
        self.loads = []
        if max_models is not None:
            self._rayt_mux_max_models = max_models

    @multiplex.multiplexed(max_num_models_per_replica=2)
    async def get_model(self, model_id: str):
        self.loads.append(model_id)
        return {"id": model_id}


def test_multiplex_lru_hits_evicts_and_reports_residents():
    host = _Host()

    async def run(ids):
        return [await host.get_model(i) for i in ids]
    first = asyncio.run(run(["a", "b", "a"]))
    assert host.loads == ["a", "b"]                     # "a" hit
    assert first[0] is first[2]
    assert multiplex.loaded_model_ids(host) == ["b", "a"]   # LRU order
    asyncio.run(run(["c"]))                              # evicts "b"
    assert multiplex.loaded_model_ids(host) == ["a", "c"]
    assert sorted(multiplex.resident_model_ids(host)) == ["a", "c"]
    asyncio.run(run(["b"]))                              # reload, evicts "a"
    assert host.loads == ["a", "b", "c", "b"]
    one = _Host(max_models=1)                            # instance override
    asyncio.run(one.get_model("x"))
    asyncio.run(one.get_model("y"))
    assert multiplex.loaded_model_ids(one) == ["y"]
    assert multiplex.get_multiplexed_model_id() == ""
    token = multiplex._set_model_id("m7")
    try:
        assert multiplex.get_multiplexed_model_id() == "m7"
    finally:
        multiplex._reset_model_id(token)
    assert multiplex.get_multiplexed_model_id() == ""


def test_mux_counters_count_loads_and_evictions():
    """The serve_mux_loads / serve_mux_evictions counters of
    util.builtin_metrics (wired as the reference wires them) count the
    loads and evictions of the LRU test above: "a", "b", "c", "b" loaded
    and "b", "a" evicted by the first host; "x", "y" loaded and "x"
    evicted by the second."""
    from ray_tpu_torch.util import builtin_metrics as bm

    tags = {"loader": "get_model"}
    loads, evictions = (bm.serve_mux_loads.get(tags),
                        bm.serve_mux_evictions.get(tags))
    test_multiplex_lru_hits_evicts_and_reports_residents()
    assert bm.serve_mux_loads.get(tags) - loads == 6
    assert bm.serve_mux_evictions.get(tags) - evictions == 3


def _serve(svc, model_id, tokens, n=6):
    async def run():
        token = multiplex._set_model_id(model_id)
        try:
            return [d async for d in svc({"tokens": tokens,
                                          "max_new_tokens": n})]
        finally:
            multiplex._reset_model_id(token)
    return asyncio.run(run())


class _NonzeroAdapters(tllm.MultiplexedLoraService):
    def _load_adapter(self, model_id):
        return nonzero_adapter(self.cfg, self.lora_rank, seed=len(model_id),
                               b_std=0.05, device="cpu")


def test_multiplexed_lora_service_shares_the_base():
    """Three adapter ids through an LRU of two engines: the LRU evicts, the
    streams are adapter-tagged, the empty id serves the bare base model,
    and every engine holds the service's base tensors (same storage), which
    serving leaves bit-identical."""
    svc = tllm.MultiplexedLoraService("debug", max_adapters_per_replica=2,
                                      lora_rank=4, device="cpu", max_batch=2)
    base_before = {k: v.clone() for k, v in svc._base["layers"].items()}
    prompt = [5, 9, 11, 42, 7]
    base_stream = _collect(tllm.LLMEngine("debug", device="cpu", max_batch=2,
                                          params=svc._base),
                           prompt, max_new_tokens=6)
    streams = {i: _serve(svc, i, prompt) for i in ("a1", "b2", "a1", "c3")}
    assert multiplex.loaded_model_ids(svc, "get_engine") == ["a1", "c3"]
    assert multiplex.resident_model_ids(svc) == ["a1", "c3"]
    for model_id, items in streams.items():
        assert {d["adapter"] for d in items} == {model_id}
        # seeded adapters start with B = 0: the base model's stream
        assert [d["token"] for d in items] == base_stream
    plain = _serve(svc, "", prompt)
    assert [d["token"] for d in plain] == base_stream
    engines = [asyncio.run(svc.get_engine(i)) for i in ("c3", "")]
    assert "lora" in engines[0].params and "lora" not in engines[1].params
    assert engines[0].params["lora"]["layers"]["wq_a"].shape == (2, 64, 4)
    for eng in engines:
        for key, t in svc._base["layers"].items():
            assert (eng.params["layers"][key].untyped_storage().data_ptr()
                    == t.untyped_storage().data_ptr()), key
    for key, t in svc._base["layers"].items():
        assert torch.equal(t, base_before[key]), key
    # a trained (nonzero) adapter changes the stream
    tuned = _NonzeroAdapters("debug", lora_rank=4, device="cpu", max_batch=2)
    assert [d["token"] for d in _serve(tuned, "a1", prompt)] != base_stream
