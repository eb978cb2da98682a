"""The tensor-parallel LLMEngine (``tp=2``) on gloo CPU ranks: rank 0 is this
test's process, rank 1 a follower process the engine starts. Held against
the JAX package's ``LLMEngine("debug", tp=2)`` (a 2-device mesh of the 8
virtual CPU devices) with the same numpy weights, greedy streams equal token
for token, and the four engine tests of tests/test_serve_llm.py:24-112 and
its adapter test (:136-160) mirrored at tp=2. Parity runs in f32 (the
``f32`` fixture; rank 0 hands its config to the follower, so the follower
runs f32 too). Each tensor-parallel engine owns a process group of its own
and never starts the default one; several at once, and the KV handoff
between them, are in tests/test_torch_serve_tp_handoff.py."""

import asyncio
import os
import signal
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import lora as jlora
from ray_tpu.serve import llm as jllm
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve.llm_tp import FollowerDied
from chip_smoke import collect as _collect
from test_torch_serve_llm import _agen_list, _params_np, f32  # noqa: F401

PROMPT = [5, 9, 11, 42, 7]


def _jax_engine(**kw):
    return jllm.LLMEngine("debug", tp=2, params=_params_np(), **kw)


class _Engine:
    """A port engine at tp=2 on the CPU, shut down on the way out."""

    def __init__(self, **kw):
        self.eng = tllm.LLMEngine("debug", tp=2, device="cpu",
                                  **{"params": _params_np(), **kw})

    def __enter__(self):
        return self.eng

    def __exit__(self, *exc):
        self.eng.shutdown()
        assert not torch.distributed.is_initialized()


def _concurrent(eng, requests):
    async def run():
        return await asyncio.gather(*[
            _agen_list(eng.generate(t, max_new_tokens=n))
            for t, n in requests])
    return asyncio.run(run())


def _unbatched(params_np, prompt, n):
    """Plain single-device greedy decode_step of the same weights."""
    from ray_tpu_torch.models.convert import params_from_numpy

    cfg = tllm.llama.config_for("debug")
    params = params_from_numpy(params_np, device="cpu", cfg=cfg)
    cache = tllama.init_kv_cache(cfg, 1, max_len=cfg.max_seq_len,
                                 device="cpu")
    out = []
    with torch.inference_mode():
        logits, cache = tllama.decode_step(params, cache,
                                           torch.tensor([prompt]), cfg)
        for _ in range(n):
            nxt = int(logits[0].argmax())
            out.append(nxt)
            logits, cache = tllama.decode_step(params, cache,
                                               torch.tensor([[nxt]]), cfg)
    return out


def test_tp2_greedy_matches_jax_and_unbatched_decode(f32):
    """Mirror of test_engine_greedy_matches_unbatched_decode at tp=2: the
    sharded engine's stream equals the reference's tp=2 engine's and a
    plain unbatched decode of the same weights; each rank holds half the
    kv heads and its shards of the weights."""
    want = _collect(_jax_engine(max_batch=4), PROMPT, max_new_tokens=8)
    with _Engine(max_batch=4) as eng:
        got = _collect(eng, PROMPT, max_new_tokens=8)
        cfg = eng.cfg
        assert eng.stats()["tp"] == 2 and len(eng._tp.pids()) == 1
        assert eng._decode_cache["k"].shape[3] == cfg.n_kv_heads // 2
        assert eng.params["layers"]["wq"].shape[-1] == \
            cfg.n_heads * cfg.head_dim // 2
    assert len(got) == 8
    assert got == want
    assert got == _unbatched(_params_np(), PROMPT, 8)


def test_tp2_engine_batches_concurrent_requests(f32):
    """Mirror of test_engine_batches_concurrent_requests at tp=2: three
    requests decode in shared steps, each stream deterministic, and the
    streams equal the reference's tp=2 engine's."""
    requests = [([3 + i, 8, 1], 5) for i in range(3)]
    want = _concurrent(_jax_engine(max_batch=4), requests)
    with _Engine(max_batch=4) as eng:
        outs = _concurrent(eng, requests)
        assert eng.prefills == 3
        assert eng.batches <= 8
        again = _collect(eng, [3, 8, 1], max_new_tokens=5)
    assert all(len(o) == 5 for o in outs)
    assert again == outs[0]
    assert outs == want


def test_tp2_engine_respects_per_request_lengths_and_eos(f32):
    """Mirror of test_engine_respects_per_request_lengths_and_eos at tp=2,
    with an eos the reference's streams give, against the reference's."""
    requests = [([1, 2, 3], 2), ([9, 9], 7)]
    full = _concurrent(_jax_engine(max_batch=4), requests)
    eos = full[1][3]
    want = _concurrent(_jax_engine(max_batch=4, eos_token_id=eos), requests)
    with _Engine(max_batch=4) as eng:
        a, b = _concurrent(eng, requests)
    assert (len(a), len(b)) == (2, 7)
    assert [a, b] == full
    with _Engine(max_batch=4, eos_token_id=eos) as eng:
        got = _concurrent(eng, requests)
    assert got == want


def test_tp2_late_request_joins_mid_decode():
    """Mirror of test_late_request_joins_mid_decode at tp=2 (bf16, as
    served): a late request starts within a few steps while the first is
    still decoding."""
    with _Engine(max_batch=4, params=None) as eng:
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
    assert steps_for_late <= 6
    assert not first_done


def test_tp2_engine_applies_lora_adapter(f32):
    """Mirror of test_engine_applies_lora_adapter at tp=2: the adapter
    subtree shards by lora_logical_axes; a zero-B adapter equals the base
    stream, a nonzero one changes it, and that stream equals the
    reference's tp=2 engine with the same adapter."""
    cfg = jllm.llama.config_for("debug")
    adapter = jlora.init_lora_params(
        cfg, jlora.LoraConfig(rank=4, alpha=cfg.lora_alpha),
        jax.random.PRNGKey(7))
    adapter = jax.tree.map(np.asarray, adapter)
    adapter2 = jax.tree.map(
        lambda a: a + 0.5 if a.ndim and a.shape[-1] != 4 else a, adapter)
    base = _params_np()
    want2 = _collect(jllm.LLMEngine(
        "debug", tp=2, max_batch=2, params={**base, "lora": adapter2}),
        PROMPT, max_new_tokens=8)
    with _Engine(max_batch=2) as eng:
        plain = _collect(eng, PROMPT, max_new_tokens=8)
    with _Engine(max_batch=2, params={**base, "lora": adapter}) as eng:
        assert eng.params["lora"]["layers"]["wq_b"].shape[-1] == \
            cfg.n_heads * cfg.head_dim // 2
        zero_b = _collect(eng, PROMPT, max_new_tokens=8)
    with _Engine(max_batch=2, params={**base, "lora": adapter2}) as eng:
        got2 = _collect(eng, PROMPT, max_new_tokens=8)
    assert zero_b == plain
    assert got2 != plain
    assert got2 == want2


def test_tp2_dead_follower_fails_requests_with_its_name():
    """A follower killed mid-stream fails that stream, and every later
    request, with an error naming it; nothing hangs."""
    with _Engine(max_batch=2, params=None) as eng:
        (pid,) = eng._tp.pids()

        async def run():
            seen = []
            with pytest.raises(FollowerDied, match=f"rank 1 \\(pid {pid}\\)"):
                async for tok in eng.generate([1, 2, 3],
                                              max_new_tokens=10_000):
                    seen.append(tok)
                    if len(seen) == 3:
                        os.kill(pid, signal.SIGKILL)
            return seen

        t0 = time.monotonic()
        assert len(asyncio.run(run())) >= 3
        with pytest.raises(FollowerDied, match="rank 1"):
            _collect(eng, [4, 5], max_new_tokens=4)
        assert time.monotonic() - t0 < 60


def test_llm_app_tp2_serves_from_a_replica():
    """llm_app("debug", tp=2, device="cpu"): the replica's engine is rank 0
    and starts its follower from the replica's worker process; its stream
    equals an in-process tp=2 engine's, and the follower ends with the
    replica."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    payload = {"tokens": [4, 8, 15], "max_new_tokens": 6}
    rt.init(num_cpus=4)
    try:
        h = serve.run(tllm.llm_app("debug", tp=2, device="cpu",
                                   max_batch=2), name="tp2")
        served = [d["token"] for d in
                  h.options(stream=True).remote(dict(payload))]
        stats = h.options(method_name="stats").remote().result()
    finally:
        serve.shutdown()
        rt.shutdown()
    assert stats["tp"] == 2 and stats["prefills"] == 1
    with _Engine(max_batch=2, params=None) as eng:
        assert served == _collect(eng, payload["tokens"], max_new_tokens=6)


def test_llm_app_tp_leases_its_cards():
    """llm_app(tp=N) leases N GPUs for its replica; on the CPU, none."""
    on_cards = tllm.llm_app("debug", tp=2)
    assert on_cards.deployment.ray_actor_options == {"num_gpus": 2}
    on_cpu = tllm.llm_app("debug", tp=2, device="cpu")
    assert on_cpu.deployment.ray_actor_options == {}
    assert tllm.llm_app("debug").deployment.ray_actor_options == {}


def test_tp_none_in_a_worker_leased_no_gpu_is_one():
    """On a node of four cards (a hand-set count: no CUDA is touched), a
    replica leased no GPU (``llm_app`` without ``tp``) sees every card and
    owns none: ``tp=None`` there is 1, and an explicit ``tp=2`` raises
    rather than start followers on cards no lease holds. A worker leased
    two GPUs gives its ranks the lease's two cards; the driver, outside
    any lease, keeps every card it sees."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._internal.accelerators import _in_lease_without_gpu

    def probe():
        import os

        import torch

        from ray_tpu_torch.serve import llm, llm_tp

        cuda = torch.device("cuda")
        ids = os.environ.get("CUDA_VISIBLE_DEVICES")
        try:
            cards = llm_tp._card_ids(cuda, 2)
        except ValueError as e:
            cards = str(e)
        if ids is None:     # no lease of a card: no CUDA query is made
            return llm._visible_devices(cuda), cards, ids
        return None, cards, ids

    rt.init(num_cpus=4, resources={"GPU": 4})
    try:
        n, cards, ids = rt.get(rt.remote(probe).remote(), timeout=60)
        assert (n, ids) == (1, None)
        assert "lease holds no GPU" in cards
        _, cards, ids = rt.get(rt.remote(num_gpus=2)(probe).remote(),
                               timeout=60)
        assert cards == ids.split(",") and len(set(cards)) == 2
        assert not _in_lease_without_gpu()
    finally:
        rt.shutdown()
