"""Continuously batched LLM engine on one CUDA card (counterpart of
ray_tpu/serve/llm.py:35-805).

The engine decodes concurrent requests in a ring of fixed slots over one
KV cache with per-row depths: each request is prefilled alone (prompt
bucket, optionally chunk by chunk between decode steps), its KV rows are
grafted into a free slot, and it joins the next decode step. Finished slots
free at once and refill from the queue between steps.

Torch has no buffer donation, so the decode state (cache, current tokens,
temperatures) lives in buffers allocated once and written in place, and the
sampling stream is an explicit ``torch.Generator``. Steps run on executor
threads under ``torch.inference_mode()``, entered inside each thread
function (the mode is thread-local).

Params may carry a ``"lora"`` adapter subtree: ``decode_step`` applies the
low-rank path in every prefill and decode step. ``MultiplexedLoraService``
keeps one engine per adapter id behind the multiplex LRU, all over one set of
base weight tensors.

``llm_app`` and ``lora_llm_app`` deploy ``LlamaService`` and
``MultiplexedLoraService`` as Serve applications (``serve.run``); the
replica hosting one builds its engine on the card of its process.
``disagg_llm_app`` splits serving into a prefill pool (``PrefillWorker``)
and a decode pool (``DecodeLlamaService``, the ingress): each request's KV
rows cross from one to the other as one tick of a device edge
(``dag/device_channel.py``).

Not here: tensor parallelism (ROADMAP item 6).
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.models import lora as lora_mod
from ray_tpu_torch.models.convert import check_params, params_from_numpy
from ray_tpu_torch.serve.handle import prefix_block_tokens
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.request_context import current_request_obs


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class _Request:
    tokens: list[int]
    max_new_tokens: int
    temperature: float
    out: asyncio.Queue = field(default_factory=asyncio.Queue)
    loop: Optional[asyncio.AbstractEventLoop] = None
    # phase-stamp observation dict from the serving request context
    # (serve/request_context.py); None when not instrumented
    obs: Optional[dict] = None
    # generate_prefilled: KV rows prefilled by another engine; admit by
    # grafting, skip prefill
    prefilled: Optional[dict] = None
    # prefill_only: deliver the finished small cache as the result instead
    # of decoding from it
    handoff_out: bool = False


@dataclass
class _Slot:
    """One occupied decode slot: a request mid-generation.
    emitted == -1 marks a slot RESERVED by an in-progress chunked
    prefill: decode steps skip it, refill can't double-book it."""
    req: _Request
    emitted: int = 0
    length: int = 0  # host view of the row's cache depth


@dataclass
class _PendingPrefill:
    """A long prompt being prefilled one chunk per engine round, so active
    decode streams keep emitting between chunks."""
    req: _Request
    slot: int
    prompts: Any            # np [1, bucket]
    small: Any              # per-request prefill cache
    bucket: int
    pos: int = 0            # tokens already prefilled


def _to_device(tree, device: torch.device):
    """The same tree on `device`; a tensor already there is the same tensor
    (no copy), so engines built over one base share its storage."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class LLMEngine:
    """Continuously batched generation engine on one CUDA card.

    The decode batch is `max_batch` fixed SLOTS over one persistent KV cache
    with per-row depths (cache["length"] is [b]): a new request is prefilled
    alone (batch 1, one prompt bucket), its KV rows copied into a free slot,
    and it joins the very next decode step; it never waits for the previous
    batch to drain. Finished slots free immediately and refill from the
    queue between steps.

    ``device=None`` means the CUDA card (raises without one); pass
    ``device="cpu"`` to run on the CPU on purpose. ``params`` may be the
    JAX package's tree as numpy arrays (carried over with
    ``params_from_numpy``) or the port's dict of tensors, either one with a
    ``"lora"`` adapter subtree; both are checked against the preset's
    config. The engine never writes its params.
    """

    def __init__(self, preset: str = "debug", *, tp: int | None = None,
                 max_batch: int = 4, max_seq_len: int | None = None,
                 prompt_buckets: tuple[int, ...] = (32, 128, 512, 1024),
                 prefill_chunk: int = 256,
                 prefix_cache_entries: int = 8,
                 eos_token_id: int | None = None,
                 params: Any = None, seed: int = 0,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if tp not in (None, 1):
            raise NotImplementedError(
                f"tp={tp}: tensor-parallel serving needs the multi-GPU "
                f"slice (ROADMAP item 6); this engine runs on one device")
        cfg = llama.config_for(preset)
        if max_seq_len is not None:
            cfg = llama.config_for(preset, max_seq_len=max_seq_len)
        self.cfg = cfg
        self.max_batch = max_batch
        # chunked prefill: prompts longer than this prefill one chunk per
        # engine round instead of stalling decode for the whole prompt
        # (0 disables)
        self.prefill_chunk = int(prefill_chunk)
        self.prompt_buckets = tuple(
            b for b in prompt_buckets if b < cfg.max_seq_len) or (
                cfg.max_seq_len // 2,)
        self.eos_token_id = eos_token_id
        if params is None:
            params = llama.init_params(cfg, seed=seed, device=self.device)
        elif isinstance(params["embed"], torch.Tensor):
            check_params(params, cfg)
            params = _to_device(params, self.device)
        else:
            params = params_from_numpy(params, device=self.device, cfg=cfg)
        self.params = params
        self._key_seed = seed ^ 0x5EED
        self._key_reseeds = 0
        self._gen = torch.Generator(device=self.device).manual_seed(
            self._key_seed)
        self._queue: asyncio.Queue[_Request] = None  # type: ignore
        self._task = None
        self._loop = None
        # decode-slot state. Mutations happen on executor threads, one at a
        # time under _mutex; _epoch fences out a stale step still running on
        # the process-global executor after a loop rebind (replica restart)
        # so it can't touch the new engine state.
        self._mutex = threading.Lock()
        self._epoch = 0
        self._slots: list[Optional[_Slot]] = [None] * max_batch
        self._decode_cache = None  # lazy: built on first request
        # device-resident between steps, written in place
        self._cur, self._temps, self._live = self._fresh_slot_buffers()
        self._pending_prefills: list[_PendingPrefill] = []
        # prefix KV cache: completed prefills park their small-cache rows
        # here (LRU, `prefix_cache_entries` deep) keyed by the prompt's
        # first token block; a new prompt sharing a block-aligned prefix
        # grafts the stored rows and prefills only the tail. 0 disables.
        self.prefix_cache_entries = int(prefix_cache_entries)
        self._prefix_block = prefix_block_tokens()
        self._prefix_store: "OrderedDict[tuple, dict]" = OrderedDict()
        # perf counters
        self.generated_tokens = 0
        self.batches = 0       # decode steps executed
        self.prefills = 0
        self.prefill_chunks = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0   # prefill tokens skipped via reuse
        self.kv_handoffs = 0         # rows admitted from another engine

    def _fresh_slot_buffers(self):
        """Current tokens [b], temperatures [b, 1] and which slots hold a
        decoding request [b]."""
        return (torch.zeros((self.max_batch,), dtype=torch.int32,
                            device=self.device),
                torch.zeros((self.max_batch, 1), dtype=torch.float32,
                            device=self.device),
                torch.zeros((self.max_batch,), dtype=torch.bool,
                            device=self.device))

    def _step_impl(self, params, cache, tokens, temperature):
        """decode_step (writing `cache` in place) + sampling: greedy where
        temperature is 0, else Gumbel-max on logits / temperature."""
        if tokens.dim() == 1:  # decode path: device-resident [b]
            tokens = tokens[:, None]
        logits, cache = llama.decode_step(params, cache, tokens, self.cfg)
        greedy = logits.argmax(-1)
        gumbel = -torch.empty_like(logits).exponential_(
            generator=self._gen).log()
        sampled = (logits / temperature.clamp(min=1e-4) + gumbel).argmax(-1)
        nxt = torch.where(temperature[:, 0] > 0, sampled, greedy)
        return nxt.to(torch.int32), cache

    def _step(self, *args):
        # a failed step re-seeds the sampling stream before re-raising, with
        # the reference's counter scheme, so the engine's later draws do not
        # depend on how far the failed step got
        try:
            return self._step_impl(*args)
        except BaseException:
            self._reseed_key()
            raise

    def _insert_row(self, row_k, row_v, slot: int, length: int, start: int):
        """Copy a freshly prefilled request's KV rows into `slot` of the
        persistent cache and reset that row's depth/start."""
        cache = self._decode_cache
        n = row_k.shape[2]
        cache["k"][:, slot, :n].copy_(row_k[:, 0])
        cache["v"][:, slot, :n].copy_(row_v[:, 0])
        cache["length"][slot] = length
        cache["start"][slot] = start

    # ------------------------------------------------------------ serving
    async def ensure_started(self):
        loop = asyncio.get_running_loop()
        if self._loop is not loop or self._task is None or self._task.done():
            # (re)bind to the current event loop: a queue/task from a
            # previous loop (replica restart, repeated asyncio.run) is dead,
            # and so are any requests parked in old slots. Bumping the epoch
            # under the mutex waits out any in-flight executor step and
            # invalidates stragglers; the cache is rebuilt.
            with self._mutex:
                self._epoch += 1
                # a restart must not strand live consumers: anything still
                # parked in a slot OR the old queue gets an error, not
                # silence. A consumer whose loop already closed needs (and
                # can receive) no notification.
                err = RuntimeError("engine restarted")

                def _notify(req):
                    try:
                        req.loop.call_soon_threadsafe(req.out.put_nowait,
                                                      err)
                    except RuntimeError:
                        pass  # consumer's loop is closed: already gone
                for s_ in self._slots:
                    if s_ is not None:
                        _notify(s_.req)
                for pf in self._pending_prefills:
                    _notify(pf.req)
                self._pending_prefills = []
                if self._queue is not None:
                    while True:
                        try:
                            _notify(self._queue.get_nowait())
                        except asyncio.QueueEmpty:
                            break
                self._slots = [None] * self.max_batch
                self._decode_cache = None
                self._cur, self._temps, self._live = \
                    self._fresh_slot_buffers()
            self._queue = asyncio.Queue()
            self._task = asyncio.ensure_future(self._engine_loop())
            self._loop = loop

    def _check_prompt(self, tokens: list[int]):
        limit = max(self.prompt_buckets)
        if len(tokens) > limit:
            raise ValueError(
                f"prompt is {len(tokens)} tokens; this engine's largest "
                f"prefill bucket is {limit} (raise prompt_buckets / "
                f"max_seq_len)")
        # an id past the table would gather out of bounds on the device (a
        # device-side assert that kills the CUDA context)
        bad = [t for t in tokens if not 0 <= t < self.cfg.vocab_size]
        if bad:
            raise ValueError(f"token ids {bad[:8]} are outside the "
                             f"vocabulary [0, {self.cfg.vocab_size})")

    async def _submit(self, req: _Request):
        if req.obs is not None:
            # queue_s / ttft measure from here: the engine saw the request
            req.obs["gen_start"] = time.perf_counter()
        await self._queue.put(req)

    async def _stream(self, req: _Request):
        await self._submit(req)
        while True:
            item = await req.out.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    async def generate(self, tokens: list[int], *,
                       max_new_tokens: int = 32,
                       temperature: float = 0.0):
        """Async generator of generated token ids. Raises ValueError for
        prompts longer than the largest prefill bucket: silent front
        truncation would return plausible-but-wrong output."""
        self._check_prompt(tokens)
        await self.ensure_started()
        req = _Request(list(tokens), int(max_new_tokens), float(temperature),
                       loop=asyncio.get_running_loop(),
                       obs=current_request_obs())
        async for tok in self._stream(req):
            yield tok

    async def prefill_only(self, tokens: list[int], *,
                           temperature: float = 0.0) -> dict:
        """Run ONLY the prefill (chunked as configured, prefix reuse
        included) and return the KV handoff payload instead of decoding:
        ``{"k", "v", "first", "bucket", "start"}``, tensors on this engine's
        device that no later step writes. Feed it to another engine's
        `generate_prefilled`."""
        self._check_prompt(tokens)
        await self.ensure_started()
        req = _Request(list(tokens), 1, float(temperature),
                       loop=asyncio.get_running_loop(),
                       obs=current_request_obs(), handoff_out=True)
        await self._submit(req)
        item = await req.out.get()
        if isinstance(item, Exception):
            raise item
        return item

    async def generate_prefilled(self, tokens: list[int], handoff: dict,
                                 *, max_new_tokens: int = 32,
                                 temperature: float = 0.0):
        """Async generator over decode-only generation from KV rows
        prefilled by another engine (`prefill_only`'s payload). The first
        token was sampled there and streams out immediately; this engine
        never runs the prompt."""
        await self.ensure_started()
        req = _Request(list(tokens), int(max_new_tokens),
                       float(temperature),
                       loop=asyncio.get_running_loop(),
                       obs=current_request_obs(), prefilled=dict(handoff))
        async for tok in self._stream(req):
            yield tok

    async def _engine_loop(self):
        """Continuous-batching scheduler: admit into free slots between
        decode steps; a late-arriving request starts decoding one step
        after its prefill, regardless of how deep the other slots are."""
        loop = asyncio.get_running_loop()
        epoch = self._epoch
        queue = self._queue  # bound once: after a rebind self._queue is the
        # NEW loop's queue; a stale loop reading it would steal and fail
        # the new loop's requests

        async def _admit(req: _Request):
            try:
                await loop.run_in_executor(None, self._admit, req, epoch)
            except Exception as e:
                req.loop.call_soon_threadsafe(req.out.put_nowait, e)

        while epoch == self._epoch:
            if not any(s is not None for s in self._slots):
                # idle: block until work arrives (no spinning)
                await _admit(await queue.get())
            # opportunistic refill of every free slot, no waiting
            while (not queue.empty()
                   and any(s is None for s in self._slots)):
                await _admit(queue.get_nowait())
            if self._pending_prefills:
                # one chunk per round: a long prompt costs active streams
                # ~one chunk of latency per step, not the whole-prompt stall
                try:
                    await loop.run_in_executor(
                        None, self._advance_prefill, epoch)
                except Exception:
                    if epoch != self._epoch:
                        return
            if any(s is not None and s.emitted >= 0
                   for s in self._slots):
                try:
                    await loop.run_in_executor(
                        None, self._decode_step_all, epoch)
                except Exception:
                    # _poison_recover already failed the active requests and
                    # reset the cache; an epoch mismatch means a newer loop
                    # owns the engine: stop
                    if epoch != self._epoch:
                        return

    # ------------------------------------------------------- the hot path
    def _ensure_decode_cache(self):
        if self._decode_cache is None:
            cache = llama.init_kv_cache(self.cfg, self.max_batch,
                                        max_len=self.cfg.max_seq_len,
                                        device=self.device)
            # per-row depths: each slot is an independent request
            cache["length"] = torch.zeros((self.max_batch,),
                                          dtype=torch.int32,
                                          device=self.device)
            self._decode_cache = cache

    def _finish(self, i: int):
        s = self._slots[i]
        s.req.loop.call_soon_threadsafe(s.req.out.put_nowait, None)
        self._slots[i] = None  # row's temp/token are garbage-masked
        self._live[i] = False

    def _admit(self, req: _Request, epoch: int):
        """Prefill one request (batch 1, one bucket) and graft its KV rows
        into a free slot of the persistent decode cache."""
        with self._mutex, torch.inference_mode():
            if epoch != self._epoch:
                raise RuntimeError("engine restarted during admission")
            self._admit_locked(req)

    def _small_cache(self, bucket: int, start: int) -> dict:
        small = llama.init_kv_cache(self.cfg, 1, max_len=bucket,
                                    device=self.device)
        small["start"].fill_(start)
        return small

    def _prefill_step(self, req: _Request, small: dict,
                      tokens: np.ndarray) -> tuple[torch.Tensor, dict]:
        temps1 = torch.tensor([[req.temperature]], dtype=torch.float32,
                              device=self.device)
        t_pf = time.perf_counter()
        nxt, small = self._step(self.params, small,
                                torch.from_numpy(tokens).to(self.device),
                                temps1)
        obs = req.obs
        if obs is not None:
            obs["prefill_s"] = obs.get("prefill_s", 0.0) + (
                time.perf_counter() - t_pf)
            obs["prefill_chunks"] = obs.get("prefill_chunks", 0) + 1
        return nxt, small

    def _admit_locked(self, req: _Request):
        obs = req.obs
        if obs is not None and "gen_start" in obs:
            obs["queue_s"] = time.perf_counter() - obs["gen_start"]
        try:
            self._ensure_decode_cache()
        except Exception:
            self._decode_cache = None
            raise
        slot = next(i for i, s in enumerate(self._slots) if s is None)
        if req.prefilled is not None:
            # handoff: another engine already produced these KV rows; graft
            # them and go straight to decode
            self._admit_prefilled_locked(req, slot)
            return
        toks = req.tokens  # generate() enforces len <= max bucket
        bucket = _bucket(len(toks), self.prompt_buckets)
        start = bucket - len(toks)
        prompts = np.zeros((1, bucket), np.int32)
        prompts[0, start:] = toks

        small = self._small_cache(bucket, start)
        entry, matched = self._prefix_lookup(toks)
        if matched:
            # prefix hit: graft the stored rows at this prompt's start
            # offset (KV content is start-RELATIVE: rope positions count
            # from the first real token) and resume the prefill at the
            # first un-cached token
            pos0 = start + matched
            small = self._graft_prefix(small, entry, pos0 - matched,
                                       matched)
            self.prefix_hits += 1
            self.prefix_hit_tokens += matched
            if obs is not None:
                obs["prefix_cache"] = "hit"
                obs["prefix_hit_tokens"] = matched
            if self.prefill_chunk and \
                    bucket - pos0 > self.prefill_chunk:
                self._slots[slot] = _Slot(req, emitted=-1, length=0)
                self._pending_prefills.append(_PendingPrefill(
                    req=req, slot=slot, prompts=prompts, small=small,
                    bucket=bucket, pos=pos0))
                return
            nxt, small = self._prefill_step(req, small, prompts[:, pos0:])
            self.prefills += 1
            self._finish_prefill(req, slot, small, int(nxt[0]), bucket,
                                 start)
            return
        if (self.prefix_cache_entries and self._prefix_block
                and len(toks) > self._prefix_block):
            self.prefix_misses += 1
            if obs is not None:
                obs["prefix_cache"] = "cold"
        if self.prefill_chunk and bucket > self.prefill_chunk:
            # long prompt: reserve the slot, prefill chunk by chunk between
            # decode steps (the engine loop drives _advance_prefill).
            # Left-pad chunks are skipped entirely: they carry no
            # information (masked by `start`), so begin at the last chunk
            # boundary before the first real token.
            skip = (start // self.prefill_chunk) * self.prefill_chunk
            if skip:
                small["length"].fill_(skip)
            self._slots[slot] = _Slot(req, emitted=-1, length=0)
            self._pending_prefills.append(_PendingPrefill(
                req=req, slot=slot, prompts=prompts, small=small,
                bucket=bucket, pos=skip))
            return
        nxt, small = self._prefill_step(req, small, prompts)
        self.prefills += 1
        self._finish_prefill(req, slot, small, int(nxt[0]), bucket, start)

    # ----------------------------------------------- prefix KV reuse
    def _prefix_lookup(self, toks: list) -> tuple[Optional[dict], int]:
        """Longest block-aligned reusable prefix for `toks` among the
        stored entries (callers hold _mutex). Returns (entry, matched);
        matched is a multiple of the prefix block, capped one short of the
        full prompt so the tail prefill always has >= 1 token to produce
        the first sampled logits from."""
        block = self._prefix_block
        if (not self.prefix_cache_entries or not block
                or len(toks) <= block):
            return None, 0
        entry = self._prefix_store.get(tuple(toks[:block]))
        if entry is None:
            return None, 0
        self._prefix_store.move_to_end(tuple(toks[:block]))
        etoks = entry["tokens"]
        limit = min(len(etoks), len(toks) - 1)
        n = 0
        while n < limit and etoks[n] == toks[n]:
            n += 1
        matched = (n // block) * block
        return (entry, matched) if matched >= block else (None, 0)

    def _graft_prefix(self, small, entry: dict, off: int,
                      matched: int) -> dict:
        """Copy `matched` stored KV rows into the fresh per-request cache at
        absolute position `off` and advance its write cursor. The entry is
        only read."""
        e_off = int(entry["start"])
        for key_ in ("k", "v"):
            small[key_][:, :, off:off + matched].copy_(
                entry[key_][:, :, e_off:e_off + matched])
        small["length"].fill_(off + matched)
        return small

    def _prefix_put(self, tokens: list, small, bucket: int):
        """Park a finished prefill's rows in the LRU (callers hold _mutex).
        Entries key on the first token block; a same-key store replaces
        (latest wins). The entry holds the request's own small cache, which
        no later step writes: decode steps write only the decode cache, and
        a graft copies out of the entry."""
        block = self._prefix_block
        if (not self.prefix_cache_entries or not block
                or len(tokens) <= block):
            return
        key = tuple(tokens[:block])
        self._prefix_store[key] = {
            "tokens": list(tokens), "k": small["k"], "v": small["v"],
            "start": bucket - len(tokens), "bucket": bucket}
        self._prefix_store.move_to_end(key)
        while len(self._prefix_store) > self.prefix_cache_entries:
            self._prefix_store.popitem(last=False)

    def _admit_prefilled_locked(self, req: _Request, slot: int):
        h = req.prefilled
        kv = {"k": h["k"].to(self.device), "v": h["v"].to(self.device)}
        self.kv_handoffs += 1
        self._finish_prefill(req, slot, kv, int(h["first"]),
                             int(h["bucket"]), int(h["start"]),
                             store=False)

    def _advance_prefill(self, epoch: int):
        with self._mutex, torch.inference_mode():
            if epoch != self._epoch or not self._pending_prefills:
                return
            pf = self._pending_prefills[0]
            try:
                chunk = min(self.prefill_chunk, pf.bucket - pf.pos)
                nxt, pf.small = self._prefill_step(
                    pf.req, pf.small, pf.prompts[:, pf.pos:pf.pos + chunk])
                pf.pos += chunk
                self.prefill_chunks += 1
                if pf.pos < pf.bucket:
                    return
                self._pending_prefills.pop(0)
                self.prefills += 1
                self._slots[pf.slot] = None  # release the reservation
                self._finish_prefill(
                    pf.req, pf.slot, pf.small, int(nxt[0]),
                    pf.bucket, pf.bucket - len(pf.req.tokens))
            except BaseException as e:
                # a failed chunk leaves pf.small half written, and a failed
                # final insert already removed pf from the lists
                # _poison_recover notifies: either way, retrying is
                # impossible and the consumer must hear about it
                if self._pending_prefills and \
                        self._pending_prefills[0] is pf:
                    self._pending_prefills.pop(0)
                if self._slots[pf.slot] is not None and \
                        self._slots[pf.slot].emitted < 0:
                    self._slots[pf.slot] = None
                pf.req.loop.call_soon_threadsafe(
                    pf.req.out.put_nowait,
                    e if isinstance(e, Exception)
                    else RuntimeError(repr(e)))
                raise

    def _finish_prefill(self, req: _Request, slot: int, small, first: int,
                        bucket: int, start: int, store: bool = True):
        """Deliver the prefill's sampled token and graft the KV rows into
        the slot (callers hold _mutex)."""
        if store:
            self._prefix_put(req.tokens, small, bucket)
        if req.handoff_out:
            # prefill side of a handoff: the result IS the KV payload; the
            # decoding engine grafts it via generate_prefilled. No slot, no
            # insert, no decode.
            req.loop.call_soon_threadsafe(
                req.out.put_nowait,
                {"k": small["k"], "v": small["v"], "first": int(first),
                 "bucket": int(bucket), "start": int(start)})
            req.loop.call_soon_threadsafe(req.out.put_nowait, None)
            return
        if self.eos_token_id is not None and first == self.eos_token_id:
            req.loop.call_soon_threadsafe(req.out.put_nowait, None)
            return
        self.generated_tokens += 1
        if req.obs is not None:
            now = time.perf_counter()
            req.obs["first_token"] = now
            req.obs["last_token"] = now
            req.obs["tokens"] = req.obs.get("tokens", 0) + 1
        req.loop.call_soon_threadsafe(req.out.put_nowait, first)
        if req.max_new_tokens <= 1:
            req.loop.call_soon_threadsafe(req.out.put_nowait, None)
            return
        try:
            self._insert_row(small["k"], small["v"], slot, bucket, start)
        except BaseException:
            # a half-done insert leaves the shared cache in an unknown
            # state: every active slot's KV is suspect, not just the new
            # request's
            self._poison_recover()
            raise
        self._slots[slot] = _Slot(req, emitted=1, length=bucket)
        self._cur[slot] = first
        self._temps[slot, 0] = req.temperature
        self._live[slot] = True

    def _reseed_key(self):
        """Re-seed the sampling generator after a failed step; the reseed
        counter keeps the stream fresh."""
        self._key_reseeds += 1
        self._gen.manual_seed(self._key_seed ^ (self._key_reseeds << 16))

    def _poison_recover(self):
        """A step that writes the shared decode cache failed part way: its
        contents are unknown. Fail every active request and reset so the
        next admission rebuilds from scratch (callers hold _mutex). The
        generator is re-seeded by the _step guard at the raise site."""
        err = RuntimeError("decode cache lost to a failed engine step")
        for s in self._slots:
            if s is not None:
                s.req.loop.call_soon_threadsafe(s.req.out.put_nowait, err)
        for pf in self._pending_prefills:
            pf.req.loop.call_soon_threadsafe(pf.req.out.put_nowait, err)
        self._pending_prefills = []
        self._slots = [None] * self.max_batch
        self._decode_cache = None
        self._cur, self._temps, self._live = self._fresh_slot_buffers()

    def _decode_step_all(self, epoch: int):
        with self._mutex, torch.inference_mode():
            if epoch != self._epoch:
                raise RuntimeError("engine restarted during decode")
            self._decode_step_locked()

    def _decode_step_locked(self):
        """One decode step across all slots (free rows compute masked
        garbage: the price of one fixed batch shape)."""
        try:
            nxt, self._decode_cache = self._step(
                self.params, self._decode_cache, self._cur, self._temps)
        except BaseException:
            self._poison_recover()
            raise
        # a free or reserved row stays at depth 0: left to advance one slot
        # a step, it would pass the rope table after max_seq_len idle steps
        # (the reference then parks NaN K/V where the next request reads)
        self._decode_cache["length"].mul_(self._live)
        self._cur.copy_(nxt)  # stays on the device for the next step
        toks = nxt.tolist()   # host sync: this step's sampled tokens
        self.batches += 1
        # occupancy of THIS step, stamped into each participant's obs:
        # mean over a request's steps = how full its decode batches ran
        active = sum(1 for s in self._slots
                     if s is not None and s.emitted >= 0)
        occupancy = active / self.max_batch
        now = time.perf_counter()
        for i, s in enumerate(self._slots):
            if s is None or s.emitted < 0:  # free or mid-prefill
                continue
            t = toks[i]
            s.length += 1
            if self.eos_token_id is not None and t == self.eos_token_id:
                self._finish(i)
                continue
            s.emitted += 1
            self.generated_tokens += 1
            if s.req.obs is not None:
                o = s.req.obs
                o["tokens"] = o.get("tokens", 0) + 1
                o["decode_steps"] = o.get("decode_steps", 0) + 1
                o["occupancy_sum"] = o.get("occupancy_sum", 0.0) + occupancy
                o["last_token"] = now
            s.req.loop.call_soon_threadsafe(s.req.out.put_nowait, t)
            if (s.emitted >= s.req.max_new_tokens
                    or s.length >= self.cfg.max_seq_len - 1):
                self._finish(i)

    def stats(self) -> dict:
        return {"generated_tokens": self.generated_tokens,
                "batches": self.batches,
                "prefills": self.prefills,
                "prefill_chunks": self.prefill_chunks,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "prefix_entries": len(self._prefix_store),
                "kv_handoffs": self.kv_handoffs,
                "active_slots": sum(1 for s in self._slots
                                    if s is not None),
                "tp": 1}


class LlamaService:
    """Serve callable hosting one LLMEngine (deploy it with ``llm_app`` or
    ``serve.deployment``).

    Request payload: {"tokens": [...] or a string, "max_new_tokens": int,
    "temperature": float} -> streams {"token": id} dicts.
    """

    def __init__(self, preset: str = "debug", **engine_kw):
        self.engine = LLMEngine(preset, **engine_kw)

    async def __call__(self, payload: dict):
        tokens = payload["tokens"]
        if isinstance(tokens, str):  # raw byte-level "tokenizer"
            tokens = [b % self.engine.cfg.vocab_size
                      for b in tokens.encode()]
        async for tok in self.engine.generate(
                tokens,
                max_new_tokens=int(payload.get("max_new_tokens", 32)),
                temperature=float(payload.get("temperature", 0.0))):
            yield {"token": int(tok)}

    def stats(self) -> dict:
        return self.engine.stats()


class MultiplexedLoraService:
    """Multi-LoRA serving: one base model, many adapters time-sharing one
    replica through the multiplex LRU (deploy it with ``lora_llm_app``; the
    router's model-id affinity keeps an adapter's traffic on the replica
    where it is resident).

    Each adapter id owns an ``LLMEngine`` whose params are
    ``{**base, "lora": adapter}``: the decode steps apply the low-rank path,
    and every engine holds the same base weight tensors (the same storage;
    no engine writes them), so a resident adapter costs its A/B matrices
    and a KV cache. The empty id serves the bare base model.

    ``_load_adapter`` seeds adapters from the adapter id, as the reference
    does: the stand-in for fetching trained A/B from storage (B = 0, so a
    seeded adapter starts as a no-op); override it to load real ones, such
    as the ``"lora"`` subtree of a checkpoint that the train runtime's
    ``lora_finetune_loop`` wrote (``train.load_pytree``).

    Request payload: {"tokens": [...] or a string, "max_new_tokens": int,
    "temperature": float}, with the adapter chosen by the multiplexed model
    id (HTTP header ``serve_multiplexed_model_id`` /
    ``handle.options(multiplexed_model_id=...)``); streams
    {"token": id, "adapter": model_id}.
    """

    def __init__(self, preset: str = "debug", *,
                 max_adapters_per_replica: int = 2, lora_rank: int = 4,
                 seed: int = 0, device: str | torch.device | None = None,
                 **engine_kw):
        self.preset = preset
        self.device = resolve_device(device)
        self.engine_kw = dict(engine_kw)
        self.lora_rank = int(lora_rank)
        self.cfg = llama.config_for(preset)
        self._base = llama.init_params(self.cfg, seed=seed,
                                       device=self.device)
        # instance override consumed by the @multiplexed LRU
        self._rayt_mux_max_models = int(max_adapters_per_replica)

    def _load_adapter(self, model_id: str) -> dict:
        seed = int.from_bytes(model_id.encode()[:4].ljust(4, b"\0"), "big")
        return lora_mod.init_lora_params(
            self.cfg, lora_mod.LoraConfig(rank=self.lora_rank,
                                          alpha=self.cfg.lora_alpha),
            seed=seed, device=self.device)

    @multiplexed(max_num_models_per_replica=2)  # instance attr overrides
    async def get_engine(self, model_id: str) -> LLMEngine:
        params = dict(self._base)
        if model_id:  # the empty id serves the bare base model
            params["lora"] = self._load_adapter(model_id)
        return LLMEngine(self.preset, params=params, device=self.device,
                         **self.engine_kw)

    async def __call__(self, payload: dict):
        model_id = get_multiplexed_model_id()
        engine = await self.get_engine(model_id)
        tokens = payload["tokens"]
        if isinstance(tokens, str):
            tokens = [b % self.cfg.vocab_size for b in tokens.encode()]
        async for tok in engine.generate(
                tokens,
                max_new_tokens=int(payload.get("max_new_tokens", 8)),
                temperature=float(payload.get("temperature", 0.0))):
            yield {"token": int(tok), "adapter": model_id}


def llm_app(preset: str = "debug", *, num_replicas: int = 1,
            max_ongoing_requests: int = 64, **engine_kw):
    """Build a Serve application hosting ``LlamaService`` (``engine_kw``
    reaches ``LLMEngine``: ``device``, ``params``, ``max_batch``, ...)."""
    from ray_tpu_torch.serve.deployment import deployment

    dep = deployment(
        LlamaService,
        num_replicas=num_replicas,
        max_ongoing_requests=max_ongoing_requests,
    )
    return dep.bind(preset, **engine_kw)


def lora_llm_app(preset: str = "debug", *, num_replicas: int = 1,
                 max_ongoing_requests: int = 16,
                 max_adapters_per_replica: int = 2, **engine_kw):
    """Serve application for multi-LoRA multiplexed serving; route
    requests with handle.options(multiplexed_model_id=<adapter>)."""
    from ray_tpu_torch.serve.deployment import deployment

    dep = deployment(
        MultiplexedLoraService,
        num_replicas=num_replicas,
        max_ongoing_requests=max_ongoing_requests,
    )
    return dep.bind(preset,
                    max_adapters_per_replica=max_adapters_per_replica,
                    **engine_kw)




# ---------------------------------------------------------------------------
# Disaggregated prefill/decode serving
# ---------------------------------------------------------------------------

PREFILL_REPLICAS_ENV = "RAYT_SERVE_PREFILL_REPLICAS"
DECODE_REPLICAS_ENV = "RAYT_SERVE_DECODE_REPLICAS"


def _pool_size(env: str, default: int) -> int:
    import os

    try:
        return max(1, int(os.environ.get(env, default)))
    except (TypeError, ValueError):
        return default


def _edge_kind(channel, spec) -> str:
    """Classify a KV-handoff edge for accounting: ``device`` when both
    sides share one process (same-process handoff, the tensors never
    leave the card), ``dcn`` when the transport spec rides the
    cross-host DCN store, ``shm`` for the same-host shared-memory ring."""
    from ray_tpu_torch.dag.device_channel import DeviceChannel

    if isinstance(channel, DeviceChannel):
        return "device"
    try:
        from ray_tpu_torch.dag.dcn_channel import DcnChannelSpec

        if isinstance(getattr(spec, "inner", None), DcnChannelSpec):
            return "dcn"
    except Exception:
        pass
    return "shm"


class PrefillWorker:
    """Prefill half of a disaggregated llm deployment (deploy via
    ``disagg_llm_app``). One call = one prompt's prefill: run it
    (chunked, prefix-cache included), then hand the finished KV rows to
    the caller's decode pool as ONE device-channel tick — raw host
    bytes over the framing in dag/device_channel.py, never a generic
    pickle of the tensors.

    Payload: ``{"tokens": [ids], "temperature": float,
    "chan": DeviceChannelSpec}`` — the decode side owns the channel and
    is already blocked on the read. Returns a handoff summary
    ``{"bytes", "edge_kind", "n_arrays", "bucket", "start"}``.
    """

    def __init__(self, preset: str = "debug", **engine_kw):
        self.engine = LLMEngine(preset, **engine_kw)

    async def __call__(self, payload: dict) -> dict:
        from ray_tpu_torch.dag.dcn_channel import attach_channel
        from ray_tpu_torch.dag.device_channel import tree_nbytes

        spec = payload["chan"]
        tokens = [int(t) for t in payload["tokens"]]
        handoff = await self.engine.prefill_only(
            tokens, temperature=float(payload.get("temperature", 0.0)))
        nbytes = int(tree_nbytes({"k": handoff["k"], "v": handoff["v"]}))
        loop = asyncio.get_running_loop()
        ch = await loop.run_in_executor(None, attach_channel, spec)
        kind = _edge_kind(ch, spec)
        try:
            # one tick, written from an executor thread (the ring may
            # block until the decode side frees a slot)
            await loop.run_in_executor(
                None, lambda: ch.write(dict(handoff), timeout=30.0))
            n_arrays = int(getattr(ch, "device_arrays", 0))
        finally:
            ch.close()
        try:
            from ray_tpu_torch.serve.request_context import current_request_obs

            obs = current_request_obs()
        except Exception:
            obs = None
        if obs is not None:
            obs["pool"] = "prefill"
            obs["kv_handoff_bytes"] = nbytes
            obs["kv_handoff_edge"] = kind
        return {"bytes": nbytes, "edge_kind": kind,
                "n_arrays": n_arrays, "bucket": int(handoff["bucket"]),
                "start": int(handoff["start"])}

    def stats(self) -> dict:
        return self.engine.stats()


class DecodeLlamaService:
    """Decode half of a disaggregated llm deployment: same request
    payload as LlamaService, but the prompt never runs here. Per
    request it creates a private shm ring, asks the prefill pool to
    fill it (the request id and trace carrier ride the composed handle
    call, so both pools' partial records coalesce into ONE waterfall),
    reads the KV rows as one tick, and decodes from them — long
    prefills can no longer dip this pool's decode-batch occupancy.
    """

    def __init__(self, prefill, preset: str = "debug", **engine_kw):
        self.engine = LLMEngine(preset, **engine_kw)
        self._prefill = prefill  # DeploymentHandle (composed app node)
        cfg = self.engine.cfg
        bucket = max(self.engine.prompt_buckets)
        # one tick = one prompt's k+v rows (+ pickle framing): assume
        # <=4-byte elements and pad 25% + 64KiB so the slot always fits
        kv = 2 * cfg.n_layers * bucket * cfg.n_kv_heads * cfg.head_dim * 4
        self._slot_size = kv + kv // 4 + (1 << 16)
        # the handoffs this pool read, for stats(): the call's wait
        # (the prefill pool's queue, its prefill and its write) and the
        # read's (the copy out of the ring, the rebuild on this engine's
        # device), both as awaited here, so they are what TTFT pays
        self._handoffs = {"reads": 0, "bytes": 0, "call_s": 0.0,
                          "read_s": 0.0, "on_engine_device": 0, "edges": {}}

    def _request_context(self, obs) -> Optional[dict]:
        if not obs or not obs.get("request_id"):
            return None
        return {"request_id": obs["request_id"], "trace": obs.get("trace")}

    async def __call__(self, payload: dict):
        from ray_tpu_torch.dag.channel import ShmChannel
        from ray_tpu_torch.dag.device_channel import (DeviceChannelSpec,
                                                      DeviceTransportChannel)

        tokens = payload["tokens"]
        if isinstance(tokens, str):  # raw byte-level "tokenizer"
            tokens = [b % self.engine.cfg.vocab_size
                      for b in tokens.encode()]
        try:
            from ray_tpu_torch.serve.request_context import current_request_obs

            obs = current_request_obs()
        except Exception:
            obs = None
        loop = asyncio.get_running_loop()
        # per-request ring: the shm channel is strictly SPSC, so each
        # handoff gets its own (decode owns it and unlinks on close)
        shm = await loop.run_in_executor(
            None, lambda: ShmChannel.create(
                slot_size=self._slot_size, n_slots=2))
        spec = DeviceChannelSpec(name=shm.spec.name, inner=shm.spec)
        ch = DeviceTransportChannel(shm, spec)
        try:
            handle = self._prefill
            rctx = self._request_context(obs)
            if rctx is not None:
                handle = handle.options(request_context=rctx)
            req = {"tokens": tokens, "chan": spec,
                   "temperature": float(payload.get("temperature", 0.0))}
            # summary first (it surfaces prefill errors with their real
            # traceback), then the tick — which is already in the ring,
            # the prefill side writes it before returning
            t0 = time.perf_counter()
            summary = await loop.run_in_executor(
                None, lambda: handle.remote(req).result(timeout=120.0))
            t1 = time.perf_counter()
            tick = await loop.run_in_executor(
                None, lambda: ch.read(timeout=30.0))
            t2 = time.perf_counter()
        finally:
            ch.close()
        self._count_handoff(summary, tick, t1 - t0, t2 - t1)
        if obs is not None:
            # kv_handoff_* stays OFF this side's record: the prefill
            # partial carries it, and the GCS derives the bytes counter
            # at partial ingest — a second stamp would double-count
            obs["pool"] = "decode"
        async for tok in self.engine.generate_prefilled(
                tokens,
                {k: tick[k] for k in ("k", "v", "first", "bucket",
                                      "start")},
                max_new_tokens=int(payload.get("max_new_tokens", 32)),
                temperature=float(payload.get("temperature", 0.0))):
            yield {"token": int(tok)}

    def _count_handoff(self, summary: dict, tick: dict, call_s: float,
                       read_s: float):
        h = self._handoffs
        h["reads"] += 1
        h["bytes"] += int(summary["bytes"])
        h["call_s"] += call_s
        h["read_s"] += read_s
        kind = summary["edge_kind"]
        h["edges"][kind] = h["edges"].get(kind, 0) + 1
        h["on_engine_device"] += all(
            tick[k].device.type == self.engine.device.type
            for k in ("k", "v"))

    def stats(self) -> dict:
        """The engine's counters, and the handoffs read here: count,
        bytes, seconds awaited in the call and in the read, reads whose
        rows landed on the engine's device, reads by edge kind, and the
        ring's slot bytes (2 slots a request in flight)."""
        h = self._handoffs
        return {**self.engine.stats(),
                **{f"handoff_{k}": v for k, v in h.items() if k != "edges"},
                "handoff_edges": dict(h["edges"]),
                "handoff_slot_bytes": self._slot_size}


def disagg_llm_app(preset: str = "debug", *,
                   prefill_replicas: int | None = None,
                   decode_replicas: int | None = None,
                   max_ongoing_requests: int = 64, **engine_kw):
    """Serve application with disaggregated prefill/decode pools: the
    decode pool is the ingress; each request's prefill runs in the
    prefill pool and hands its KV rows over a device-channel edge. Pool
    sizes default from RAYT_SERVE_PREFILL_REPLICAS /
    RAYT_SERVE_DECODE_REPLICAS (1 each). Both pools build identical
    weights (same preset + seed), so KV rows graft across them."""
    from ray_tpu_torch.serve.deployment import deployment

    if prefill_replicas is None:
        prefill_replicas = _pool_size(PREFILL_REPLICAS_ENV, 1)
    if decode_replicas is None:
        decode_replicas = _pool_size(DECODE_REPLICAS_ENV, 1)
    prefill_dep = deployment(
        PrefillWorker, num_replicas=prefill_replicas,
        max_ongoing_requests=max_ongoing_requests)
    decode_dep = deployment(
        DecodeLlamaService, num_replicas=decode_replicas,
        max_ongoing_requests=max_ongoing_requests)
    return decode_dep.bind(prefill_dep.bind(preset, **engine_kw),
                           preset, **engine_kw)
