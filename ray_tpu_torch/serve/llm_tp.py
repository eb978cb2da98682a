"""The ranks of a tensor-parallel ``LLMEngine`` (``tp`` above 1; the
counterpart of the reference engine's ``{"data": 1, "tensor": tp}`` mesh,
ray_tpu/serve/llm.py:107-145).

The port runs one process per rank. Rank 0 is the engine's own process: it
owns the asyncio loop, admission, the prefill chunks, the prefix store, the
slot ring and sampling. Ranks 1..tp-1 are follower processes the engine
starts (``python -m ray_tpu_torch.serve.llm_tp``) and owns, each pinned to
one card of the engine's lease (``CUDA_VISIBLE_DEVICES``). The ranks form a
process group of the engine's own (``parallel.mesh.new_group``: its own
store and address; NCCL for the card, gloo for ``device="cpu"``) and a
``{"data": 1, "tensor": tp}`` mesh over it (``GroupMesh``). The default
process group is never touched, so several such engines, and a training
mesh, live in one process at once. Rank 0 hands each rank
the full params once; every rank keeps its shards by
``param_logical_axes`` (and ``lora_logical_axes`` for an adapter subtree)
and a KV cache of ``n_kv_heads / tp`` heads (``kv_cache_logical_axes``).

Every write the engine makes to its KV caches is an op run on every rank:
rank 0 queues it (``TensorRanks.send``) and runs it itself; a decode or
prefill step sends the queue, the step's tokens last, in one broadcast, and
every rank then runs the same ``llama.decode_step`` under the mesh's
sharding context (its collectives pair up across the ranks). Rank 0 names
each cache by a handle (``_Cache.hid``); a follower keeps its own twin of
each, and drops it when rank 0's is collected.

A KV handoff (``prefill_only`` / ``generate_prefilled``) carries every kv
head, in the tp=1 layout: rank 0 gathers the ranks' heads of a finished
prefill over the group (``TensorRanks.gather_rows``), and scatters a
payload's heads to the ranks before it is inserted (``scatter_rows``).

A follower that dies fails the engine: every later op raises an error that
names it, checked before each step, and a step that a dead peer broke
raises that error too. A follower exits when rank 0's process does.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
import weakref

import torch

from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel.mesh import CommandGroup

# how long the ranks wait for each other to form the group
TP_GROUP_TIMEOUT_S = 120.0


class FollowerDied(RuntimeError):
    """A follower rank of a tensor-parallel engine is gone."""


def _peer_error(e: BaseException) -> bool:
    text = str(e)
    return "closed by peer" in text or "Connection reset" in text \
        or "Broken pipe" in text


class _Cache(dict):
    """A KV cache of rank 0, with the handle its twins answer to."""

    __slots__ = ("hid", "__weakref__")


class _Ref:
    """A cache argument on the wire: its handle."""

    __slots__ = ("hid",)

    def __init__(self, hid: int):
        self.hid = hid


# ------------------------------------------------------------------ cache ops
# run alike on every rank (rank 0's engine calls them through its _dev)

def new_cache(cfg, device, kv_heads: int, batch: int, max_len: int,
              per_row: bool) -> dict:
    """A zeroed cache of this rank's kv heads; per-row depths for the
    decode ring (``length`` [batch])."""
    cache = llama.init_kv_cache(cfg, batch, max_len=max_len, device=device,
                                n_kv_heads=kv_heads)
    if per_row:
        cache["length"] = torch.zeros((batch,), dtype=torch.int32,
                                      device=device)
    return cache


def fill(cache: dict, key: str, value: int) -> None:
    cache[key].fill_(value)


def graft(small: dict, src: dict, off: int, e_off: int, matched: int):
    """Copy `matched` KV rows of a stored prefill into a fresh per-request
    cache at absolute position `off` and advance its write cursor."""
    for k in ("k", "v"):
        small[k][:, :, off:off + matched].copy_(
            src[k][:, :, e_off:e_off + matched])
    small["length"].fill_(off + matched)


def insert(dst: dict, src: dict, slot: int, length: int, start: int):
    """Copy a prefilled request's KV rows into `slot` of the decode cache
    and reset that row's depth and start."""
    n = src["k"].shape[2]
    dst["k"][:, slot, :n].copy_(src["k"][:, 0])
    dst["v"][:, slot, :n].copy_(src["v"][:, 0])
    dst["length"][slot] = length
    dst["start"][slot] = start


def mask(cache: dict, live) -> None:
    """Free and reserved rows stay at depth 0."""
    cache["length"].mul_(live)


CACHE_OPS = {"fill": fill, "graft": graft, "insert": insert, "mask": mask}

# the kv-head dim of a cache's k and v ([n_layers, batch, max_len, heads, d])
KV_HEAD_AXIS = 3


# -------------------------------------------------------------- the ranks
def _card_ids(device: torch.device, tp: int) -> list[str] | None:
    """The CUDA_VISIBLE_DEVICES names of the cards the ranks take, rank 0's
    first (it keeps its process's cuda:0): the lease's cards in a worker
    (a worker leased no GPU raises: no card is its own), else the cards
    this process sees. None on the CPU."""
    if device.type != "cuda":
        return None
    from ray_tpu_torch._internal.accelerators import (_in_lease_without_gpu,
                                                     _lease_gpu_ids)

    if _in_lease_without_gpu():
        raise ValueError(
            f"tp={tp} on the card in a worker whose lease holds no GPU: "
            f"lease the {tp} cards (num_gpus={tp}, as llm_app(tp=...) does)")
    ids = list(_lease_gpu_ids())
    if not ids:
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        ids = ([e.strip() for e in visible.split(",") if e.strip()]
               if visible is not None
               else [str(i) for i in range(torch.cuda.device_count())])
    if len(ids) < tp:
        raise ValueError(f"tp={tp} needs {tp} cards; this process sees "
                         f"{len(ids)} ({','.join(ids) or 'none'})")
    return ids[:tp]


def _mesh_and_sharding(group, tp: int, layout_axes: dict):
    from ray_tpu_torch.parallel.mesh import GroupMesh, Sharded, shard_params

    mesh = GroupMesh(group, {"data": 1, "tensor": tp})
    shardings = shard_params(None, layout_axes, mesh)

    def specs(node):
        return ({k: specs(v) for k, v in node.items()}
                if isinstance(node, dict) else node.spec)

    return mesh, shardings, Sharded(mesh, layout_axes, specs(shardings))


def logical_axes(cfg, params: dict) -> dict:
    """The logical axes the engine shards its params by: the model's, and
    the adapter subtree's when the params carry one (the reference's
    engine, ray_tpu/serve/llm.py:125-139)."""
    from ray_tpu_torch.models import lora as lora_mod

    axes = llama.param_logical_axes(cfg)
    if "lora" in params:
        layers = params["lora"]["layers"]
        targets = lora_mod.lora_targets(layers)
        rank = layers[targets[0] + "_a"].shape[-1]
        axes = {**axes, "lora": lora_mod.lora_logical_axes(
            cfg, lora_mod.LoraConfig(rank=int(rank), alpha=cfg.lora_alpha,
                                     targets=targets))}
    return axes


def _flat(tree: dict, prefix=()) -> list:
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _flat(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _local_params(full: list, shardings: dict) -> dict:
    """[(path, full tensor)] -> this rank's shards, as a params tree."""
    out: dict = {}
    for path, t in full:
        s = shardings
        for k in path:
            s = s[k]
        _set(out, path, s.local(t).clone())
    return out


class _Group(CommandGroup):
    """A rank of the engine's group: the mesh, this rank's param shards and
    the sharding context decode_step runs in."""

    def __init__(self, rank: int, tp: int, address: str, device):
        super().__init__(tp, rank, address, device, TP_GROUP_TIMEOUT_S)
        self.tp = tp

    def setup(self, cfg=None, params: dict | None = None):
        """Rank 0 gives the config and the full params, every rank keeps
        its shards -> (cfg, params shards)."""
        head = None
        if self.rank == 0:
            head = (cfg, logical_axes(cfg, params),
                    [(p, tuple(t.shape), t.dtype) for p, t in _flat(params)])
        cfg, axes, layout = self.objects(head)
        self.mesh, shardings, self.sharded = _mesh_and_sharding(
            self.group, self.tp, axes)
        full = dict(_flat(params)) if self.rank == 0 else {}
        leaves = [(path, self.broadcast(full.get(path), shape, dtype))
                  for path, shape, dtype in layout]
        return cfg, _local_params(leaves, shardings)


class TensorRanks:
    """Rank 0's side: starts the followers, forms the group, hands out the
    params, and sends the ops. Raises ``FollowerDied`` once a follower is
    gone."""

    def __init__(self, tp: int, device: torch.device, cfg, params: dict):
        from ray_tpu_torch._internal.spawn import child_env, fast_python_argv
        from ray_tpu_torch.parallel.mesh import free_address

        for name, n in (("n_heads", cfg.n_heads),
                        ("n_kv_heads", cfg.n_kv_heads)):
            if n % tp:
                raise ValueError(f"tp={tp} does not divide {name}={n}")
        cards = _card_ids(device, tp)
        address = free_address("127.0.0.1")
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        self._procs: list[subprocess.Popen] = []
        self._pending: list = []
        self._freed: list[int] = []
        self._next_hid = 0
        self._dead: FollowerDied | None = None
        self._closed = False
        try:
            for rank in range(1, tp):
                env = child_env(pkg_root)
                if cards is not None:
                    env["CUDA_VISIBLE_DEVICES"] = cards[rank]
                self._procs.append(subprocess.Popen(
                    fast_python_argv("ray_tpu_torch.serve.llm_tp")
                    + [str(rank), str(tp), address, device.type,
                       str(os.getpid())],
                    env=env, stdin=subprocess.DEVNULL))
            self._group = _Group(0, tp, address, device)
            self.cfg, self.params = self._group.setup(cfg, params)
        except BaseException:
            self._kill()
            raise
        self.tp = tp
        self.sharded = self._group.sharded

    # ----------------------------------------------------------- liveness
    def check(self) -> None:
        """Raise FollowerDied when a follower has exited."""
        if self._dead is not None:
            raise self._dead
        for rank, p in enumerate(self._procs, start=1):
            code = p.poll()
            if code is not None:
                self._dead = FollowerDied(
                    f"tensor-parallel follower rank {rank} (pid {p.pid}) "
                    f"exited with code {code}")
                raise self._dead

    def pids(self) -> list[int]:
        return [p.pid for p in self._procs]

    # ----------------------------------------------------------------- ops
    def track(self, cache: dict, batch: int, max_len: int,
              per_row: bool) -> _Cache:
        """A new cache of rank 0, made on every rank."""
        out = _Cache(cache)
        out.hid = self._next_hid
        self._next_hid += 1
        weakref.finalize(out, self._freed.append, out.hid)
        self._pending.append(("new", (out.hid, batch, max_len, per_row)))
        return out

    def _wire(self, a):
        if isinstance(a, _Cache):
            return _Ref(a.hid)
        if isinstance(a, torch.Tensor):
            return a.detach().cpu().numpy()
        return a

    def send(self, op: str, *args) -> None:
        """Queue an op for the followers (rank 0 runs it itself)."""
        self._pending.append((op, tuple(self._wire(a) for a in args)))

    def step(self, cache: _Cache, tokens) -> None:
        """Send the queued ops and a decode_step of `tokens` on `cache`:
        the followers start it as rank 0 does."""
        self.check()
        self._pending.append(("step", (_Ref(cache.hid), self._wire(tokens))))
        self._flush()

    def _flush(self) -> None:
        ops, self._pending = self._pending, []
        freed = []
        while self._freed:          # finalizers append from any thread
            freed.append(self._freed.pop())
        try:
            self._group.objects((freed, ops))
        except Exception as e:
            self.check()
            raise RuntimeError(f"tensor-parallel op broadcast failed: {e}"
                               ) from e

    def _collective(self, op: str, cache: _Cache, fn):
        """Send the queued ops and `op` on `cache`, then run `fn` (rank 0's
        side of the collective the followers run for `op`)."""
        self.check()
        self._pending.append((op, (_Ref(cache.hid),)))
        self._flush()
        try:
            return fn()
        except BaseException as e:
            raise self.collective_failed(e) from e

    def gather_rows(self, cache: _Cache) -> tuple:
        """(k, v) of `cache` with every rank's kv heads, in rank order
        (the tp=1 layout); new tensors, which no later step writes."""
        return self._collective("gather", cache, lambda: tuple(
            self._group.gather(cache[k], KV_HEAD_AXIS) for k in ("k", "v")))

    def scatter_rows(self, cache: _Cache, k, v) -> None:
        """Write each rank's kv heads of the full-head rows `k`, `v` into
        its twin of `cache` (rank 0's into `cache`)."""
        def run():
            for name, full in (("k", k), ("v", v)):
                cache[name].copy_(self._group.scatter(
                    full, KV_HEAD_AXIS, full.shape, full.dtype))
        self._collective("scatter", cache, run)

    def collective_failed(self, e: BaseException) -> BaseException:
        """The error to report for a step that raised: the follower's
        death when one died (a peer's closed connection can reach rank 0
        a moment before its exit does)."""
        deadline = time.monotonic() + 2.0
        while True:
            try:
                self.check()
            except FollowerDied as dead:
                return dead
            if time.monotonic() > deadline or not _peer_error(e):
                return e
            time.sleep(0.05)

    def close(self) -> None:
        """End the followers and the group."""
        if self._closed:
            return
        self._closed = True
        try:
            if self._dead is None and all(p.poll() is None
                                          for p in self._procs):
                self._pending.append(("stop", ()))
                self._flush()
        except Exception:
            pass
        deadline = time.monotonic() + 10
        for p in self._procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        self._kill()
        try:
            self._group.close()
        except Exception:
            pass

    def _kill(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                p.kill()
            try:
                p.wait(timeout=5)
            except Exception:
                pass


# ------------------------------------------------------------ the followers
def _watch_parent(parent: int) -> None:
    """End this follower when the engine's process is gone (a collective
    on a dead NCCL peer would wait forever)."""
    def run():
        while True:
            if os.getppid() != parent:
                os._exit(3)
            time.sleep(0.5)

    threading.Thread(target=run, daemon=True).start()


def follow(rank: int, tp: int, address: str, device_type: str) -> None:
    """A follower rank: join the group, take its shards, then run rank 0's
    ops until it says stop."""
    device = torch.device("cuda" if device_type == "cuda" else "cpu")
    group = _Group(rank, tp, address, device)
    try:
        cfg, params = group.setup()
        kv_heads = cfg.n_kv_heads // tp
        caches: dict[int, dict] = {}

        def arg(a):
            if isinstance(a, _Ref):
                return caches[a.hid]
            if hasattr(a, "dtype") and hasattr(a, "shape"):   # numpy
                return torch.from_numpy(a.copy()).to(device)
            return a

        from ray_tpu_torch.parallel.mesh import use_sharding

        with torch.inference_mode():
            while True:
                try:
                    freed, ops = group.objects()
                except RuntimeError as e:
                    if _peer_error(e):
                        return        # rank 0's process ended
                    raise
                for op, args in ops:
                    if op == "stop":
                        return
                    if op == "new":
                        hid, batch, max_len, per_row = args
                        caches[hid] = new_cache(cfg, device, kv_heads, batch,
                                                max_len, per_row)
                    elif op == "gather":
                        for k in ("k", "v"):
                            group.gather(arg(args[0])[k], KV_HEAD_AXIS)
                    elif op == "scatter":
                        cache = arg(args[0])
                        for k in ("k", "v"):
                            local = cache[k]
                            full = list(local.shape)
                            full[KV_HEAD_AXIS] *= tp
                            local.copy_(group.scatter(
                                None, KV_HEAD_AXIS, full, local.dtype))
                    elif op == "step":
                        cache, tokens = arg(args[0]), arg(args[1])
                        if tokens.dim() == 1:
                            tokens = tokens[:, None]
                        with use_sharding(group.sharded):
                            llama.decode_step(params, cache, tokens, cfg)
                    else:
                        CACHE_OPS[op](*(arg(a) for a in args))
                # after the ops: a cache rank 0 dropped since its last send
                # may still be read by one of them (the insert of a prefill)
                for hid in freed:
                    caches.pop(hid, None)
    finally:
        group.close()


if __name__ == "__main__":
    # run the package's module, not this __main__ copy: the ops' wire
    # classes must be the ones rank 0 pickles
    from ray_tpu_torch.serve import llm_tp as _module

    _rank, _tp, _address, _device, _parent = sys.argv[1:6]
    _module._watch_parent(int(_parent))
    _module.follow(int(_rank), int(_tp), _address, _device)
