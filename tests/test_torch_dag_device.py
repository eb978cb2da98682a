"""Device edges of the port's compiled DAGs (ray_tpu_torch.dag) on CPU
tensors, held against the JAX package (ray_tpu.dag) on the same numpy
payloads.

Torch twins of tests/test_dag_device.py's 16 tests (whose bodies run jax),
and of the re-pointed reference tests that tests/torch_repoint.py's
DESELECT leaves out for a jax body (test_dag_dcn's mixed-kind graph,
test_device_objects' jnp payloads). The code paths are the ones the card
runs — pack, out-of-band raw bytes, the rebuild on the consumer's device
(the CPU here), the same-process handoff, donation vectors, the lowering of
DAG collectives — with CPU tensors in place of CUDA ones.

Parity: the RL-shaped payload of test_pack_device_tree_covers_rl_shaped_
payloads packed and rebuilt by both packages over a shm ring gives equal
values and equal leaf counts; donation_argnums_for and mesh_shared give the
same answers; a two-actor allreduce over the port's channel path equals
ray_tpu's on the same inputs (run in a subprocess with its own cluster),
exactly for integers.
"""

from __future__ import annotations

import collections
import gc
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.dag import channel as jchannel
from ray_tpu.dag import collective as jcollective
from ray_tpu.dag import device_channel as jdevice
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.dag import InputNode, MultiOutputNode, collective
from ray_tpu_torch.dag import channel as tchannel
from ray_tpu_torch.dag import device_channel as tdevice
from ray_tpu_torch.dag.channel import ChannelClosed, ShmChannel
from ray_tpu_torch.dag.channel_exec import ChannelCompiledDAG
from ray_tpu_torch.dag.device_channel import (DeviceChannel, DeviceChannelSpec,
                                              DeviceTransportChannel,
                                              attach_device,
                                              donation_argnums_for,
                                              donating_jit, pack_device_tree,
                                              wrap_host_arrays)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def local_cluster():
    """A started single-node cluster, shut down after the test."""
    rt.init(num_cpus=4)
    try:
        yield rt
    finally:
        rt.shutdown()


def _kill(*actors):
    for a in actors:
        try:
            rt.kill(a)
        except Exception:
            pass


# ------------------------------------------------- same-process channel

def test_device_channel_same_process_handoff_is_zero_copy_torch():
    """A same-process device edge hands the tensor OBJECT over: the
    consumer reads the very tensor written, same storage."""
    ch = DeviceChannel.create(n_slots=4)
    peer = attach_device(ch.spec)
    try:
        t = torch.arange(256, dtype=torch.float32)
        ch.write(t)
        out = peer.read(timeout=5)
        assert out is t and out.data_ptr() == t.data_ptr()
        assert ch.device_arrays == 1
        assert ch.stats.writes == 1 and peer.stats.reads == 1
        assert ch.stats.bytes_written == t.nbytes
    finally:
        peer.close()
        ch.close()


def test_device_channel_backpressure_and_close_torch():
    ch = DeviceChannel.create(n_slots=2)
    peer = attach_device(ch.spec)
    t = torch.zeros(8)
    ch.write(t)
    ch.write(t)
    with pytest.raises(TimeoutError):
        ch.write(t, timeout=0.2)               # handoff full: blocks
    assert ch.occupancy() == 2
    peer.read(timeout=5)
    ch.write(t, timeout=5)                     # room again
    ch.close()
    ch.close()                                 # idempotent
    peer.read(timeout=5)                       # buffered items drain...
    peer.read(timeout=5)
    with pytest.raises(ChannelClosed):
        peer.read(timeout=5)                   # ...then close surfaces
    with pytest.raises(ChannelClosed):
        ch.write(t, timeout=1)                 # writes refuse after close
    with pytest.raises(ChannelClosed):
        attach_device(DeviceChannelSpec(name=ch.spec.name, inner=None))


def test_device_channel_close_drains_buffered_items_first_torch():
    ch = DeviceChannel.create(n_slots=4)
    peer = attach_device(ch.spec)
    ch.write(torch.ones(4))
    ch.close()
    assert float(peer.read(timeout=5).sum()) == 4.0
    with pytest.raises(ChannelClosed):
        peer.read(timeout=5)
    peer.close()


# ---------------------------------------------------- payload framing

def _rl_payload_np(seed: int = 0) -> tuple[dict, list]:
    """test_pack_device_tree_covers_rl_shaped_payloads's payload as numpy
    from a seed, and which leaves are device leaves (the rest stay numpy
    or host lists)."""
    rng = np.random.default_rng(seed)
    batch = {"obs": rng.standard_normal((4, 8, 4)).astype(np.float32),
             "actions": rng.integers(0, 4, (4, 8)).astype(np.int32),
             "rewards": rng.standard_normal((4, 8)).astype(np.float32),
             "episode_returns": [1.0, 2.0]}
    weights = {"pi": {"w": rng.standard_normal((4, 2)).astype(np.float32),
                      "b": rng.standard_normal((2,)).astype(np.float32)},
               "v": [rng.standard_normal((4,)).astype(np.float32),
                     np.zeros((3,))]}
    payload = {"aux": {"loss": 0.5}, "updates": 1, "weights": weights,
               "batches": [[batch], []]}
    return payload, [("batches", 0, 0, "obs"), ("batches", 0, 0, "actions"),
                     ("batches", 0, 0, "rewards"), ("weights", "pi", "w"),
                     ("weights", "pi", "b"), ("weights", "v", 0)]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path, value):
    _get(tree, path[:-1])[path[-1]] = value


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tree


def _as_np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    if isinstance(v, jax.Array):
        return np.asarray(v)
    return v


def _ring_roundtrip(shm_mod, dev_mod, payload):
    inner = shm_mod.ShmChannel.create(slot_size=1 << 20, n_slots=2)
    peer = shm_mod.ShmChannel.attach(inner.spec)
    spec = dev_mod.DeviceChannelSpec(name=inner.spec.name, inner=inner.spec)
    prod = dev_mod.DeviceTransportChannel(inner, spec)
    cons = dev_mod.DeviceTransportChannel(peer, spec)
    try:
        prod.write(payload, timeout=5)
        return cons.read(timeout=5), prod.device_arrays
    finally:
        cons.close()
        prod.close()


def test_pack_device_tree_covers_rl_shaped_payloads_torch():
    """Packing the RL tick payload leaves no tensor in the skeleton; both
    packages pack the same leaves and rebuild equal values over a shm
    ring."""
    np_payload, device_paths = _rl_payload_np()
    tpay, jpay = _rl_payload_np()[0], _rl_payload_np()[0]
    for path in device_paths:
        _put(tpay, path, torch.from_numpy(_get(np_payload, path).copy()))
        _put(jpay, path, jnp.asarray(_get(np_payload, path)))
    packed, n = pack_device_tree(tpay)
    jpacked, jn = jdevice.pack_device_tree(jpay)
    assert n == jn == 6
    assert not any(isinstance(v, torch.Tensor) for _, v in _flat(packed))
    assert isinstance(packed["weights"]["v"][1], np.ndarray)
    host_only = {"a": np.zeros(4), "b": [1, 2]}
    same, n0 = pack_device_tree(host_only)
    assert n0 == 0 and same is host_only

    got, sent = _ring_roundtrip(tchannel, tdevice, tpay)
    want, jsent = _ring_roundtrip(jchannel, jdevice, jpay)
    assert sent == jsent == 6
    flat_got, flat_want = dict(_flat(got)), dict(_flat(want))
    assert flat_got.keys() == flat_want.keys()
    for path, v in flat_got.items():
        w = flat_want[path]
        assert isinstance(v, torch.Tensor) == (path in device_paths)
        assert isinstance(w, jax.Array) == (path in device_paths)
        np.testing.assert_array_equal(_as_np(v), _as_np(w))
        if path in device_paths:
            assert str(v.dtype).removeprefix("torch.") == str(w.dtype)


def test_pack_roundtrip_rebuilds_on_device_torch():
    """serialize(pack(tree)) -> deserialize rebuilds tensors with equal
    contents and dtypes (bf16 by its bits); the pickle stream carries only
    metadata."""
    from ray_tpu_torch._internal.serialization import (chunks_to_bytes,
                                                       deserialize, serialize)

    x = torch.arange(1024, dtype=torch.float32).reshape(32, 32)
    h = torch.linspace(-3, 3, 96, dtype=torch.bfloat16).reshape(4, 24)
    packed, n = pack_device_tree({"x": x, "h": h, "tag": "t"})
    assert n == 2
    chunks = serialize(packed)
    assert len(chunks[1]) < x.nbytes          # bytes ride out of band
    out = deserialize(chunks_to_bytes(chunks))
    assert torch.equal(out["x"], x) and out["x"].dtype == torch.float32
    assert out["h"].dtype == torch.bfloat16
    assert torch.equal(out["h"].view(torch.int16), h.view(torch.int16))
    assert out["tag"] == "t"


def test_device_transport_over_shm_ring_releases_slots_torch():
    """Cross-process framing over a shm ring: values rebuild as tensors
    on read, never aliasing the ring (the read copies the slot out), so
    a 2-slot ring runs 6 ticks while every rebuilt value is held, and
    a held value does not change when later ticks reuse its slot."""
    inner = ShmChannel.create(slot_size=1 << 20, n_slots=2)
    peer = ShmChannel.attach(inner.spec)
    spec = DeviceChannelSpec(name=inner.spec.name, inner=inner.spec)
    prod = DeviceTransportChannel(inner, spec)
    cons = DeviceTransportChannel(peer, spec)
    try:
        held = []
        for i in range(6):
            prod.write({"x": torch.full((128,), float(i))}, timeout=5)
            v = cons.read(timeout=5)
            assert isinstance(v["x"], torch.Tensor)
            assert float(v["x"][0]) == float(i)
            held.append(v)
        assert peer.pinned_slots() == 0
        assert [float(v["x"][0]) for v in held] == [0.0, 1.0, 2.0, 3.0,
                                                    4.0, 5.0]
        held[0]["x"].add_(1.0)                  # a rebuilt tensor is writable
        assert prod.device_arrays == 6
        snap = prod.snapshot()
        assert snap["device_arrays"] == 6
        assert snap["writes"] == 6 and snap["bytes_written"] > 0
    finally:
        cons.close()
        prod.close()


def test_wrap_host_arrays_rebuilds_numpy_as_tensors():
    """The weight-broadcast producer path: numpy leaves ride the device
    framing as they are and rebuild as tensors of the same dtype."""
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "ids": np.arange(4, dtype=np.int64), "tag": "x"}
    wrapped, n = wrap_host_arrays(tree)
    assert n == 2
    got, _ = _ring_roundtrip(tchannel, tdevice, wrapped)
    assert got["ids"].dtype == torch.int64 and got["tag"] == "x"
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"])


def test_perf_device_legs_run_where_asked_and_say_so():
    """_internal/perf's device legs make their tensors on the device they
    are given, here the CPU on purpose, and each record names it."""
    from ray_tpu_torch._internal import perf

    records = perf._device_legs(torch.device("cpu"), 0.05)
    assert [r["benchmark"] for r in records] == [
        "dag_device_ticks_per_second", "dag_device_gigabytes_per_second"]
    assert all(r["device"] == "cpu" and r["rate_per_s"] > 0
               for r in records)


# -------------------------------------------------------- DAG compile

def test_dag_device_edge_end_to_end_torch(local_cluster):
    """A .with_tensor_transport() edge compiles to kind=device, the
    consumer receives tensors, and teardown closes each driver-held
    channel exactly once."""
    @rt.remote
    class Prod:
        def make(self, x):
            import torch

            return {"w": torch.arange(16, dtype=torch.float32) * x}

    @rt.remote
    class Cons:
        def consume(self, d):
            import torch

            assert isinstance(d["w"], torch.Tensor), type(d["w"])
            return float(d["w"].sum())

    p, c = Prod.remote(), Cons.remote()
    with InputNode() as inp:
        out = c.consume.bind(p.make.bind(inp).with_tensor_transport())
    dag = out.experimental_compile(channels=True)
    assert isinstance(dag, ChannelCompiledDAG)
    assert dag.channel_kinds == {"shm": 2, "dcn": 0, "device": 1}
    assert dag.execute(2).get(timeout=60) == 240.0
    assert dag.execute(3).get(timeout=60) == 360.0
    calls = collections.Counter()
    for ch in dag._driver_channels:
        def _patched(_ch=ch, _orig=ch.close):
            if not getattr(_ch, "_closed_locally", False):
                calls.update([id(_ch)])
            return _orig()

        ch.close = _patched
    dag.teardown()
    dag.teardown()
    assert len(calls) == len(dag._driver_channels)
    assert all(v == 1 for v in calls.values()), calls
    _kill(p, c)


def test_dag_device_input_edges_broadcast_weights_torch(local_cluster):
    """device_input=True: the driver's input edges ship tensor weights as
    raw bytes and each consumer rebuilds them as tensors."""
    @rt.remote
    class Runner:
        def tick(self, weights):
            import torch

            if weights is None:
                return -1.0
            assert isinstance(weights["w"], torch.Tensor)
            return float(weights["w"].sum())

    r1, r2 = Runner.remote(), Runner.remote()
    with InputNode() as inp:
        dag = MultiOutputNode(
            [r1.tick.bind(inp), r2.tick.bind(inp)]).experimental_compile(
                channels=True, device_input=True)
    assert isinstance(dag, ChannelCompiledDAG)
    assert dag.channel_kinds["device"] == 2
    try:
        assert dag.execute({"w": torch.ones(8)}).get(timeout=60) == [8.0, 8.0]
        assert dag.execute(None).get(timeout=60) == [-1.0, -1.0]
        assert sum(ch.device_arrays
                   for ch in dag._device_input_channels) == 2
    finally:
        dag.teardown()
        _kill(r1, r2)


# ------------------------------------------------------------ donation

def test_donation_vector_from_edge_arity_torch():
    """donation_argnums_for gives ray_tpu's tuples; donating_jit keeps the
    reference's signature, records the vector and calls the function."""
    for n, offset in ((3, 0), (1, 2), (0, 1), (4, 3)):
        assert (donation_argnums_for(n, offset=offset)
                == jdevice.donation_argnums_for(n, offset=offset))

    def f(params, batch):
        return {k: v + batch for k, v in params.items()}

    step = donating_jit(f, n_edge_args=1, offset=1, extra_donate=(0,))
    assert step.donate_argnums == (0, 1) and step.__name__ == "f"
    out = step({"w": torch.ones(4)}, torch.full((4,), 2.0))
    assert torch.equal(out["w"], torch.full((4,), 3.0))


# ---------------------------------------------------- in-mesh lowering

_FINGERPRINTS = {
    "two ranks of one 2-card set": [(0, 2, ("H100_0", "H100_1"), 1),
                                    (1, 2, ("H100_0", "H100_1"), 1)],
    "world of one": [(0, 1, ("cpu",), 1)],
    "one rank of four alone": [(0, 4, ("H100_0", "H100_1"), 1)],
    "CPU fleet": [(0, 1, ("cpu",), 1), (0, 1, ("cpu",), 1)],
    "different views": [(0, 2, ("H100_0",), 1),
                        (1, 2, ("H100_0", "H100_1"), 1)],
    "two cards a rank": [(0, 2, ("H100_0", "H100_1"), 2),
                         (1, 2, ("H100_0", "H100_1"), 2)],
    "duplicate ranks": [(0, 2, ("H100_0", "H100_1"), 1),
                        (0, 2, ("H100_0", "H100_1"), 1)],
    "no view": [None, (1, 2, ("H100_0", "H100_1"), 1)],
}


def test_mesh_shared_detection_torch():
    from ray_tpu_torch.dag.collective import mesh_shared

    verdicts = {k: mesh_shared(v) for k, v in _FINGERPRINTS.items()}
    assert verdicts == {k: jcollective.mesh_shared(v)
                        for k, v in _FINGERPRINTS.items()}
    assert [k for k, v in verdicts.items() if v] == [
        "two ranks of one 2-card set", "world of one"]


def test_client_fingerprint_reads_the_torch_view():
    """Without a process group a process is a world of one; its devices
    are the CPU until it has initialised CUDA."""
    from ray_tpu_torch.dag.collective import client_fingerprint, mesh_shared

    fp = client_fingerprint()
    want = ((0, 1, ("cpu",), 1) if not torch.cuda.is_initialized()
            else (0, 1, tuple(torch.cuda.get_device_name(i) for i in
                              range(torch.cuda.device_count())),
                  torch.cuda.device_count()))
    assert fp == want and mesh_shared([fp])


def test_in_mesh_allreduce_world_one_stays_on_device_torch():
    from ray_tpu_torch.dag.collective import (in_mesh_allgather,
                                              in_mesh_allreduce)

    x = torch.arange(8, dtype=torch.float32)
    out = in_mesh_allreduce(x, "sum")
    assert out is x                            # the same tensor, in place
    gathered = in_mesh_allgather(x)
    assert len(gathered) == 1 and gathered[0] is x
    assert torch.equal(in_mesh_allreduce(np.arange(3), "max"),
                       torch.arange(3))
    with pytest.raises(ValueError):
        in_mesh_allreduce(x, "median")


def test_in_mesh_over_processes_names_item_6():
    """More than one rank in the in-mesh tier is NCCL between cards: not
    ported, and it says which ROADMAP item brings it."""
    from ray_tpu_torch.dag.collective import (_in_mesh_stack_gather,
                                              _in_mesh_stack_reduce)

    x = torch.arange(16, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="item 6"):
        _in_mesh_stack_reduce(x, "sum")
    with pytest.raises(NotImplementedError, match="item 6"):
        _in_mesh_stack_gather(x)


def test_in_mesh_equals_out_of_band_fallback_torch(local_cluster):
    """A single-participant allreduce through the channel path (a world of
    one with a tensor: in-mesh, the tensor returned as it is) equals the
    per-call fallback's out-of-band one-shot group."""
    @rt.remote
    class W:
        def grad(self, x):
            import torch

            return torch.full((4,), float(3 * x))

    a = W.remote()
    with InputNode() as inp:
        (r,) = collective.allreduce.bind([a.grad.bind(inp)], op="sum")
        dag = r.experimental_compile(channels=True)
    assert isinstance(dag, ChannelCompiledDAG)
    try:
        in_mesh_out = dag.execute(2).get(timeout=60)
    finally:
        dag.teardown()
    assert isinstance(in_mesh_out, torch.Tensor)

    b = W.remote()
    with InputNode() as inp:
        (r2,) = collective.allreduce.bind([b.grad.bind(inp)], op="sum")
        fallback = r2.experimental_compile(channels=False)
    fallback_out = np.asarray(fallback.execute(2).get(timeout=60))
    np.testing.assert_array_equal(in_mesh_out.numpy(), fallback_out)
    np.testing.assert_array_equal(fallback_out, np.full((4,), 6.0))
    _kill(a, b)


def test_allgather_binder_validation_and_channel_path_torch(local_cluster):
    @rt.remote
    class W:
        def __init__(self, k):
            self.k = k

        def val(self, x):
            return np.full((2,), float(x * self.k))

    a, b = W.remote(1), W.remote(10)
    with pytest.raises(ValueError):
        collective.allgather.bind([])
    with InputNode() as inp:
        na = a.val.bind(inp)
        with pytest.raises(ValueError):
            collective.allgather.bind([na, a.val.bind(inp)])
        ga, gb = collective.allgather.bind([na, b.val.bind(inp)])
        dag = MultiOutputNode([ga, gb]).experimental_compile(channels=True)
    assert isinstance(dag, ChannelCompiledDAG)
    try:
        va, vb = dag.execute(3).get(timeout=60)
        for got in (va, vb):
            assert len(got) == 2
            np.testing.assert_array_equal(got[0], np.full((2,), 3.0))
            np.testing.assert_array_equal(got[1], np.full((2,), 30.0))
    finally:
        dag.teardown()
        _kill(a, b)


# the same two-actor allreduce DAGs on each package, on the same inputs:
# (op, dtype, seed) cases; a value's inputs are rng(seed) draws per rank
_ALLREDUCE_CASES = (("sum", "float32", 1), ("max", "float32", 2),
                    ("sum", "int64", 3), ("prod", "int32", 4),
                    ("min", "int64", 5))

_ALLREDUCE_SCRIPT = r"""
import json, sys
import numpy as np
sys.path.insert(0, {root!r})
import {pkg} as rt
from {pkg}.dag import InputNode, MultiOutputNode, collective

CASES = {cases!r}


def inputs(dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype.startswith("int"):
        return [rng.integers(-5, 6, (3, 4)).astype(dtype) for _ in range(2)]
    return [rng.standard_normal((3, 4)).astype(dtype) for _ in range(2)]


@rt.remote
class W:
    def __init__(self, rank):
        self.rank = rank

    def grad(self, case):
        op, dtype, seed = case
        return inputs(dtype, seed)[self.rank]


rt.init(num_cpus=4)
a, b = W.remote(0), W.remote(1)
out = {{}}
for op in sorted({{c[0] for c in CASES}}):
    with InputNode() as inp:
        ra, rb = collective.allreduce.bind(
            [a.grad.bind(inp), b.grad.bind(inp)], op=op)
        dag = MultiOutputNode([ra, rb]).experimental_compile(channels=True)
    for case in CASES:
        if case[0] == op:
            va, vb = dag.execute(case).get(timeout=60)
            out["|".join(map(str, case))] = [
                np.asarray(va).tolist(), np.asarray(vb).tolist(),
                str(np.asarray(va).dtype)]
    dag.teardown()
rt.shutdown()
print("RESULT", json.dumps(out), flush=True)
"""


def _allreduce_run(pkg: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    script = _ALLREDUCE_SCRIPT.format(root=ROOT, pkg=pkg,
                                      cases=_ALLREDUCE_CASES)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def test_dag_allreduce_equals_ray_tpu():
    """A two-actor allreduce over the channel path (the out-of-band host
    tier: two single-process worlds share no device set) gives ray_tpu's
    result on the same inputs, bit for bit, for every op and dtype."""
    got, want = _allreduce_run("ray_tpu_torch"), _allreduce_run("ray_tpu")
    assert set(got) == set(want) == {"|".join(map(str, c))
                                     for c in _ALLREDUCE_CASES}
    for key, (va, vb, dtype) in got.items():
        assert va == vb == want[key][0] == want[key][1], key
        assert dtype == want[key][2], key


# ---------------------------------------------- observability record

def test_device_edge_record_torch():
    """A kind=device edge lands in the GCS dag record with its transport
    and device_arrays (the `rayt dag` rendering is ROADMAP item 2b)."""
    from ray_tpu_torch.core.gcs_dag_manager import GcsDagManager

    mgr = GcsDagManager()
    mgr.ingest({
        "kind": "register", "dag_id": "d" * 16, "job_id": "j" * 8,
        "driver": "w" * 8, "ts": 100.0,
        "channel_kinds": {"shm": 1, "dcn": 0, "device": 1},
        "edges": [
            {"edge": "e0", "channel": "c0", "kind": "device",
             "transport": "shm", "n_slots": 8, "slot_size": 1 << 20,
             "role": "edge",
             "producer": {"actor": "a" * 8, "label": "Feeder:aaaa"},
             "consumer": {"actor": "b" * 8, "label": "Learner:bbbb"}},
            {"edge": "e1", "channel": "c1", "kind": "shm",
             "n_slots": 8, "slot_size": 1 << 20, "role": "output",
             "producer": {"actor": "b" * 8, "label": "Learner:bbbb"},
             "consumer": {"actor": "", "label": "driver"}},
        ]})
    mgr.ingest({
        "kind": "report", "dag_id": "d" * 16, "ts": 101.0,
        "channels": {"c0": {"role": "producer", "writes": 7,
                            "bytes_written": 7 << 20,
                            "device_arrays": 21, "write_block_s": 0.0,
                            "write_blocked_s_now": 0.0}}})
    rec = mgr.list(dag_id="d" * 16)["dags"][0]
    e0 = next(e for e in rec["edges"] if e["edge"] == "e0")
    assert e0["kind"] == "device" and e0["transport"] == "shm"
    assert e0["ticks"] == 7 and e0["device_arrays"] == 21
    assert e0["bytes"] == 7 << 20
    assert rec["channel_kinds"]["device"] == 1


def test_device_objects_one_tensor_is_one_shard():
    """serialize_array ships exactly one tensor's bytes (a tensor lives on
    one device: no gather); host_shard_view of a contiguous CPU tensor is
    a view of its storage, bf16 its uint16 bits."""
    from ray_tpu_torch.core.device_objects import (deserialize_array,
                                                   host_shard_view,
                                                   serialize_array)

    t = torch.arange(64, dtype=torch.float32)
    raw, dtype, shape = serialize_array(t)
    assert len(raw) == t.nbytes and dtype == "float32" and shape == (64,)
    assert torch.equal(deserialize_array((raw, dtype, shape)), t)
    view = host_shard_view(t)
    assert view.ctypes.data == t.data_ptr()
    h = torch.ones(3, dtype=torch.bfloat16)
    assert host_shard_view(h).dtype == np.uint16
    assert host_shard_view(h).tolist() == [0x3F80] * 3
    assert serialize_array(h)[1:] == ("bfloat16", (3,))


# ------------------------------- twins of deselected reference tests

def test_mixed_kind_graph_with_allreduce_fast_path_torch():
    """test_dag_dcn's mixed-kind graph with tensor device edges: an
    allreduce over shm and DCN edges in one graph plus two device edges
    (the red actor's tensor to the driver over a shm ring, the blue
    actor's over a DCN channel), equal to the per-call fallback."""
    cluster = Cluster(head_resources={"CPU": 4.0, "red": 4.0})
    cluster.add_node(num_cpus=4, resources={"blue": 4.0})
    cluster.connect()
    try:
        @rt.remote(num_cpus=1, resources={"red": 1.0})
        class RedW:
            def grad(self, x):
                return np.full((4,), float(x))

            def tgrad(self, x):
                import torch

                return torch.full((4,), float(x))

        @rt.remote(num_cpus=1, resources={"blue": 1.0})
        class BlueW:
            def grad(self, x):
                return np.full((4,), float(x * 2))

            def tgrad(self, x):
                import torch

                return torch.full((4,), float(x * 2))

        a, b = RedW.remote(), BlueW.remote()
        with InputNode() as inp:
            with pytest.raises(ValueError):
                collective.allreduce.bind(
                    [a.grad.bind(inp), a.grad.bind(inp)])
            ra, rb = collective.allreduce.bind(
                [a.grad.bind(inp), b.grad.bind(inp)], op="sum")
            dev_shm = a.tgrad.bind(inp).with_tensor_transport()
            dev_dcn = b.tgrad.bind(inp).with_tensor_transport()
            dag = MultiOutputNode(
                [ra, rb, dev_shm, dev_dcn]).experimental_compile(
                    channels=True)
        assert isinstance(dag, ChannelCompiledDAG)
        assert dag.channel_kinds["shm"] >= 1, dag.channel_kinds
        assert dag.channel_kinds["dcn"] >= 1, dag.channel_kinds
        assert dag.channel_kinds["device"] == 2, dag.channel_kinds
        try:
            va, vb, vshm, vdcn = dag.execute(3).get(timeout=90)
            np.testing.assert_array_equal(va, np.full((4,), 9.0))
            np.testing.assert_array_equal(vb, np.full((4,), 9.0))
            assert isinstance(vshm, torch.Tensor)
            assert isinstance(vdcn, torch.Tensor)
            assert torch.equal(vshm, torch.full((4,), 3.0))
            assert torch.equal(vdcn, torch.full((4,), 6.0))
            va, _, _, _ = dag.execute(5).get(timeout=90)
            np.testing.assert_array_equal(va, np.full((4,), 15.0))
        finally:
            calls = collections.Counter()
            device_chs = [ch for ch in dag._driver_channels
                          if getattr(ch, "is_device", False)]
            assert device_chs
            for ch in device_chs:
                def _patched(_ch=ch, _orig=ch.close):
                    if not getattr(_ch, "_closed_locally", False):
                        calls.update([id(_ch)])
                    return _orig()

                ch.close = _patched
            dag.teardown()
            dag.teardown()
            assert all(v == 1 for v in calls.values()), calls
            assert len(calls) == len(device_chs)
        with InputNode() as inp:
            fa, fb = collective.allreduce.bind(
                [a.grad.bind(inp), b.grad.bind(inp)], op="sum")
            fallback = MultiOutputNode([fa, fb]).experimental_compile(
                channels=False)
        wa, wb = fallback.execute(3).get(timeout=90)
        np.testing.assert_array_equal(wa, np.full((4,), 9.0))
        np.testing.assert_array_equal(wb, np.full((4,), 9.0))
        _kill(a, b)
    finally:
        cluster.shutdown()


def test_put_device_get_same_process_zero_copy_torch(local_cluster):
    t = torch.arange(1024, dtype=torch.float32).reshape(32, 32)
    assert rt.get(rt.put_device(t)) is t


def test_device_ref_as_task_arg_torch(local_cluster):
    t = torch.arange(64, dtype=torch.float32)
    ref = rt.put_device(t)

    @rt.remote
    def consume(x):
        import torch

        assert isinstance(x, torch.Tensor)
        return float(x.sum())

    assert rt.get(consume.remote(ref)) == float(t.sum())


def test_device_return_stays_in_actor_torch(local_cluster):
    """tensor_transport=True: the produced tensor never transits the
    owner; a later consumer and the driver fetch raw bytes from the
    holder."""
    @rt.remote
    class Producer:
        def make(self, n):
            import torch

            return torch.ones((n, n)) * 3.0

    @rt.remote
    class Consumer:
        def total(self, x):
            return float(x.sum())

    p = Producer.remote()
    ref = p.make.options(tensor_transport=True).remote(16)
    from ray_tpu_torch.core.object_ref import get_core_worker

    cw = get_core_worker()
    rt.wait([ref], num_returns=1, timeout=30)
    meta = cw.object_meta[ref.id]
    assert meta.in_device and meta.holder is not None
    assert not cw.memory_store.contains(ref.id)
    c = Consumer.remote()
    assert rt.get(c.total.remote(ref)) == 16 * 16 * 3.0
    out = rt.get(ref)
    assert isinstance(out, torch.Tensor) and float(out.sum()) == 768.0
    _kill(p, c)


def test_compiled_dag_device_edge_torch(local_cluster):
    """A compiled DAG moves a tensor actor->actor through a device edge;
    values intact over three ticks."""
    @rt.remote
    class Stage1:
        def fwd(self, x):
            import torch

            return torch.as_tensor(x, dtype=torch.float32) * 2.0

    @rt.remote
    class Stage2:
        def fwd(self, x):
            return float(x.sum())

    s1, s2 = Stage1.remote(), Stage2.remote()
    with InputNode() as inp:
        out = s2.fwd.bind(s1.fwd.bind(inp).with_tensor_transport())
    dag = out.experimental_compile()
    for k in range(3):
        assert dag.execute(np.full((8,), k, np.float32)).get(
            timeout=60) == 8 * k * 2.0
    dag.teardown()
    _kill(s1, s2)


def test_device_object_free_releases_holder_memory_torch(local_cluster):
    @rt.remote
    class Producer:
        def make(self):
            import torch

            return torch.zeros((256, 256))

        def held(self):
            from ray_tpu_torch.core.object_ref import get_core_worker

            return len(get_core_worker().device_store)

    p = Producer.remote()
    ref = p.make.options(tensor_transport=True).remote()
    rt.wait([ref], num_returns=1, timeout=30)
    assert rt.get(p.held.remote()) == 1
    del ref
    gc.collect()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and rt.get(p.held.remote()) != 0:
        time.sleep(0.2)
    assert rt.get(p.held.remote()) == 0
    _kill(p)


def test_device_object_lost_when_holder_dies_torch(local_cluster):
    @rt.remote
    class Producer:
        def make(self):
            import torch

            return torch.ones(8)

    p = Producer.remote()
    ref = p.make.options(tensor_transport=True).remote()
    rt.wait([ref], num_returns=1, timeout=30)
    rt.kill(p)
    time.sleep(1.0)
    with pytest.raises((rt.ObjectLostError, rt.ActorDiedError)):
        rt.get(ref, timeout=30)
