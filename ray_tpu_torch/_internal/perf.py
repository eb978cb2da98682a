"""Core microbenchmarks (ref analog: python/ray/_private/ray_perf.py:93,
run by `ray microbenchmark`). Measures the task/actor/object substrate —
the scalability-envelope numbers SURVEY.md §6 tracks."""

from __future__ import annotations

import time
from typing import Callable

import numpy as np


def _timeit(name: str, fn: Callable, multiplier: int = 1,
            duration: float = 2.0) -> dict:
    # warmup
    fn()
    start = time.perf_counter()
    count = 0
    while time.perf_counter() - start < duration:
        fn()
        count += 1
    dt = time.perf_counter() - start
    rate = count * multiplier / dt
    return {"benchmark": name, "rate_per_s": round(rate, 1)}


def run_microbenchmarks(duration: float = 2.0, device=None) -> list[dict]:
    """Every leg, in order. The device legs' tensors live on `device`: the
    CUDA card by default (raises without one), the CPU only when asked for
    with ``device="cpu"``; their records name it."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.device import resolve_device

    device = resolve_device(device)
    results = []

    @rt.remote
    def tiny(x):
        return x

    # batch submission throughput (tasks/s)
    def submit_batch():
        rt.get([tiny.remote(i) for i in range(100)])

    results.append(_timeit("tasks_per_second", submit_batch, 100, duration))

    # steady-state burst: one pre-built 500-task wave per iteration —
    # long enough that lease batching + hot-lease chaining dominate the
    # measurement instead of the wave's spin-up/drain edges
    def submit_burst():
        rt.get([tiny.remote(i) for i in range(500)])

    results.append(_timeit("tasks_per_second_burst", submit_burst, 500,
                           max(duration, 1.0)))

    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        async def aincr(self):
            self.n += 1
            return self.n

    c = Counter.remote()
    results.append(_timeit(
        "actor_calls_sync_per_second", lambda: rt.get(c.incr.remote()),
        1, duration))

    def actor_batch():
        rt.get([c.incr.remote() for _ in range(100)])

    results.append(_timeit("actor_calls_async_per_second", actor_batch,
                           100, duration))

    ac = Counter.remote()

    def async_actor_batch():
        rt.get([ac.aincr.remote() for _ in range(100)])

    results.append(_timeit("async_actor_calls_per_second",
                           async_actor_batch, 100, duration))

    small = np.zeros(16, np.float64)
    results.append(_timeit(
        "put_small_per_second", lambda: rt.put(small), 1, duration))

    big = np.zeros(1 << 27, np.uint8)  # 128 MiB

    def put_get_big():
        rt.get(rt.put(big))

    r = _timeit("put_get_gigabytes_per_second", put_get_big, 1,
                max(duration, 1.0))
    r["rate_per_s"] = round(r["rate_per_s"] * big.nbytes / (1 << 30), 3)
    results.append(r)

    # repeated get of ONE sealed object: isolates the read path (the
    # zero-copy contract — shm-backed views, no deserialize-time copy)
    # from put/seal cost, which put_get above mixes in
    big_ref = rt.put(big)

    def get_big():
        rt.get(big_ref)

    r = _timeit("get_gigabytes_per_second", get_big, 1, max(duration, 1.0))
    r["rate_per_s"] = round(r["rate_per_s"] * big.nbytes / (1 << 30), 3)
    results.append(r)
    del big_ref

    # compiled-DAG per-tick cost: per-call executor vs pre-allocated shm
    # channel loops (ref: compiled_dag_node.py fast path)
    @rt.remote
    class Echo:
        def apply(self, x):
            return x

    e1, e2 = Echo.remote(), Echo.remote()
    from ray_tpu_torch.dag import InputNode

    with InputNode() as inp:
        dag_out = e2.apply.bind(e1.apply.bind(inp))
    legacy = dag_out.experimental_compile(channels=False)
    legacy.execute(0).get(timeout=60)
    results.append(_timeit(
        "dag_percall_ticks_per_second",
        lambda: legacy.execute(1).get(timeout=60), 1, duration))
    chan = dag_out.experimental_compile(channels=True)
    chan.execute(0).get(timeout=60)
    results.append(_timeit(
        "dag_channel_ticks_per_second",
        lambda: chan.execute(1).get(timeout=60), 1, duration))
    chan.teardown()

    # zero-copy channel bandwidth: a 1 MiB numpy payload echoed through a
    # single-stage channel DAG (driver ring -> actor -> output ring); the
    # scatter write + slot-view deserialize path must sustain GB/s where
    # the old pickle+join+bytes() tick plateaued well under 1
    e3 = Echo.remote()
    with InputNode() as inp:
        gb_node = e3.apply.bind(inp)
    gdag = gb_node.experimental_compile(channels=True,
                                        buffer_size_bytes=2 << 20)
    mib = np.zeros(1 << 20, np.uint8)
    gdag.execute(mib).get(timeout=60)
    r = _timeit("dag_channel_gigabytes_per_second",
                lambda: gdag.execute(mib).get(timeout=60), 1,
                max(duration, 1.0))
    r["rate_per_s"] = round(r["rate_per_s"] * mib.nbytes / (1 << 30), 3)
    results.append(r)
    gdag.teardown()

    # DCN ring channel tick rate: producer->consumer items over the RPC
    # plane (loopback), credit window pacing the pipeline — the per-tick
    # cost of a cross-node DAG edge
    import uuid as _uuid

    from ray_tpu_torch.dag.dcn_channel import DcnProducerChannel, create_endpoint

    cons = create_endpoint(f"bench-{_uuid.uuid4().hex[:12]}", 8, 1 << 20)
    prod = DcnProducerChannel(cons.spec)

    def dcn_window():
        for i in range(8):
            prod.write(i)
        for _ in range(8):
            cons.read(timeout=60)

    results.append(_timeit("dag_dcn_ticks_per_second", dcn_window, 8,
                           duration))
    prod.close()
    cons.close()

    results.extend(_device_legs(device, duration))
    for a in (c, ac, e1, e2, e3):
        rt.kill(a)
    return results


def _device_legs(device, duration: float) -> list[dict]:
    """The device-channel legs in this process (no cluster needed), the
    written tensors made on `device`, a resolved torch.device. The
    cross-process leg rebuilds on this process's device, as every consumer
    of a device edge does (``device_objects.rebuild_tensor``)."""
    import torch

    from ray_tpu_torch.dag.channel import ShmChannel
    from ray_tpu_torch.dag.device_channel import (DeviceChannel,
                                                  DeviceChannelSpec,
                                                  DeviceTransportChannel,
                                                  attach_device)

    results = []
    # device channel tick rate: same-process handoff of a tensor — the
    # value OBJECT moves producer->consumer with no serialize /
    # deserialize round trip on the hot path (the acceptance bar: this
    # must beat the shm ring's tick rate for tensor payloads)
    dev = DeviceChannel.create(n_slots=8)
    dpeer = attach_device(dev.spec)
    small_dev = torch.zeros(1024, dtype=torch.float32, device=device)

    def dev_window():
        for _ in range(8):
            dev.write(small_dev)
        for _ in range(8):
            dpeer.read(timeout=60)

    results.append(_timeit("dag_device_ticks_per_second", dev_window, 8,
                           duration))
    dpeer.close()
    dev.close()

    # device-edge bandwidth over the CROSS-PROCESS framing: a 1 MiB
    # tensor as raw host bytes through a shm ring (scatter write) with a
    # rebuild on the consumer's device — the byte path a compiled-DAG
    # device edge pays between processes
    inner = ShmChannel.create(slot_size=2 << 20, n_slots=4)
    dspec = DeviceChannelSpec(name=inner.spec.name, inner=inner.spec)
    dprod = DeviceTransportChannel(inner, dspec)
    dcons = DeviceTransportChannel(ShmChannel.attach(inner.spec), dspec)
    mib_dev = torch.zeros(1 << 18, dtype=torch.float32,
                          device=device)  # 1 MiB

    def dev_gb():
        dprod.write(mib_dev)
        dcons.read(timeout=60)

    r = _timeit("dag_device_gigabytes_per_second", dev_gb, 1,
                max(duration, 1.0))
    r["rate_per_s"] = round(r["rate_per_s"] * mib_dev.nbytes / (1 << 30),
                            3)
    results.append(r)
    dcons.close()
    dprod.close()
    for r in results:
        r["device"] = str(device)
    return results

