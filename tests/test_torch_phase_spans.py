"""The port's hot-path phases (``ray_tpu_torch/_internal/otel.phase``) on the
CPU: the span trees of the engine round and of the train step, the ring's
window selection and bound, the mirror into ``torch.profiler``, the batched
export, the request stamp ``prefill_device_s``, and the benchmark's span
readers on a synthetic ring.

Device spans need CUDA events, which the CPU has not: ``FakeClock`` stands
in for them where a test needs device spans (its events read a virtual
device time the test sets), and the real clock shows that on the CPU every
device span stays None."""

import asyncio
import json
import threading
import types
from pathlib import Path

import pytest
import torch

from ray_tpu_torch._internal import otel
from ray_tpu_torch._internal import tracing
from ray_tpu_torch.parallel.spmd import adamw, build_train_step
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve import request_context as rc

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ENGINE_CHILDREN = {"engine.wait", "engine.admit", "engine.prefill",
                   "engine.decode", "engine.sync", "engine.emit"}


class FakeEvent:
    def __init__(self, clock):
        self.clock, self.t = clock, None

    def query(self):
        return self.clock.done

    def elapsed_time(self, end):
        assert self.clock.done, "read before the event completed"
        return end.t - self.t


class FakeClock:
    """Events on a virtual device whose time (ms) the test sets; every
    device, the CPU too, counts as a card. ``done`` says whether recorded
    events have completed."""

    def __init__(self, tick: float = 0.0):
        self.now, self.done, self.made = 0.0, True, 0
        self.tick = tick            # ms the device advances at each record

    def key(self, device):
        return 0

    def event(self, key):
        self.made += 1
        return FakeEvent(self)

    def record(self, event, key):
        event.t = self.now
        self.now += self.tick


@pytest.fixture
def ring(monkeypatch):
    """A fresh process recorder on the real (CUDA) clock."""
    rec = otel.PhaseRecorder()
    monkeypatch.setattr(otel, "_recorder", rec)
    return rec


@pytest.fixture
def fake(monkeypatch):
    """A fresh process recorder whose device spans come from a FakeClock;
    every event advances the virtual device by 1 ms."""
    rec = otel.PhaseRecorder(clock=FakeClock(tick=1.0))
    monkeypatch.setattr(otel, "_recorder", rec)
    return rec


def _by_id(spans):
    return {s["span_id"]: s for s in spans}


def _run_engine(requests, **kw):
    """Serve `requests` [(tokens, max_new, obs)] on a tiny CPU engine, all
    sent at once; returns the streams."""
    eng = tllm.LLMEngine("debug", device="cpu", seed=0, **kw)

    async def one(tokens, n, obs):
        token = rc._set_request_obs(obs)
        try:
            return [t async for t in eng.generate(tokens, max_new_tokens=n)]
        finally:
            rc._reset_request_obs(token)

    async def main():
        return await asyncio.gather(*[one(*r) for r in requests])

    return asyncio.run(main())


ENGINE_KW = dict(max_batch=2, prompt_buckets=(16, 64), prefill_chunk=16,
                 prefix_cache_entries=0)


def test_engine_span_tree(fake):
    """Rounds on the loop thread; their wait, admit, prefill, decode, sync
    and emit phases under them, those on executor threads parented
    explicitly; a request's admit and prefill phases carry its id; the
    position check sits under each decode and prefill."""
    obs = [{"request_id": "req-long"}, {}, {}]
    reqs = [(list(range(1, 41)), 3, obs[0]),     # 40 tokens: 3 chunks of 16
            (list(range(5, 15)), 4, obs[1]),
            (list(range(7, 12)), 2, obs[2])]
    streams = _run_engine(reqs, **ENGINE_KW)
    assert [len(s) for s in streams] == [3, 4, 2]
    spans = otel.phase_spans()
    ids = _by_id(spans)
    rounds = [s for s in spans if s["name"] == "engine.round"]
    assert rounds and len({r["thread"] for r in rounds}) == 1
    loop_thread = rounds[0]["thread"]
    for s in spans:
        if s["name"] in ENGINE_CHILDREN:
            parent = ids[s["parent_id"]]
            if s["name"] == "engine.prefill" and parent["name"] == \
                    "engine.admit":
                continue             # a prompt that fits one call
            assert parent["name"] == "engine.round", s
            if s["name"] != "engine.wait":
                assert s["thread"] != loop_thread, s   # an executor thread
        if s["name"] == "llama.position_check":
            assert ids[s["parent_id"]]["name"] in ("engine.decode",
                                                   "engine.prefill")
    names = {s["name"] for s in spans}
    assert ENGINE_CHILDREN | {"llama.position_check"} <= names
    decodes = [s for s in spans if s["name"] == "engine.decode"]
    checks = [s for s in spans if s["name"] == "llama.position_check"
              and ids[s["parent_id"]]["name"] == "engine.decode"]
    assert len(checks) == len(decodes)
    # the long prompt: admitted once, prefilled chunk by chunk under rounds
    long_ = [s for s in spans if s["request_id"] == "req-long"]
    assert sorted(s["name"] for s in long_) == [
        "engine.admit"] + ["engine.prefill"] * 3
    chunks = [s for s in long_ if s["name"] == "engine.prefill"]
    assert all(ids[s["parent_id"]]["name"] == "engine.round"
               for s in chunks)
    assert [s["attrs"] for s in chunks] == [{"tokens": 16, "bucket": 64}] * 3
    # a short prompt: one prefill under its admit, the engine's own id
    short = [s for s in spans if s["name"] == "engine.admit"
             and s["request_id"] != "req-long"]
    assert len(short) == 2 and len({s["request_id"] for s in short}) == 2
    for a in short:
        pre = [s for s in spans if s["name"] == "engine.prefill"
               and s["parent_id"] == a["span_id"]]
        assert len(pre) == 1 and pre[0]["request_id"] == a["request_id"]
    assert all(s["device_ms"] is not None for s in spans
               if s["name"] in ("engine.admit", "engine.prefill",
                                "engine.decode"))


def test_request_records_its_prefill_device_time(fake):
    """``prefill_device_s`` is the sum of the request's prefill device
    spans, and ``engine_section`` carries it beside ``prefill_s``."""
    obs = {"request_id": "r1"}
    _run_engine([(list(range(1, 41)), 2, obs)], **ENGINE_KW)
    pre = otel.phase_spans(name="engine.prefill")
    assert len(pre) == 3 and all(s["request_id"] == "r1" for s in pre)
    want = sum(s["device_ms"] for s in pre) / 1e3
    assert obs["prefill_device_s"] == pytest.approx(want)
    assert obs["prefill_chunks"] == 3
    sec = rc.engine_section(obs)
    assert sec["prefill_device_s"] == pytest.approx(want)
    assert sec["prefill_s"] == obs["prefill_s"]


def test_cpu_engine_has_no_device_spans(ring):
    obs = {}
    _run_engine([(list(range(1, 20)), 2, obs)], **ENGINE_KW)
    spans = otel.phase_spans()
    assert spans and all(s["device_ms"] is None for s in spans)
    assert "prefill_device_s" not in obs
    assert rc.engine_section(obs)["prefill_device_s"] is None


def _tiny_train_step(**kw):
    torch.manual_seed(0)
    params = {"w": torch.randn(8, 4), "b": torch.zeros(4)}

    def loss_fn(p, batch):
        out = batch["x"] @ p["w"] + p["b"]
        loss = ((out - batch["y"]) ** 2).mean()
        return loss, {"loss": loss.detach()}

    step, state = build_train_step(loss_fn, adamw(1e-2), params,
                                   device="cpu", **kw)
    batch = {"x": torch.randn(4, 8), "y": torch.randn(4, 4)}
    return step, state, batch


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_span_tree(fake, grad_accum):
    step, state, batch = _tiny_train_step(grad_accum=grad_accum)
    for _ in range(3):
        state, aux = step(state, batch)
    spans = otel.phase_spans()
    ids = _by_id(spans)
    steps = [s for s in spans if s["name"] == "train.step"]
    assert len(steps) == 3 and all(s["parent_id"] is None for s in steps)
    for st in steps:
        kids = [s for s in spans if s["parent_id"] == st["span_id"]]
        assert [k["name"] for k in kids] == (
            ["train.forward", "train.backward"] * grad_accum
            + ["train.optimizer"])
        assert all(k["device_ms"] is not None for k in kids)
        assert all(ids[k["parent_id"]] is st for k in kids)
        assert st["start_ns"] <= kids[0]["start_ns"]
        assert kids[-1]["end_ns"] <= st["end_ns"]


def test_train_step_on_the_cpu_has_no_device_spans(ring):
    step, state, batch = _tiny_train_step()
    step(state, batch)
    spans = otel.phase_spans()
    assert {s["name"] for s in spans} == {"train.step", "train.forward",
                                          "train.backward",
                                          "train.optimizer"}
    assert all(s["device_ms"] is None for s in spans)


def test_window_selection_and_ring_bound(monkeypatch):
    rec = otel.PhaseRecorder(maxlen=4)
    monkeypatch.setattr(otel, "_recorder", rec)
    clock = {"ns": 1_000_000_000}
    monkeypatch.setattr(otel, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: clock["ns"], time_ns=lambda: clock["ns"]))
    for i in range(6):           # phase i runs from i s to i s + 0.5 s
        clock["ns"] = (i + 1) * 1_000_000_000
        with otel.phase(f"p{i}"):
            clock["ns"] += 500_000_000
    assert [s["name"] for s in otel.phase_spans()] == ["p2", "p3", "p4",
                                                       "p5"]
    assert [s["name"] for s in otel.phase_spans(4.0, 5.6)] == ["p3", "p4"]
    assert [s["name"] for s in otel.phase_spans(since=5.0)] == ["p4", "p5"]
    assert [s["name"] for s in otel.phase_spans(until=4.5)] == ["p2", "p3"]
    assert otel.phase_spans(name="p5")[0]["start_ns"] == 6_000_000_000


def test_device_spans_resolve_without_waiting(fake, monkeypatch):
    """A device span resolves only once its end event has completed: when a
    later phase opens with enough of them pending, or when a reader asks.
    Its events then return to the pool."""
    monkeypatch.setattr(otel, "PHASE_RESOLVE_AT", 2)
    clock = fake.clock
    clock.done = False
    with otel.phase("a", device=CPU):
        pass
    with otel.phase("b", device=CPU):   # one pending: not yet settled
        pass
    assert [s["device_ms"] for s in otel.phase_spans()] == [None, None]
    assert clock.made == 4
    clock.done = True
    with otel.phase("c", device=CPU):   # two pending: a and b settle, and
        pass                            # c takes their pooled events
    assert [p.device_ms for p in fake._ring] == [1.0, 1.0, None]
    assert clock.made == 4
    assert otel.phase_spans(name="c")[0]["device_ms"] == 1.0    # the reader


def test_a_failing_body_keeps_its_exception(fake):
    """A phase whose body raises records no end event: the body's own
    exception propagates, the record stays without a device span, and the
    start event goes back to the pool."""
    class Boom(Exception):
        pass

    with pytest.raises(Boom):
        with otel.phase("failing", device=CPU):
            raise Boom()
    (rec,) = otel.phase_spans(name="failing")
    assert rec["device_ms"] is None and rec["end_ns"] >= rec["start_ns"]
    assert not fake._pending and fake.clock.made == 1
    with otel.phase("next", device=CPU):   # reuses the pooled start event
        pass
    assert fake.clock.made == 2


def test_threads_share_the_recorder(fake, monkeypatch):
    """Many threads opening device phases at once, switching often: every
    record kept once with its own id, every device span resolved, and no
    pooled event handed out twice."""
    import sys

    monkeypatch.setattr(otel, "PHASE_RESOLVE_AT", 2)
    n_threads, n_phases = 12, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(i):
            for j in range(n_phases):
                with otel.phase("outer", device=CPU, t=i):
                    with otel.phase("inner", device=CPU):
                        pass

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = otel.phase_spans()
    assert len(spans) == 2 * n_threads * n_phases
    assert len({s["span_id"] for s in spans}) == len(spans)
    assert all(s["device_ms"] is not None for s in spans)
    pooled = fake._pools[0]
    assert len({id(e) for e in pooled}) == len(pooled) == fake.clock.made
    ids = _by_id(spans)
    assert all(ids[s["parent_id"]]["thread"] == s["thread"]
               for s in spans if s["name"] == "inner")


def test_explicit_parent_and_context_parent(ring):
    with otel.phase("outer") as outer:
        with otel.phase("inner") as inner:
            pass
        box = {}

        def worker():            # a plain thread has no phase of its own
            with otel.phase("orphan") as o:
                box["orphan"] = o.parent_id
            with otel.phase("child", parent=outer.span_id) as c:
                box["child"] = c.parent_id

        t = threading.Thread(target=worker)
        t.start()
        t.join(10)
        assert not t.is_alive()
    assert inner.parent_id == outer.span_id
    assert box == {"orphan": None, "child": outer.span_id}


def test_profiler_mirror(ring, monkeypatch):
    """Under a profiler the phases are among its events; without one no
    ``record_function`` is entered."""
    entered = []
    real = torch.autograd.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    with otel.phase("quiet.outer"):
        with otel.phase("quiet.inner"):
            torch.ones(4).sum()
    assert entered == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with otel.phase("loud.outer"):
            with otel.phase("loud.inner"):
                torch.ones(4).sum()
    assert entered == ["loud.outer", "loud.inner"]
    names = {e.name for e in prof.events()}
    assert {"loud.outer", "loud.inner"} <= names
    assert not {"quiet.outer", "quiet.inner"} & names


@pytest.fixture
def tracing_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(otel, "_enabled", None)
    monkeypatch.setattr(otel, "_out_path", None)
    otel.enable_tracing(str(tmp_path))
    return tmp_path


def _lines(path: Path) -> list:
    return [json.loads(x) for x in path.read_text().splitlines() if x]


def test_export_in_batches_one_row_per_thread(ring, tracing_dir,
                                              monkeypatch):
    monkeypatch.setattr(otel, "PHASE_EXPORT_BATCH", 5)
    monkeypatch.setattr(otel, "atexit", types.SimpleNamespace(
        register=lambda *a: None))
    writes = []

    def counting_open(path, mode="r", *a, **kw):
        if "a" in mode:
            writes.append(path)
        return open(path, mode, *a, **kw)

    monkeypatch.setattr(otel, "open", counting_open, raising=False)
    out = Path(otel._out_path)
    for i in range(4):
        with otel.phase("main.phase", step=i):
            pass
    assert not out.exists() and writes == []     # nothing per span
    with otel.phase("main.phase", step=4):       # the fifth: one batch
        pass
    assert len(writes) == 1
    assert [s["attributes"]["step"] for s in _lines(out)] == [0, 1, 2, 3, 4]

    def worker():
        with otel.phase("worker.phase", request_id="r9"):
            pass

    t = threading.Thread(target=worker, name="phase-worker")
    t.start()
    t.join(10)
    assert not t.is_alive()
    n = otel.export_chrome_trace(str(tracing_dir),
                                 str(tracing_dir / "trace.json"))
    assert n == 6 and len(writes) == 2
    spans = otel.read_spans(str(tracing_dir))
    assert all(s["kind"] == "PHASE" and s["end_ns"] >= s["start_ns"]
               for s in spans)
    w = next(s for s in spans if s["name"] == "worker.phase")
    assert w["attributes"]["request_id"] == "r9"
    assert w["thread"] == "phase-worker"
    chrome = json.loads((tracing_dir / "trace.json").read_text())
    rows = {e["name"]: e["tid"] for e in chrome["traceEvents"]}
    assert rows["worker.phase"] == "thread:phase-worker"
    assert rows["main.phase"] == f"thread:{threading.current_thread().name}"


def test_export_waits_for_pending_device_spans(fake, tracing_dir,
                                               monkeypatch):
    monkeypatch.setattr(otel, "atexit", types.SimpleNamespace(
        register=lambda *a: None))
    fake.clock.done = False
    with otel.phase("dev", device=CPU):
        pass
    with otel.phase("host"):
        pass
    assert fake.flush() == 1
    fake.clock.done = True
    assert fake.flush() == 1
    got = {s["name"]: s for s in otel.read_spans(str(tracing_dir))}
    assert got["dev"]["attributes"]["device_ms"] == 1.0
    assert "device_ms" not in got["host"]["attributes"]


def test_no_export_without_tracing_dir(ring, monkeypatch, tmp_path):
    monkeypatch.setattr(otel, "_enabled", False)
    with otel.phase("p"):
        pass
    assert ring.flush(final=True) == 0
    assert ring._unexported == []


# ------------------------------------------------ the benchmark's readers
def _host_clock(monkeypatch):
    clock = {"ns": 0}
    monkeypatch.setattr(otel, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: clock["ns"], time_ns=lambda: clock["ns"]))
    return clock


def _timed(clock, fake, name, host, dev, **kw):
    """A phase from host ms host[0] to host[1] whose device span is dev
    ms (None: a host-only phase)."""
    clock["ns"] = int(host[0] * 1e6)
    ph = otel.phase(name, device=None if dev is None else CPU, **kw)
    fake.clock.now = 0.0
    ph.__enter__()
    clock["ns"] = int(host[1] * 1e6)
    fake.clock.now = dev or 0.0
    ph.__exit__(None, None, None)
    return ph


def _read(metric, ctx):
    from benchmark import harness

    layout = harness.Layout(ROOT)
    spec = {m["name"]: m for m in layout.spec()["per_layer"]}
    return harness.read_metric(layout, spec[metric], ctx)


def _serve_ring(clock, fake):
    """Two engine rounds in the window [1000, 3000] ms and one before it.
    Round A (1000-1400 ms): wait 50 ms, an admit with 30 ms on the card, a
    prefill chunk of 100, a decode of 200: idle 400-50-30-100-200 = 20.
    Round B (1400-1800 ms): a decode of 350 and its position check (a
    grandchild, not counted): idle 50."""
    fake.clock.tick = 0.0
    old = _timed(clock, fake, "engine.round", (500, 900), None)
    a = otel.phase("engine.round")
    clock["ns"] = int(1000e6)
    a.__enter__()
    _timed(clock, fake, "engine.wait", (1000, 1050), None)
    _timed(clock, fake, "engine.admit", (1050, 1090), 30.0,
           parent=a.span_id, request_id=7)
    _timed(clock, fake, "engine.prefill", (1090, 1150), 100.0,
           parent=a.span_id, request_id=7)
    _timed(clock, fake, "engine.decode", (1150, 1390), 200.0,
           parent=a.span_id)
    clock["ns"] = int(1400e6)
    a.__exit__(None, None, None)
    b = otel.phase("engine.round")
    b.__enter__()
    d = _timed(clock, fake, "engine.decode", (1400, 1790), 350.0,
               parent=b.span_id)
    _timed(clock, fake, "llama.position_check", (1401, 1402), None,
           parent=d.span_id)
    _timed(clock, fake, "engine.sync", (1790, 1795), None, parent=b.span_id)
    clock["ns"] = int(1800e6)
    b.__exit__(None, None, None)
    return old


def test_serve_readers_on_a_synthetic_ring(fake, monkeypatch):
    clock = _host_clock(monkeypatch)
    _serve_ring(clock, fake)
    ctx = {"t_open": 1.0, "t_close": 3.0, "kind": "serve"}
    for cell in ("batch", "code"):
        assert _read(f"decode_device_ms.{cell}", ctx) == pytest.approx(275.0)
        assert _read(f"round_idle_ms.{cell}", ctx) == pytest.approx(35.0)
    assert _read("prefill_device_ms_p50.code", ctx) == pytest.approx(100.0)
    # a window before any round: nothing to read
    assert _read("round_idle_ms.batch", {"t_open": 0.0, "t_close": 0.4}) \
        is None


def test_serve_readers_give_none_on_unresolved_spans(fake, monkeypatch):
    clock = _host_clock(monkeypatch)
    fake.clock.done = False
    _serve_ring(clock, fake)
    ctx = {"t_open": 1.0, "t_close": 3.0, "kind": "serve"}
    for metric in ("decode_device_ms.batch", "decode_device_ms.code",
                   "prefill_device_ms_p50.code", "round_idle_ms.batch",
                   "round_idle_ms.code"):
        assert _read(metric, ctx) is None, metric


def test_train_readers_on_a_synthetic_ring(fake, monkeypatch):
    """Two steps in the window: forward 100 and 120 ms, backward 200 and
    220, optimizer 30 and 50, each step's phases tiling it."""
    clock = _host_clock(monkeypatch)
    fake.clock.tick = 0.0
    t = 1000.0
    for fwd, bwd, opt in ((100.0, 200.0, 30.0), (120.0, 220.0, 50.0)):
        st = otel.phase("train.step")
        clock["ns"] = int(t * 1e6)
        st.__enter__()
        _timed(clock, fake, "train.forward", (t, t + 1), fwd)
        _timed(clock, fake, "train.backward", (t + 1, t + 2), bwd)
        _timed(clock, fake, "train.optimizer", (t + 2, t + 3), opt)
        clock["ns"] = int((t + 4) * 1e6)
        st.__exit__(None, None, None)
        t += 10
    ctx = {"t_open": 1.0, "t_close": 2.0, "kind": "train"}
    assert _read("forward_ms.train", ctx) == pytest.approx(110.0)
    assert _read("backward_ms.train", ctx) == pytest.approx(210.0)
    assert _read("optimizer_ms.train", ctx) == pytest.approx(40.0)


def test_train_readers_give_none_on_the_cpu(ring):
    step, state, batch = _tiny_train_step()
    import time

    t0 = time.perf_counter()
    for _ in range(2):
        state, _ = step(state, batch)
    ctx = {"t_open": t0, "t_close": time.perf_counter(), "kind": "train"}
    for metric in ("forward_ms.train", "backward_ms.train",
                   "optimizer_ms.train"):
        assert _read(metric, ctx) is None, metric


def test_tracing_renders_phases_beside_other_spans():
    """The Chrome exporter keeps one row per trace id for control-plane
    spans and gives phases a row per thread."""
    ev = tracing.to_chrome_trace([
        {"name": "task", "start_ns": 1000, "end_ns": 5000,
         "trace_id": "abcdef0123456789", "pid": 1},
        {"name": "engine.round", "start_ns": 2000, "end_ns": 4000,
         "thread": "MainThread", "pid": 1, "kind": "PHASE"}])["traceEvents"]
    assert [e["tid"] for e in ev] == ["trace:abcdef01", "thread:MainThread"]
