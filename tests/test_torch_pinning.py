"""Per-lease card pinning on a cluster that says it has four GPUs
(``resources={"GPU": 4}``: a count set by hand skips autodetection, and the
node names its cards 0..3). A worker serving a GPU lease sees the lease's
cards through CUDA_VISIBLE_DEVICES, set before its task or actor runs; the
private accessor ``accelerators._lease_gpu_ids`` reads the same cards. No
test here touches CUDA: there is none on this host."""

import os
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import train


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=8, resources={"GPU": 4})
    try:
        yield rt
    finally:
        rt.shutdown()


def _view() -> tuple:
    from ray_tpu_torch._internal.accelerators import _lease_gpu_ids

    return os.environ.get("CUDA_VISIBLE_DEVICES"), _lease_gpu_ids(), \
        os.getpid()


@rt.remote(num_gpus=1)
def one_card(hold_s: float = 0.0, barrier: str = "", n: int = 0):
    """This task's view, once `n` tasks have reached `barrier` (a
    directory each marks its arrival in), so that they hold their leases
    at once."""
    if barrier:
        open(os.path.join(barrier, str(os.getpid())), "w").close()
        deadline = time.monotonic() + 60
        while len(os.listdir(barrier)) < n:
            assert time.monotonic() < deadline, "the tasks never ran at once"
            time.sleep(0.02)
    time.sleep(hold_s)
    return _view()


@rt.remote(num_gpus=2)
def two_cards():
    return _view()


@rt.remote(num_gpus=0.5)
class Half:
    def view(self):
        return _view()


@rt.remote(num_gpus=1)
class Whole:
    def view(self):
        return _view()


@rt.remote
def cpu_only():
    return _view()


def _gpus_free(want: float, timeout: float = 20.0) -> float:
    deadline = time.monotonic() + timeout
    while True:
        free = rt.available_resources().get("GPU", 0.0)
        if free == want or time.monotonic() > deadline:
            return free
        time.sleep(0.05)


def test_whole_leases_take_distinct_cards(cluster, tmp_path):
    """Four one-GPU tasks holding their leases at once read four distinct
    cards, each its process's only one; a two-GPU task reads two; the
    cards come back when the leases return, and the next four take the
    same four."""
    for round_ in ("first", "again"):
        barrier = tmp_path / round_
        barrier.mkdir()
        got = rt.get([one_card.remote(0.0, str(barrier), 4)
                      for _ in range(4)], timeout=90)
        assert sorted(v for v, _, _ in got) == ["0", "1", "2", "3"]
        assert all(ids == (v,) for v, ids, _ in got)
        assert _gpus_free(4.0) == 4.0
    view, ids, _ = rt.get(two_cards.remote(), timeout=60)
    assert len(ids) == 2 and view == ",".join(ids)
    assert len(set(ids)) == 2
    # a CPU-only lease pins nothing: the worker sees every card
    assert rt.get(cpu_only.remote(), timeout=60)[:2] == (None, ())
    assert _gpus_free(4.0) == 4.0


def test_fractional_leases_share_one_card(cluster):
    """Two half-GPU actors pack onto one card and hold it together; the
    card comes back when both die."""
    a, b = Half.remote(), Half.remote()
    (va, ia, pa), (vb, ib, pb) = rt.get([a.view.remote(), b.view.remote()],
                                        timeout=60)
    assert va == vb and ia == ib == (va,) and pa != pb
    assert _gpus_free(3.0) == 3.0
    rt.kill(a)
    rt.kill(b)
    assert _gpus_free(4.0) == 4.0


def test_placement_group_bundles_carry_their_cards(cluster):
    """A bundle takes its card when it is reserved; the tasks placed in
    it read that card, and two half-GPU tasks in one bundle share it."""
    pg = rt.placement_group([{"CPU": 1, "GPU": 1}, {"CPU": 1, "GPU": 1}])
    try:
        halves = [
            one_card.options(num_gpus=0.5, num_cpus=0.5,
                             scheduling_strategy=pg.bundle_strategy(i))
            .remote(0.5) for i in (0, 0, 1, 1)]
        got = rt.get(halves, timeout=60)
        b0 = {v for v, _, _ in got[:2]}
        b1 = {v for v, _, _ in got[2:]}
        assert len(b0) == 1 and len(b1) == 1 and b0 != b1
        assert _gpus_free(2.0) == 2.0
    finally:
        rt.remove_placement_group(pg)
    assert _gpus_free(4.0) == 4.0


def test_a_dead_workers_card_returns(cluster):
    """Four whole-GPU actors hold every card; killing one frees its card,
    and a new actor gets it."""
    actors = [Whole.remote() for _ in range(4)]
    views = rt.get([w.view.remote() for w in actors], timeout=60)
    assert sorted(v for v, _, _ in views) == ["0", "1", "2", "3"]
    assert _gpus_free(0.0) == 0.0
    freed = views[2][0]
    rt.kill(actors[2])
    assert _gpus_free(1.0) == 1.0
    fresh = Whole.remote()
    assert rt.get(fresh.view.remote(), timeout=60)[0] == freed
    for w in actors[:2] + actors[3:] + [fresh]:
        rt.kill(w)
    assert _gpus_free(4.0) == 4.0


@rt.remote(num_gpus=1)
def touch_cuda():
    """A task that asks whether CUDA is there and allocates nothing. On a
    card, ``is_available()`` starts the driver, which reads
    CUDA_VISIBLE_DEVICES then and never again, while
    ``torch.cuda.is_initialized()`` stays False: this process is now held
    to its card for good."""
    import torch

    torch.cuda.is_available()
    assert not torch.cuda.is_initialized()
    return _view()


@rt.remote
def cpu_touch_cuda():
    """The common ``'cuda' if torch.cuda.is_available() else 'cpu'`` in a
    CPU-only task: the process keeps the node's view of every card."""
    import torch

    torch.cuda.is_available()
    return _view()


def test_a_worker_that_touched_cuda_keeps_its_card(cluster):
    """Under the reuse rule, a worker that may have initialised CUDA (it
    called only ``torch.cuda.is_available()``) serves only leases of the
    card it saw then; leases of other cards take other workers."""
    _, _, toucher = rt.get(touch_cuda.remote(), timeout=60)
    for _ in range(3):
        got = rt.get([one_card.remote(0.3) for _ in range(4)], timeout=60)
        for view, _, pid in got:
            assert pid != toucher or view == "0", got


def test_a_cpu_worker_that_asked_for_cuda_serves_no_gpu_lease(cluster):
    """A CPU-only task that called ``torch.cuda.is_available()`` leaves a
    worker whose CUDA, if it started, sees every card: no GPU lease is
    handed to it afterwards, while CPU-only leases may still take it."""
    view, _, asker = rt.get(cpu_touch_cuda.remote(), timeout=60)
    assert view is None
    for _ in range(3):
        got = rt.get([one_card.remote(0.3) for _ in range(4)], timeout=60)
        assert asker not in {pid for _, _, pid in got}, got
        assert sorted(v for v, _, _ in got) == ["0", "1", "2", "3"]


def test_a_process_that_imported_torch_counts_as_touched():
    """What a worker answers the node manager's question: once torch is
    imported, ``torch.cuda.is_available()`` may have started the driver
    under the current view while ``is_initialized()`` stays False, so the
    answer is yes; a pool worker that never imported torch answers no."""
    import subprocess
    import sys

    import torch

    from ray_tpu_torch.core.core_worker import CoreWorker

    torch.cuda.is_available()
    assert not torch.cuda.is_initialized()
    assert CoreWorker.rpc_cuda_initialized(None, None) is True
    fresh = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "from ray_tpu_torch.core.core_worker import CoreWorker\n"
         "print(CoreWorker.rpc_cuda_initialized(None, None),"
         " 'torch' in sys.modules)"],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert fresh.stdout.split() == ["False", "False"], fresh.stderr


def test_reuse_rule_asks_before_pinning_a_worker_anew():
    """The node manager's choice of an idle worker, on its own: a lease of
    a worker's own cards takes it without asking; a lease of other cards
    asks whether its process initialised CUDA, keeps one that did off
    those leases for good, and pins one that did not anew; a CPU-only
    lease takes only a worker that sees every card."""
    import asyncio

    from ray_tpu_torch.core.node_manager import NodeManager, _FakeProc, _Worker

    class Conn:
        def __init__(self, touched):
            self.touched, self.asked = touched, 0

        async def call(self, method, arg=None, timeout=None):
            assert method == "cuda_initialized"
            self.asked += 1
            return self.touched

    nm = object.__new__(NodeManager)     # no daemon: the choice alone
    nm.workers, nm._unregistered, nm._stopping = {}, [], True
    nm._all_cards = ("0", "1")

    def worker(key, view, touched):
        w = _Worker(_FakeProc(), view)
        w.conn = Conn(touched)
        nm.workers[key] = w
        return w

    touched = worker("a", ("0",), True)
    fresh = worker("b", ("0", "1"), False)
    assert asyncio.run(nm._claim_for_cards(("0",))) is touched
    assert touched.conn.asked == 0
    touched.busy = False
    assert asyncio.run(nm._claim_for_cards(("1",))) is fresh
    assert touched.cuda_fixed and touched.conn.asked == 1
    assert not touched.busy and fresh.busy
    fresh.busy = False
    fresh.view = ("1",)                  # the grant pins it
    assert nm._try_claim_idle(None) is None   # no worker sees every card
    # both cards: the touched worker is never asked again, the untouched
    # one is pinned anew once more
    assert asyncio.run(nm._claim_for_cards(("0", "1"))) is fresh
    assert touched.conn.asked == 1 and fresh.conn.asked == 2


def test_a_gpu_lease_waiting_on_its_spawn_takes_another_fresh_worker():
    """A GPU lease that starts a worker and finds it taken by another lease
    once it registers takes another idle worker the rule allows (one that
    never initialised CUDA), as a CPU-only lease would: it does not wait
    out the startup timeout for a worker that sees its card already."""
    import asyncio

    from ray_tpu_torch.core.node_manager import NodeManager, _FakeProc, _Worker

    class Conn:
        async def call(self, method, arg=None, timeout=None):
            return False                  # CUDA untouched

    nm = object.__new__(NodeManager)
    nm.workers, nm._unregistered, nm._stopping = {}, [], True
    nm._all_cards = ("0", "1")
    spawned = _Worker(_FakeProc(), nm._all_cards)
    nm._spawn_worker = lambda: spawned

    async def run():
        claim = asyncio.ensure_future(
            nm._get_idle_worker(timeout_s=5.0, view=("1",)))
        await asyncio.sleep(0.1)
        # the spawn registers and another lease takes it; a pool worker
        # registers beside it
        spawned.info, spawned.conn, spawned.busy = "w1", Conn(), True
        other = _Worker(_FakeProc(), nm._all_cards)
        other.conn = Conn()
        nm.workers["w2"] = other
        return await asyncio.wait_for(claim, 3.0), other

    got, other = asyncio.run(run())
    assert got is other and other.busy


def _pinned_loop(config):
    import os

    from ray_tpu_torch import train

    ctx = train.get_context()
    with open(os.path.join(config["log_dir"], "views.log"), "a") as f:
        f.write(f"{ctx.get_world_rank()},"
                f"{os.environ.get('CUDA_VISIBLE_DEVICES')}\n")
    train.report({"rank": ctx.get_world_rank()})


def test_gpu_train_workers_each_pin_their_card(cluster, tmp_path):
    """ScalingConfig(num_workers=2, use_gpu=True): each TrainWorker's
    lease pins a card of its own, the card its get_mesh() would open as
    cuda:0 (read from the environment, without touching CUDA)."""
    result = train.TorchTrainer(
        _pinned_loop, train_loop_config={"log_dir": str(tmp_path)},
        scaling_config=train.ScalingConfig(num_workers=2, use_gpu=True),
        run_config=train.RunConfig(name="pinned",
                                   storage_path=str(tmp_path / "exp")),
    ).fit()
    assert result.error is None
    rows = dict(line.split(",")
                for line in (tmp_path / "views.log").read_text().split())
    assert set(rows) == {"0", "1"}
    assert len(set(rows.values())) == 2
    assert set(rows.values()) <= {"0", "1", "2", "3"}
