"""Workflow DAG construction + durable executor (ref analogs:
python/ray/workflow/workflow_executor.py:32 — step scheduling loop;
workflow_state_from_dag.py — DAG -> steps; storage/ — checkpoint layout).

Storage layout (one dir per workflow under the workflow root):
  <root>/<workflow_id>/
    meta.json                  {"status": ..., "output_step": id}
    steps/<step_id>.pkl        checkpointed step result
    steps/<step_id>.json       {"name", "upstream": [...]}
    events/<name>.pkl          durable delivered-event payloads
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

# under the process's temp dir, beside the CLI's head state and the job
# logs: a root shared by every process on the machine (two checkouts, or
# both packages) would mix their workflows under one id
DEFAULT_ROOT = os.path.expanduser(
    os.environ.get("RAYT_WORKFLOW_ROOT", os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch", "workflows")))


@dataclass
class StepNode:
    fn: Callable
    args: tuple
    kwargs: dict
    name: str
    max_retries: int = 3
    num_cpus: float = 1.0
    _step_id: Optional[str] = field(default=None, repr=False)

    def options(self, *, name: Optional[str] = None,
                max_retries: Optional[int] = None,
                num_cpus: Optional[float] = None) -> "StepNode":
        if name is not None:
            self.name = name
        if max_retries is not None:
            self.max_retries = max_retries
        if num_cpus is not None:
            self.num_cpus = num_cpus
        return self

    # ------------------------------------------------------------ identity
    def step_id(self) -> str:
        """Content-derived id: function name + plain-arg repr + upstream
        step ids, so editing a step invalidates its own and downstream
        checkpoints only (ref: workflow step id semantics)."""
        if self._step_id is None:
            h = hashlib.sha256()
            h.update(self.name.encode())
            for a in list(self.args) + sorted(
                    self.kwargs.items(), key=lambda kv: kv[0]):
                if isinstance(a, tuple):  # kwargs item
                    h.update(repr(a[0]).encode())
                    a = a[1]
                if isinstance(a, StepNode):
                    h.update(a.step_id().encode())
                else:
                    h.update(repr(a).encode())
            self._step_id = f"{self.name}-{h.hexdigest()[:16]}"
        return self._step_id

    def upstream(self) -> list["StepNode"]:
        out = [a for a in self.args if isinstance(a, StepNode)]
        out += [v for v in self.kwargs.values() if isinstance(v, StepNode)]
        return out


class EventNode(StepNode):
    """A step satisfied by an EXTERNAL event instead of a task (ref
    analog: ray.workflow event system / wait_for_event): the workflow
    parks until ``send_event(workflow_id, name, payload)`` lands; the
    payload is checkpointed like any step result, so resume after a
    crash replays it without waiting again."""

    def __init__(self, name: str, timeout_s: Optional[float] = None):
        super().__init__(fn=None, args=(), kwargs={},
                         name=f"event:{name}")
        self.event_name = name
        self.timeout_s = timeout_s


def wait_for_event(name: str,
                   timeout_s: Optional[float] = None) -> EventNode:
    return EventNode(name, timeout_s)


def send_event(workflow_id: str, name: str, payload: Any = None, *,
               storage: Optional[str] = None) -> None:
    """Deliver an event to a (possibly running) workflow. Durable: the
    payload is written into the workflow's storage, so it survives both
    sender and workflow restarts."""
    store = _Store(workflow_id, storage)
    store.save_event(name, payload)


class Continuation:
    """Returned BY a step to hand control to a sub-workflow: the step's
    durable result becomes the continuation DAG's result (ref analog:
    ray.workflow.continuation — nested workflows)."""

    def __init__(self, node: StepNode):
        if not isinstance(node, StepNode):
            raise TypeError("continuation() takes a bound step")
        self.node = node


def continuation(node: StepNode) -> Continuation:
    return Continuation(node)


def step(fn: Callable = None, **opts):
    """Decorator: `fn.bind(*args)` builds a StepNode DAG."""
    def wrap(f):
        class _Builder:
            def __init__(self):
                self.__name__ = f.__name__

            def bind(self, *args, **kwargs) -> StepNode:
                node = StepNode(f, args, kwargs, name=f.__name__)
                return node.options(**opts) if opts else node

            def __call__(self, *args, **kwargs):
                return f(*args, **kwargs)

        return _Builder()
    return wrap(fn) if fn is not None else wrap


# ----------------------------------------------------------------- storage
def _wf_dir(workflow_id: str, root: Optional[str]) -> str:
    return os.path.join(root or DEFAULT_ROOT, workflow_id)


def _write_json(path: str, data: dict):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f)
    os.replace(tmp, path)


class _Store:
    def __init__(self, workflow_id: str, root: Optional[str]):
        self.dir = _wf_dir(workflow_id, root)
        self.steps_dir = os.path.join(self.dir, "steps")

    def _ensure(self):
        os.makedirs(self.steps_dir, exist_ok=True)

    def has(self, step_id: str) -> bool:
        return os.path.exists(os.path.join(self.steps_dir,
                                           step_id + ".pkl"))

    def load(self, step_id: str) -> Any:
        with open(os.path.join(self.steps_dir, step_id + ".pkl"),
                  "rb") as f:
            return pickle.load(f)

    def save(self, step_id: str, value: Any, meta: dict):
        self._ensure()
        path = os.path.join(self.steps_dir, step_id + ".pkl")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(value, f, protocol=4)
        os.replace(tmp, path)
        _write_json(os.path.join(self.steps_dir, step_id + ".json"), meta)

    # ------------------------------------------------------------- events
    def _event_path(self, name: str) -> str:
        return os.path.join(self.dir, "events", name + ".pkl")

    def save_event(self, name: str, payload: Any):
        path = self._event_path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=4)
        os.replace(tmp, path)

    def has_event(self, name: str) -> bool:
        return os.path.exists(self._event_path(name))

    def load_event(self, name: str) -> Any:
        with open(self._event_path(name), "rb") as f:
            return pickle.load(f)

    def set_meta(self, **kv):
        self._ensure()
        path = os.path.join(self.dir, "meta.json")
        meta = self.meta()
        meta.update(kv)
        _write_json(path, meta)

    def meta(self) -> dict:
        try:
            with open(os.path.join(self.dir, "meta.json")) as f:
                return json.load(f)
        except OSError:
            return {}


# ---------------------------------------------------------------- executor
def _topo(final: StepNode) -> list[StepNode]:
    order: list[StepNode] = []
    seen: set[str] = set()

    def visit(node: StepNode):
        if node.step_id() in seen:
            return
        seen.add(node.step_id())
        for up in node.upstream():
            visit(up)
        order.append(node)

    visit(final)
    return order


def _execute(final: StepNode, store: _Store) -> Any:
    """Run the DAG over cluster tasks, checkpointing every step result.
    Independent branches execute concurrently: every step whose upstreams
    are resolved is submitted immediately, and results are checkpointed as
    they arrive (ref: workflow_executor.py step scheduling loop)."""
    import ray_tpu_torch as rt

    nodes = {n.step_id(): n for n in _topo(final)}
    results: dict[str, Any] = {}
    for sid in nodes:
        if store.has(sid):
            results[sid] = store.load(sid)
    submitted: set[str] = set(results)
    inflight: dict[Any, str] = {}  # ObjectRef -> step_id

    def resolve(a):
        return results[a.step_id()] if isinstance(a, StepNode) else a

    event_started: dict[str, float] = {}

    def submit_ready():
        for sid, node in nodes.items():
            if sid in submitted:
                continue
            if any(u.step_id() not in results for u in node.upstream()):
                continue
            if isinstance(node, EventNode):
                event_started.setdefault(sid, time.monotonic())
                if store.has_event(node.event_name):
                    payload = store.load_event(node.event_name)
                    store.save(sid, payload, {
                        "name": node.name, "upstream": [],
                        "finished_at": time.time()})
                    results[sid] = payload
                    submitted.add(sid)
                elif node.timeout_s is not None and (
                        time.monotonic() - event_started[sid]
                        > node.timeout_s):
                    raise TimeoutError(
                        f"event {node.event_name!r} not delivered within "
                        f"{node.timeout_s}s")
                continue   # parked until the event lands
            args = [resolve(a) for a in node.args]
            kwargs = {k: resolve(v) for k, v in node.kwargs.items()}
            task = rt.remote(num_cpus=node.num_cpus,
                             max_retries=node.max_retries)(node.fn)
            inflight[task.remote(*args, **kwargs)] = sid
            submitted.add(sid)

    def harvest(ref, draining: bool = False) -> Exception | None:
        """Checkpoint one finished ref; return its error instead of raising
        so a failing branch can't discard completed siblings' results. A
        step returning a Continuation hands control to its sub-workflow:
        the sub-DAG executes against the SAME store (its steps checkpoint
        and resume individually) and its result becomes the step's.
        While DRAINING after a failure, continuations are NOT started
        (no new work after first_error) — the step stays un-checkpointed
        and resume re-runs it."""
        sid = inflight.pop(ref)
        try:
            value = rt.get(ref)
            if isinstance(value, Continuation):
                if draining:
                    return None
                value = _execute(value.node, store)
            node = nodes[sid]
            store.save(sid, value, {
                "name": node.name,
                "upstream": [u.step_id() for u in node.upstream()],
                "finished_at": time.time()})
        except Exception as e:  # incl. save errors (ENOSPC, ...): the
            return e            # drain loop must never lose first_error
        results[sid] = value
        return None

    first_error: Exception | None = None
    submit_ready()  # nothing in flight yet: a submit error may propagate
    while final.step_id() not in results:
        if not inflight:
            parked = [n for sid, n in nodes.items()
                      if isinstance(n, EventNode) and sid not in results]
            if parked:
                time.sleep(0.1)      # waiting on external events
                submit_ready()
                continue
            raise RuntimeError("workflow has unrunnable steps (cycle?)")
        has_parked_events = any(
            isinstance(n, EventNode) and sid not in results
            for sid, n in nodes.items())
        done, _ = rt.wait(list(inflight), num_returns=1,
                          timeout=0.2 if has_parked_events else None)
        for ref in done:
            first_error = first_error or harvest(ref)
        if first_error is None:
            try:
                submit_ready()
            except Exception as e:  # submission failure: drain like a
                first_error = e     # failed step so siblings checkpoint
        if first_error is not None:
            # drain still-running siblings so their work is checkpointed
            # before the failure propagates (resume won't redo it)
            while inflight:
                done, _ = rt.wait(list(inflight),
                                  num_returns=len(inflight), timeout=300.0)
                if not done:
                    break
                for ref in done:
                    harvest(ref, draining=True)
            raise first_error
    return results[final.step_id()]


def run(final: StepNode, *, workflow_id: Optional[str] = None,
        storage: Optional[str] = None) -> Any:
    """Execute a workflow durably; returns the final step's result."""
    workflow_id = workflow_id or f"wf-{int(time.time() * 1000):x}"
    store = _Store(workflow_id, storage)
    store.set_meta(status="RUNNING", workflow_id=workflow_id,
                   output_step=final.step_id(), started_at=time.time())
    try:
        out = _execute(final, store)
    except Exception as e:
        store.set_meta(status="FAILED", error=repr(e))
        raise
    store.set_meta(status="SUCCESSFUL", finished_at=time.time())
    return out


def resume(workflow_id: str, final: StepNode, *,
           storage: Optional[str] = None) -> Any:
    """Re-run an interrupted workflow: checkpointed steps are loaded,
    the rest execute (ref: workflow resume semantics)."""
    store = _Store(workflow_id, storage)
    store.set_meta(status="RUNNING")
    try:
        out = _execute(final, store)
    except Exception as e:
        store.set_meta(status="FAILED", error=repr(e))
        raise
    store.set_meta(status="SUCCESSFUL", finished_at=time.time())
    return out


def get_output(workflow_id: str, *, storage: Optional[str] = None) -> Any:
    store = _Store(workflow_id, storage)
    meta = store.meta()
    if meta.get("status") != "SUCCESSFUL":
        raise RuntimeError(
            f"workflow {workflow_id} is {meta.get('status', 'UNKNOWN')}")
    return store.load(meta["output_step"])


def list_workflows(*, storage: Optional[str] = None) -> list[dict]:
    root = storage or DEFAULT_ROOT
    out = []
    try:
        ids = os.listdir(root)
    except OSError:
        return out
    for wid in sorted(ids):
        meta = _Store(wid, storage).meta()
        if meta:
            out.append(meta)
    return out
