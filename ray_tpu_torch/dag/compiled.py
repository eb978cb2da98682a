"""Per-call compiled DAG execution — the FALLBACK executor.

Eligible DAGs compile onto pre-allocated channels (shm rings node-local,
DCN ring channels cross-node, device channels for tensor edges) with
frozen per-actor schedules instead (dag/channel_exec.py — the fast
path, ref analog: python/ray/dag/compiled_dag_node.py:757 +
dag_node_operation.py); this module handles the rest: graphs with
function nodes.

compile() topologically sorts the graph once and freezes the submission
plan; execute() replays it with object refs wired producer→consumer, so
intermediate values move directly worker-to-worker through the object
store (the driver only submits).

Device edges: a node marked `.with_tensor_transport()` keeps its
tensor output in the producing actor's memory (the card's, for a CUDA
tensor) and the consumer fetches raw bytes directly from that actor,
rebuilding the tensor on its own device — no host pickle bounce through
the object store (ref analog: torch_tensor_nccl_channel.py NCCL
channels; see core/device_objects.py).

Pipeline parallelism: execute_async() overlaps successive executions —
each call submits immediately without waiting for prior results, so
microbatch k+1's stage-1 runs while microbatch k is in stage 2 (the
actors' ordered queues form the pipeline).
"""

from __future__ import annotations

from typing import Any

from ray_tpu_torch.dag.node import (ClassMethodNode, DAGNode, FunctionNode,
                                    InputAttributeNode, InputNode, MultiOutputNode)


def _collective_apply_fallback(self, gname: str, world: int, rank: int,
                               spec: str, value):
    """Runs on the member actor via __rayt_apply__: one-shot out-of-band
    reduction for the per-call executor (the channel executor keeps a
    long-lived group instead, and lowers in-mesh when the participants
    share one device mesh)."""
    from ray_tpu_torch.util.collective import init_collective_group

    kind, op = spec.split(":")
    assert kind in ("allreduce", "allgather"), spec
    group = init_collective_group(world, rank, group_name=gname)
    try:
        if kind == "allreduce":
            return group.allreduce(value, op=op)
        return group.allgather(value)
    finally:
        try:
            group.destroy()
        except Exception:
            pass


class CompiledDAGRef:
    """Future for one execute(); resolves to the output node's value(s)."""

    def __init__(self, refs, multi: bool):
        self._refs = refs
        self._multi = multi

    def get(self, timeout: float | None = None):
        import ray_tpu_torch as rt

        values = rt.get(self._refs, timeout=timeout)
        return values if self._multi else values[0]


class CompiledDAG:
    # per-call submissions already get per-call fault tolerance (task
    # retries + lineage), so the recovery engine (dag/recovery.py)
    # treats this executor as never having dead-ring failures: epoch
    # stays 0 and failed_peers() is always empty.
    epoch = 0

    def __init__(self, output_node: DAGNode):
        self.output_node = output_node
        self.topo = self._topo_sort(output_node)
        self.input_node = None
        for node in self.topo:
            if isinstance(node, InputNode):
                if self.input_node is not None and \
                        self.input_node is not node:
                    raise ValueError("a DAG may have only one InputNode")
                self.input_node = node

    @staticmethod
    def _topo_sort(root: DAGNode) -> list[DAGNode]:
        order: list[DAGNode] = []
        seen: set[int] = set()

        def visit(node: DAGNode):
            if id(node) in seen:
                return
            seen.add(id(node))
            for up in node._upstream():
                visit(up)
            order.append(node)

        visit(root)
        return order

    # ------------------------------------------------------------- execution
    def execute_async(self, *args, **kwargs) -> CompiledDAGRef:
        """Submit one pass through the DAG; returns immediately (pipeline
        microbatches by calling repeatedly)."""
        import uuid

        # unique per execution: collective members of THIS pass rendezvous
        # under it, so overlapping/repeated executions never collide
        exec_tag = uuid.uuid4().hex[:8]
        values: dict[int, Any] = {}
        for node in self.topo:
            if isinstance(node, InputNode):
                if len(args) == 1 and not kwargs:
                    values[id(node)] = args[0]
                else:
                    values[id(node)] = (args, kwargs)
            elif isinstance(node, InputAttributeNode):
                parent_val = values[id(node.parent)]
                if isinstance(parent_val, tuple) and len(parent_val) == 2 \
                        and isinstance(parent_val[1], dict):
                    a, kw = parent_val
                    values[id(node)] = (kw[node.key] if node.by_attr
                                        else a[node.key])
                elif node.by_attr:
                    values[id(node)] = getattr(parent_val, node.key)
                else:
                    values[id(node)] = parent_val[node.key]
            elif isinstance(node, ClassMethodNode) and \
                    getattr(node, "collective", None):
                # per-call fallback for collective nodes: each member actor
                # joins a per-tick out-of-band group and reduces (slow path
                # — the channel executor keeps one long-lived group)
                from ray_tpu_torch.api import ActorMethod

                gname = f"{node.collective_group}-{exec_tag}"
                val = self._resolve(node.args[0], values)
                m = ActorMethod(node.actor, "__rayt_apply__")
                values[id(node)] = m.remote(
                    _collective_apply_fallback, gname,
                    node.collective_world, node.collective_rank,
                    node.collective, val)
            elif isinstance(node, ClassMethodNode):
                call_args = tuple(self._resolve(a, values)
                                  for a in node.args)
                call_kwargs = {k: self._resolve(v, values)
                               for k, v in node.kwargs.items()}
                method = getattr(node.actor, node.method_name)
                if getattr(node, "tensor_transport", False):
                    method = method.options(tensor_transport=True)
                values[id(node)] = method.remote(*call_args, **call_kwargs)
            elif isinstance(node, FunctionNode):
                call_args = tuple(self._resolve(a, values)
                                  for a in node.args)
                call_kwargs = {k: self._resolve(v, values)
                               for k, v in node.kwargs.items()}
                values[id(node)] = node.remote_fn.remote(*call_args,
                                                         **call_kwargs)
            elif isinstance(node, MultiOutputNode):
                values[id(node)] = [self._to_ref(values[id(o)])
                                    for o in node.outputs]
        out = values[id(self.output_node)]
        if isinstance(self.output_node, MultiOutputNode):
            return CompiledDAGRef(out, multi=True)
        return CompiledDAGRef([self._to_ref(out)], multi=False)

    def execute(self, *args, **kwargs):
        """Submit and return a CompiledDAGRef (call .get() for values)."""
        return self.execute_async(*args, **kwargs)

    @staticmethod
    def _resolve(arg: Any, values: dict):
        if isinstance(arg, DAGNode):
            return values[id(arg)]
        return arg

    @staticmethod
    def _to_ref(value: Any):
        import ray_tpu_torch as rt
        from ray_tpu_torch.core.object_ref import ObjectRef

        if isinstance(value, ObjectRef):
            return value
        return rt.put(value)

    def failed_peers(self) -> dict:
        return {}  # per-call path: retries handle actor death already

    def teardown(self):
        pass  # per-call path holds no persistent resources
