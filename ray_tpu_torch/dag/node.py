"""DAG node types (ref analogs: python/ray/dag/dag_node.py,
input_node.py, output_node.py; built by `actor.method.bind(...)`)."""

from __future__ import annotations

from typing import Any


class DAGNode:
    def execute(self, *args, **kwargs):
        from ray_tpu_torch.dag.compiled import CompiledDAG

        return CompiledDAG(self).execute(*args, **kwargs)

    def experimental_compile(self, *, buffer_size_bytes: int = 1 << 20,
                             max_inflight: int = 8,
                             channels: object = "auto",
                             device_input: bool = False,
                             epoch: int = 0,
                             recovered_from: str = "") -> "object":
        """Compile the DAG. channels="auto" uses the pre-allocated
        channel fast path (dag/channel_exec.py) when the graph is
        eligible (actor-only): node-local edges ride shm rings,
        cross-node edges ride DCN channels over the RPC plane, and
        edges whose producer is marked ``.with_tensor_transport()``
        ride DEVICE channels (tensor leaves as raw host bytes,
        rebuilt on the consumer's devices). ``device_input=True`` marks
        the driver's input edges device too (weight broadcasts).
        Falls back to the per-call executor only for function nodes;
        True forces channels (raises if ineligible); False forces the
        per-call executor. ``epoch``/``recovered_from`` are set by the
        recovery engine (dag/recovery.py) on a recompile-and-resume:
        frames are then stamped with the epoch so pre-failure leftovers
        are discarded, and the GCS record links to the replaced ring."""
        from ray_tpu_torch.dag.compiled import CompiledDAG

        if channels in ("auto", True):
            from ray_tpu_torch.dag.channel_exec import (ChannelCompiledDAG,
                                                        Ineligible)

            try:
                return ChannelCompiledDAG(
                    self, CompiledDAG._topo_sort(self),
                    buffer_size_bytes=buffer_size_bytes,
                    max_inflight=max_inflight,
                    device_input=device_input,
                    epoch=epoch, recovered_from=recovered_from)
            except Ineligible:
                if channels is True:
                    raise
        return CompiledDAG(self)

    def _upstream(self) -> list["DAGNode"]:
        return []


class InputNode(DAGNode):
    """The DAG's runtime argument (context-manager form mirrors the
    reference: `with InputNode() as inp: ...`)."""

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc):
        return False


class InputAttributeNode(DAGNode):
    """inp[0] / inp.key — selects part of a (args, kwargs) input."""

    def __init__(self, parent: InputNode, key: Any, by_attr: bool):
        self.parent = parent
        self.key = key
        self.by_attr = by_attr

    def _upstream(self):
        return [self.parent]


def _input_getitem(self: InputNode, key):
    return InputAttributeNode(self, key, by_attr=False)


def _input_getattr(self: InputNode, key: str):
    if key.startswith("_"):
        raise AttributeError(key)
    return InputAttributeNode(self, key, by_attr=True)


InputNode.__getitem__ = _input_getitem
InputNode.__getattr__ = _input_getattr


class ClassMethodNode(DAGNode):
    """One bound actor-method call in the graph."""

    def __init__(self, actor_handle, method_name: str, args: tuple,
                 kwargs: dict):
        self.actor = actor_handle
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs
        self.tensor_transport = False

    def with_tensor_transport(self, transport: str = "auto"
                              ) -> "ClassMethodNode":
        """Mark this node's output as a DEVICE edge: the produced
        tensor stays in the producing actor's device memory and moves
        to consumers via host-staged raw-bytes transfer — never a pickle
        of the buffer (ref analog: dag_node.with_tensor_transport /
        TorchTensorType on compiled-graph edges)."""
        self.tensor_transport = True
        return self

    def _upstream(self):
        return [a for a in list(self.args) + list(self.kwargs.values())
                if isinstance(a, DAGNode)]

    def __repr__(self):
        return (f"ClassMethodNode({self.actor._class_name}."
                f"{self.method_name})")


class FunctionNode(DAGNode):
    """A bound remote-function call (task node)."""

    def __init__(self, remote_fn, args: tuple, kwargs: dict):
        self.remote_fn = remote_fn
        self.args = args
        self.kwargs = kwargs

    def _upstream(self):
        return [a for a in list(self.args) + list(self.kwargs.values())
                if isinstance(a, DAGNode)]


class MultiOutputNode(DAGNode):
    def __init__(self, outputs: list):
        self.outputs = list(outputs)

    def _upstream(self):
        return [o for o in self.outputs if isinstance(o, DAGNode)]
