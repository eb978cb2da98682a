"""ray_tpu_torch.dag — static dataflow graphs over actors (ref analog:
python/ray/dag compiled graphs; SURVEY.md §2.2 — the reference's
accelerator-native fast path)."""

from ray_tpu_torch.dag import collective  # noqa: F401
from ray_tpu_torch.dag.channel import ShmChannel  # noqa: F401
from ray_tpu_torch.dag.channel_exec import ChannelCompiledDAG  # noqa: F401
from ray_tpu_torch.dag.dcn_channel import DcnChannelSpec  # noqa: F401
from ray_tpu_torch.dag.device_channel import (DeviceChannel,  # noqa: F401
                                              DeviceChannelSpec,
                                              DeviceTransportChannel,
                                              donating_jit)
from ray_tpu_torch.dag.compiled import CompiledDAG, CompiledDAGRef  # noqa: F401
from ray_tpu_torch.dag.node import (ClassMethodNode, DAGNode,  # noqa: F401
                                    FunctionNode, InputNode, MultiOutputNode)
