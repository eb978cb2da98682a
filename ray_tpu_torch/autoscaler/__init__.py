"""Autoscaler: slice-granular scale-up/down driven by GCS demand (ref:
python/ray/autoscaler/ — v2 reconciler architecture, a local multi-node
provider for tests, and a Compute Engine provider of GPU VMs)."""

from ray_tpu_torch.autoscaler.autoscaler import Autoscaler  # noqa: F401
from ray_tpu_torch.autoscaler.node_provider import (  # noqa: F401
    LocalNodeProvider, NodeProvider, NodeTypeConfig)
