"""Parallelism layer: device meshes, sharding rules, collectives, the
sharded train step and the GPipe pipeline (counterpart of
ray_tpu/parallel). Importing it imports no torch."""

from ray_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_EXPERT,  # noqa: F401
                                         AXIS_FSDP, AXIS_SEQ, AXIS_TENSOR,
                                         MeshConfig, build_mesh, local_mesh,
                                         named_sharding, replicated,
                                         shard_params)
