from ray_tpu_torch.util.collective.collective import (  # noqa: F401
    allgather, allreduce, barrier, broadcast, create_collective_group,
    destroy_collective_group, get_collective_group_size, get_group, get_rank,
    init_collective_group, is_group_initialized, recv, reducescatter, send)
