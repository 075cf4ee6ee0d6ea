"""tpu_dist_torch.dist — counterpart of ``tpu_dist.dist`` (process groups)."""

from .process_group import (DATA_AXIS, AxisGroup, ProcessGroup, axis_group,
                            destroy_process_group, get_default_group,
                            get_rank, get_world_size, init_process_group,
                            is_initialized)

__all__ = ["ProcessGroup", "AxisGroup", "init_process_group",
           "destroy_process_group", "is_initialized", "get_default_group",
           "get_world_size", "get_rank", "axis_group", "DATA_AXIS"]
