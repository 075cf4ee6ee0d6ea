"""tpu_dist_torch.dist — counterpart of ``tpu_dist.dist``: process groups,
rendezvous and the control-plane stores."""

from .process_group import (DATA_AXIS, AxisGroup, GroupMembershipError,
                            ProcessGroup, abort, axis_group, barrier,
                            destroy_process_group, get_backend,
                            get_default_group, get_local_rank,
                            get_local_world_size, get_num_processes,
                            get_rank, get_world_size, init_process_group,
                            is_initialized, monitored_barrier, new_group)
from .rendezvous import generation, get_store, parse_init_method, rendezvous
from .store import FileStore, Store, TCPStore

__all__ = ["ProcessGroup", "AxisGroup", "GroupMembershipError",
           "init_process_group", "destroy_process_group", "is_initialized",
           "get_default_group", "get_world_size", "get_rank", "get_backend",
           "get_local_rank", "get_local_world_size", "get_num_processes",
           "new_group", "barrier", "monitored_barrier", "abort",
           "axis_group", "DATA_AXIS", "rendezvous", "parse_init_method",
           "generation", "get_store", "Store", "TCPStore", "FileStore"]
