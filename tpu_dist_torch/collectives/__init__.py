"""tpu_dist_torch.collectives — counterpart of ``tpu_dist.collectives``.

- **In-step** (:mod:`.ops`): ``all_reduce``, ``psum``, ``pmean``,
  ``all_gather``, ``reduce_scatter``, ``broadcast``, ``all_to_all``,
  ``ppermute`` and the teaching ``ring_all_reduce`` over a group of ranks
  or one of its mesh axes, on ``torch.distributed`` (NCCL on the card,
  gloo on the CPU).
- **Eager** (:mod:`.eager`): host-level collectives of numpy values on a
  :class:`~tpu_dist_torch.dist.ProcessGroup` (metric averaging, parameter
  broadcast, object collectives, ``send``/``recv``), on the group's backend
  or on the JAX package's routing (the store and the host data plane), as
  ``TPU_DIST_HOST_TRANSPORT`` and the group's backend decide.
- **The host data plane**: :mod:`.transport` (rank-to-rank sockets, CRC
  frames, ``PeerGoneError``/``FrameCorruptError``/
  ``CollectiveTimeoutError``), :mod:`.ring` (the chunk-pipelined ring
  collectives; ``ring.ring_all_reduce`` is the host twin of the in-step
  ``ops.ring_all_reduce``), :mod:`.shm` (shared-memory lanes),
  :mod:`.topology` (host detection, data-plane sub-groups, the
  hierarchical ring, ``TPU_DIST_ALGO``) and :mod:`.quant` (the
  ``int8_block256`` wire and ``ErrorFeedback``) — the JAX package's
  modules on its wire format.
- **Async** (:mod:`.work`): ``async_op=True`` returns a :class:`Work`; the
  :class:`Bucketer` (:mod:`.bucketer`) coalesces a gradient tree into
  chunk-major buckets, each one asynchronous reduce-scatter (and
  all-gather) on the backend or one ring collective on the host data
  plane, so ZeRO's shards are the all-reduce's own spans.
"""

from . import bucketer, eager, ops, quant, ring, shm, topology, transport, work
from .bucketer import (Bucketer, BucketWork, bucketed_all_reduce,
                       bucketed_reduce_scatter)
from .eager import (ReduceOp, all_gather_host, all_gather_object,
                    all_reduce_host, all_to_all_host, broadcast_host,
                    broadcast_object_list, gather_host, gather_object, recv,
                    reduce_host, scatter_host, scatter_object_list, send,
                    send_recv_device)
from .ops import (all_gather, all_reduce, all_to_all, broadcast, pmean,
                  ppermute, psum, reduce_scatter, ring_all_reduce)
from .quant import ErrorFeedback, QuantScheme
from .topology import (GroupMembershipError, SubGroup, Topology,
                       detect_topology, hier_all_reduce, new_group)
from .transport import (CollectiveTimeoutError, DataPlane,
                        FrameCorruptError, PeerGoneError)
from .work import Work, wait_all

__all__ = [
    "all_reduce", "all_gather", "reduce_scatter", "broadcast", "all_to_all",
    "ppermute", "psum", "pmean", "ring_all_reduce",
    "ReduceOp", "all_reduce_host", "all_gather_host", "broadcast_host",
    "reduce_host", "gather_host", "scatter_host", "send", "recv",
    "send_recv_device",
    "all_gather_object", "gather_object", "broadcast_object_list",
    "scatter_object_list", "all_to_all_host",
    "ring", "transport", "DataPlane", "PeerGoneError",
    "FrameCorruptError", "CollectiveTimeoutError",
    "work", "Work", "wait_all", "bucketer", "Bucketer", "BucketWork",
    "bucketed_all_reduce", "bucketed_reduce_scatter",
    "quant", "QuantScheme", "ErrorFeedback",
    "shm", "topology", "Topology", "SubGroup", "GroupMembershipError",
    "new_group", "detect_topology", "hier_all_reduce",
]
