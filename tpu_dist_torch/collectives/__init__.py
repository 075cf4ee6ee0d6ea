"""tpu_dist_torch.collectives — counterpart of ``tpu_dist.collectives``.

- **In-step** (:mod:`.ops`): ``all_reduce``, ``psum``, ``pmean``,
  ``all_gather``, ``reduce_scatter``, ``broadcast``, ``all_to_all``,
  ``ppermute`` and the teaching ``ring_all_reduce`` over a group of ranks
  or one of its mesh axes, on ``torch.distributed`` (NCCL on the card,
  gloo on the CPU).
- **Eager** (:mod:`.eager`): host-level collectives of numpy values on a
  :class:`~tpu_dist_torch.dist.ProcessGroup` (metric averaging, parameter
  broadcast, object collectives, ``send``/``recv``), staged through the
  group's device on its own backend.
- **Async** (:mod:`.work`): ``async_op=True`` returns a :class:`Work`; the
  :class:`Bucketer` (:mod:`.bucketer`) coalesces a gradient tree into
  chunk-major buckets, each one asynchronous reduce-scatter (and
  all-gather), so ZeRO's shards are the all-reduce's own spans.

The JAX package's host socket data plane (``transport``, ``ring``,
``shm``, ``topology``), its quantized wire (``quant``, ``ErrorFeedback``)
and the errors of that transport are ROADMAP A9.1b.
"""

from . import bucketer, eager, ops, work
from .bucketer import (Bucketer, BucketWork, bucketed_all_reduce,
                       bucketed_reduce_scatter)
from .eager import (ReduceOp, all_gather_host, all_gather_object,
                    all_reduce_host, all_to_all_host, broadcast_host,
                    broadcast_object_list, gather_host, gather_object, recv,
                    reduce_host, scatter_host, scatter_object_list, send,
                    send_recv_device)
from .ops import (all_gather, all_reduce, all_to_all, broadcast, pmean,
                  ppermute, psum, reduce_scatter, ring_all_reduce)
from .work import Work, wait_all

__all__ = [
    "all_reduce", "all_gather", "reduce_scatter", "broadcast", "all_to_all",
    "ppermute", "psum", "pmean", "ring_all_reduce",
    "ReduceOp", "all_reduce_host", "all_gather_host", "broadcast_host",
    "reduce_host", "gather_host", "scatter_host", "send", "recv",
    "send_recv_device",
    "all_gather_object", "gather_object", "broadcast_object_list",
    "scatter_object_list", "all_to_all_host",
    "work", "Work", "wait_all", "bucketer", "Bucketer", "BucketWork",
    "bucketed_all_reduce", "bucketed_reduce_scatter",
]
