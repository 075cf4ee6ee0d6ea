"""tpu_dist_torch.launch — counterpart of ``tpu_dist.launch``: ``spawn``
(``torch.multiprocessing.spawn``, with supervised restarts) and the
``python -m tpu_dist_torch.launch`` CLI (``torch.distributed.launch``)."""

from .spawn import (ProcessContext, ProcessExitedException,
                    ProcessRaisedException, spawn)

__all__ = ["spawn", "ProcessContext", "ProcessRaisedException",
           "ProcessExitedException"]
