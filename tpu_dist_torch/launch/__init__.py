"""tpu_dist_torch.launch — counterpart of ``tpu_dist.launch``: ``spawn``
(``torch.multiprocessing.spawn``).  The ``python -m ...launch`` CLI is
ROADMAP A5."""

from .spawn import (ProcessContext, ProcessExitedException,
                    ProcessRaisedException, spawn)

__all__ = ["spawn", "ProcessContext", "ProcessRaisedException",
           "ProcessExitedException"]
