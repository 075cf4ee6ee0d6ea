"""tpu_dist_torch.utils — counterpart of ``tpu_dist.utils`` (the parts the
serving path and the control plane use)."""

from .backoff import BackoffDeadlineError, retry_call
from .metrics import LatencyHistogram

__all__ = ["LatencyHistogram", "retry_call", "BackoffDeadlineError"]
