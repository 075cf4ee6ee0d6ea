"""tpu_dist_torch.utils — counterpart of ``tpu_dist.utils`` (the parts the
serving path, the control plane and the elastic loop use)."""

from .backoff import BackoffDeadlineError, retry_call
from .logging import MetricLogger, log_event, rank_zero_print
from .metrics import LatencyHistogram

__all__ = ["LatencyHistogram", "retry_call", "BackoffDeadlineError",
           "rank_zero_print", "MetricLogger", "log_event"]
