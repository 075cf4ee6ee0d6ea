"""tpu_dist_torch.utils — observability helpers; counterpart of
``tpu_dist.utils`` (the same export list)."""

from .backoff import BackoffDeadlineError, retry_call
from .logging import MetricLogger, log_event, rank_zero_print
from .memory import (max_memory_allocated, mem_get_info, memory_allocated,
                     memory_stats, memory_summary)
from .metrics import (LatencyHistogram, accuracy, collective_counters,
                      confusion_matrix, record_collective,
                      reset_collective_counters, topk_accuracy)
from .profiler import StepTimer, trace

__all__ = ["rank_zero_print", "MetricLogger", "log_event", "StepTimer",
           "trace",
           "retry_call", "BackoffDeadlineError",
           "topk_accuracy", "accuracy", "confusion_matrix",
           "record_collective", "collective_counters",
           "reset_collective_counters", "LatencyHistogram",
           "memory_stats", "memory_allocated", "max_memory_allocated",
           "mem_get_info", "memory_summary"]
