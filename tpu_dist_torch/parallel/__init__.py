"""tpu_dist_torch.parallel — counterpart of ``tpu_dist.parallel``."""

from .ddp import (DistributedDataParallel, Placement, TrainState,
                  convert_sync_batchnorm)
from .ring_attention import ring_self_attention, ulysses_self_attention
from .zero import ZeroOptimizer, ZeroParams, ZeroStateError

__all__ = ["DistributedDataParallel", "TrainState", "Placement",
           "convert_sync_batchnorm", "ring_self_attention",
           "ulysses_self_attention", "ZeroOptimizer", "ZeroParams",
           "ZeroStateError"]
