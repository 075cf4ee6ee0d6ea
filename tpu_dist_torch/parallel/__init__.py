"""tpu_dist_torch.parallel — counterpart of ``tpu_dist.parallel``."""

from .ddp import DistributedDataParallel, TrainState, convert_sync_batchnorm
from .ring_attention import ring_self_attention, ulysses_self_attention

__all__ = ["DistributedDataParallel", "TrainState", "convert_sync_batchnorm",
           "ring_self_attention", "ulysses_self_attention"]
