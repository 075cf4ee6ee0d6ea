"""tpu_dist_torch.parallel — counterpart of ``tpu_dist.parallel``."""

from .ddp import DistributedDataParallel, TrainState, convert_sync_batchnorm

__all__ = ["DistributedDataParallel", "TrainState", "convert_sync_batchnorm"]
