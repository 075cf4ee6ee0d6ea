"""tpu_dist_torch.parallel — counterpart of ``tpu_dist.parallel``."""

from .ddp import DistributedDataParallel, TrainState

__all__ = ["DistributedDataParallel", "TrainState"]
