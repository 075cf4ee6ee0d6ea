"""tpu_dist_torch.optim — counterpart of ``tpu_dist.optim``."""

from .sgd import SGD

__all__ = ["SGD"]
