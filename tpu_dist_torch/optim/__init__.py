"""tpu_dist_torch.optim — counterpart of ``tpu_dist.optim``: multi-tensor
optimizers updating in place, clipping, EMA and host-evaluated lr
schedules."""

from .adagrad import Adagrad
from .adamw import Adam, AdamW
from .clip import (clip_grad_norm, global_norm, sharded_clip_grad_norm,
                   sharded_global_norm)
from .ema import EMA
from .lr_scheduler import (constant_lr, cosine_annealing_lr, exponential_lr,
                           linear_lr, multistep_lr, sequential_lr, step_lr,
                           warmup_cosine)
from .rmsprop import RMSprop
from .sgd import SGD

__all__ = ["SGD", "Adam", "AdamW", "RMSprop", "Adagrad", "EMA",
           "clip_grad_norm", "global_norm",
           "sharded_clip_grad_norm", "sharded_global_norm",
           "step_lr", "multistep_lr", "exponential_lr", "linear_lr",
           "cosine_annealing_lr", "constant_lr", "sequential_lr",
           "warmup_cosine"]
