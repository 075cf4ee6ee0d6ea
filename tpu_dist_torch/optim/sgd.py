"""SGD with momentum / nesterov / weight decay / dampening — counterpart of
``tpu_dist/optim/sgd.py`` (torch.optim.SGD semantics).

The same functional interface as the JAX package — ``init(params)`` builds
the state, ``update(grads, opt_state, params)`` returns ``(new_params,
new_opt_state)`` — over dicts of tensors.  Unlike the JAX package the update
runs in place on ``params`` and the momentum buffers, which saves a copy of
the model per step; the returned dicts hold the same tensors.

Update rule:

    g   = grad + weight_decay * param
    buf = momentum * buf + (1 - dampening) * g
    g   = g + momentum * buf        (nesterov)    |    g = buf   (classic)
    param -= lr * g
"""

from __future__ import annotations

from typing import Any, Dict

import torch

__all__ = ["SGD"]


class SGD:
    def __init__(self, lr: float, momentum: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False,
                 dampening: float = 0.0):
        if callable(lr):
            raise NotImplementedError(
                "lr schedules come with the optim slice; pass a float lr")
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires momentum > 0 and "
                             "dampening = 0")
        self.lr = float(lr)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.dampening = dampening

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        if self.momentum == 0.0:
            return {}
        return {"momentum": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads, opt_state, params):
        """Apply one step in place; returns ``(params, opt_state)``."""
        mom, wd, damp, lr = (self.momentum, self.weight_decay, self.dampening,
                             self.lr)
        for name, p in params.items():
            g = grads[name]
            if wd:
                g = g + wd * p
            if mom == 0.0:
                p.add_(g, alpha=-lr)
                continue
            buf = opt_state["momentum"][name]
            # zero-initialized buffers give torch's first-step buf = g when
            # dampening is 0, as in the JAX package
            buf.mul_(mom).add_(g, alpha=1.0 - damp)
            if self.nesterov:
                p.add_(g + mom * buf, alpha=-lr)
            else:
                p.add_(buf, alpha=-lr)
        return params, opt_state
