"""SGD with momentum / nesterov / weight decay / dampening — counterpart of
``tpu_dist/optim/sgd.py`` (torch.optim.SGD semantics).

The same functional interface as the JAX package — ``init(params)`` builds
the state, ``update(grads, opt_state, params)`` returns ``(new_params,
new_opt_state)`` — over dicts of tensors.  Unlike the JAX package the update
runs in place on ``params`` and the state (the JAX package donates them),
which saves a copy of the model per step; the returned dicts hold the same
tensors.  ``update`` is multi-tensor: a few ``torch._foreach_*`` calls over
the parameters grouped by device and dtype, where a loop over the
parameters would launch a handful of kernels for each.
:meth:`SGD.update_plain` is that loop, the per-parameter reference the
multi-tensor update is checked against.

``lr`` may be a float or a schedule (:mod:`.lr_scheduler`) of the update
count; only with a schedule does ``opt_state`` keep ``"step"``, as in the
JAX package.

Update rule:

    g   = grad + weight_decay * param
    buf = momentum * buf + (1 - dampening) * g
    g   = g + momentum * buf        (nesterov)    |    g = buf   (classic)
    param -= lr * g
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ._foreach import grouped, lr_at, new_step, tick

__all__ = ["SGD"]


class SGD:
    def __init__(self, lr, momentum: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False,
                 dampening: float = 0.0):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires momentum > 0 and "
                             "dampening = 0")
        self.lr = lr if callable(lr) else float(lr)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.dampening = dampening

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        state: Dict[str, Any] = {}
        if callable(self.lr):
            state["step"] = new_step()
        if self.momentum != 0.0:
            state["momentum"] = {k: torch.zeros_like(p)
                                 for k, p in params.items()}
        return state

    def _lr(self, opt_state) -> float:
        # a schedule of the pre-update count: the first update uses lr(0)
        return lr_at(self.lr, tick(opt_state)) if callable(self.lr) \
            else self.lr

    @torch.no_grad()
    def update(self, grads, opt_state, params):
        """Apply one step in place; returns ``(params, opt_state)``."""
        mom, wd, damp = self.momentum, self.weight_decay, self.dampening
        lr = self._lr(opt_state)
        bufs = (opt_state["momentum"],) if mom != 0.0 else ()
        for ps, gs, *rest in grouped(params, grads, *bufs):
            if wd:
                gs = torch._foreach_add(gs, ps, alpha=wd)
            if mom == 0.0:
                torch._foreach_add_(ps, gs, alpha=-lr)
                continue
            (bs,) = rest
            # zero-initialized buffers give torch's first-step buf = g when
            # dampening is 0, as in the JAX package
            torch._foreach_mul_(bs, mom)
            torch._foreach_add_(bs, gs, alpha=1.0 - damp)
            if self.nesterov:
                torch._foreach_add_(ps, torch._foreach_add(gs, bs, alpha=mom),
                                    alpha=-lr)
            else:
                torch._foreach_add_(ps, bs, alpha=-lr)
        return params, opt_state

    @torch.no_grad()
    def update_plain(self, grads, opt_state, params):
        """:meth:`update` as a loop of element-wise ops over the parameters,
        in the JAX package's order: the reference the multi-tensor update
        is held to."""
        mom, wd, damp = self.momentum, self.weight_decay, self.dampening
        lr = self._lr(opt_state)
        for name, p in params.items():
            g = grads[name]
            if wd:
                g = g + wd * p
            if mom == 0.0:
                p.copy_(p - lr * g)
                continue
            buf = opt_state["momentum"][name]
            buf.copy_(mom * buf + (1.0 - damp) * g)
            p.copy_(p - lr * (g + mom * buf) if self.nesterov
                    else p - lr * buf)
        return params, opt_state

    def __repr__(self):
        return (f"SGD(lr={self.lr}, momentum={self.momentum}, "
                f"weight_decay={self.weight_decay}, "
                f"nesterov={self.nesterov})")
