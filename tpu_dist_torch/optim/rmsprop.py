"""RMSprop — counterpart of ``tpu_dist/optim/rmsprop.py`` (torch.optim.RMSprop
semantics).

The contract of :class:`~tpu_dist_torch.optim.SGD`: a multi-tensor
``update`` in place, and :meth:`RMSprop.update_plain`, the per-parameter
loop it is held to.

Update rule (torch semantics — eps is added AFTER the square root, and
weight decay folds into the gradient before the moment update):

    g   = g + wd * p
    sa  = alpha * sa + (1 - alpha) * g^2
    ga  = alpha * ga + (1 - alpha) * g          (centered only)
    den = sqrt(sa - ga^2) + eps                 (sa alone if not centered)
    buf = momentum * buf + g / den;  p -= lr * buf      (momentum > 0)
    p  -= lr * g / den                                  (momentum == 0)
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ._foreach import grouped, lr_at, new_step, tick

__all__ = ["RMSprop"]


class RMSprop:
    def __init__(self, lr=1e-2, alpha: float = 0.99, eps: float = 1e-8,
                 weight_decay: float = 0.0, momentum: float = 0.0,
                 centered: bool = False):
        """``lr`` may be a float or a schedule (:mod:`.lr_scheduler`)."""
        if not 0.0 <= alpha < 1.0:
            raise ValueError(f"Invalid alpha {alpha}")
        if eps <= 0.0:
            raise ValueError(f"Invalid eps {eps}")
        if momentum < 0.0:
            raise ValueError(f"Invalid momentum {momentum}")
        self.lr = lr
        self.alpha = alpha
        self.eps = eps
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.centered = centered

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        def zeros():
            return {k: torch.zeros_like(p) for k, p in params.items()}
        state: Dict[str, Any] = {"square_avg": zeros(), "step": new_step()}
        if self.momentum > 0.0:
            state["momentum_buffer"] = zeros()
        if self.centered:
            state["grad_avg"] = zeros()
        return state

    def _trees(self, opt_state):
        return ((opt_state["square_avg"],)
                + ((opt_state["grad_avg"],) if self.centered else ())
                + ((opt_state["momentum_buffer"],) if self.momentum > 0.0
                   else ()))

    @torch.no_grad()
    def update(self, grads, opt_state, params):
        """Apply one step in place; returns ``(params, opt_state)``."""
        a, wd, mom = self.alpha, self.weight_decay, self.momentum
        lr = lr_at(self.lr, tick(opt_state))
        for ps, gs, sas, *rest in grouped(params, grads,
                                          *self._trees(opt_state)):
            if wd:
                gs = torch._foreach_add(gs, ps, alpha=wd)
            torch._foreach_mul_(sas, a)
            torch._foreach_addcmul_(sas, gs, gs, value=1.0 - a)
            if self.centered:
                gas = rest.pop(0)
                torch._foreach_mul_(gas, a)
                torch._foreach_add_(gas, gs, alpha=1.0 - a)
                den = torch._foreach_addcmul(sas, gas, gas, value=-1.0)
                torch._foreach_sqrt_(den)
            else:
                den = torch._foreach_sqrt(sas)
            torch._foreach_add_(den, self.eps)
            if mom > 0.0:
                (bufs,) = rest
                torch._foreach_mul_(bufs, mom)
                torch._foreach_addcdiv_(bufs, gs, den)
                torch._foreach_add_(ps, bufs, alpha=-lr)
            else:
                torch._foreach_addcdiv_(ps, gs, den, value=-lr)
        return params, opt_state

    @torch.no_grad()
    def update_plain(self, grads, opt_state, params):
        """:meth:`update` as a loop of element-wise ops over the parameters,
        in the JAX package's order: the reference the multi-tensor update
        is held to."""
        a, wd, mom = self.alpha, self.weight_decay, self.momentum
        lr = lr_at(self.lr, tick(opt_state))
        for name, p in params.items():
            g = grads[name]
            if wd:
                g = g + wd * p
            sa = opt_state["square_avg"][name]
            sa.copy_(a * sa + (1.0 - a) * (g * g))
            if self.centered:
                ga = opt_state["grad_avg"][name]
                ga.copy_(a * ga + (1.0 - a) * g)
                den = torch.sqrt(sa - ga * ga) + self.eps
            else:
                den = torch.sqrt(sa) + self.eps
            if mom > 0.0:
                buf = opt_state["momentum_buffer"][name]
                buf.copy_(mom * buf + g / den)
                p.copy_(p - lr * buf)
            else:
                p.copy_(p - lr * g / den)
        return params, opt_state

    def __repr__(self):
        return (f"RMSprop(lr={self.lr}, alpha={self.alpha}, "
                f"momentum={self.momentum}, centered={self.centered})")
