"""Adagrad — counterpart of ``tpu_dist/optim/adagrad.py`` (torch.optim.Adagrad
semantics).

The contract of :class:`~tpu_dist_torch.optim.SGD`: a multi-tensor
``update`` in place, and :meth:`Adagrad.update_plain`, the per-parameter
loop it is held to.  Update rule (torch semantics, including the built-in
lr decay over update count t = 1, 2, ...; ``clr`` in float32, as the JAX
package computes it on the device):

    g    = g + wd * p
    clr  = lr / (1 + (t - 1) * lr_decay)
    sum += g^2
    p   -= clr * g / (sqrt(sum) + eps)
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ._foreach import f32, grouped, lr_at, new_step, tick

__all__ = ["Adagrad"]


class Adagrad:
    def __init__(self, lr=1e-2, lr_decay: float = 0.0,
                 weight_decay: float = 0.0,
                 initial_accumulator_value: float = 0.0,
                 eps: float = 1e-10):
        if lr_decay < 0.0:
            raise ValueError(f"Invalid lr_decay {lr_decay}")
        if eps <= 0.0:
            raise ValueError(f"Invalid eps {eps}")
        if initial_accumulator_value < 0.0:
            raise ValueError(
                f"Invalid initial_accumulator_value "
                f"{initial_accumulator_value}")
        self.lr = lr
        self.lr_decay = lr_decay
        self.weight_decay = weight_decay
        self.initial_accumulator_value = initial_accumulator_value
        self.eps = eps

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        iv = self.initial_accumulator_value
        return {"sum": {k: torch.full_like(p, iv) for k, p in params.items()},
                "step": new_step()}

    def _clr(self, opt_state) -> float:
        t = tick(opt_state)  # the prior count: torch's t - 1
        lr = lr_at(self.lr, t)
        return f32(np.float32(lr) / (np.float32(1.0) + np.float32(t)
                                     * np.float32(self.lr_decay)))

    @torch.no_grad()
    def update(self, grads, opt_state, params):
        """Apply one step in place; returns ``(params, opt_state)``."""
        wd = self.weight_decay
        clr = self._clr(opt_state)
        for ps, gs, ss in grouped(params, grads, opt_state["sum"]):
            if wd:
                gs = torch._foreach_add(gs, ps, alpha=wd)
            torch._foreach_addcmul_(ss, gs, gs)
            den = torch._foreach_sqrt(ss)
            torch._foreach_add_(den, self.eps)
            torch._foreach_addcdiv_(ps, gs, den, value=-clr)
        return params, opt_state

    @torch.no_grad()
    def update_plain(self, grads, opt_state, params):
        """:meth:`update` as a loop of element-wise ops over the parameters,
        in the JAX package's order: the reference the multi-tensor update
        is held to."""
        wd = self.weight_decay
        clr = self._clr(opt_state)
        for name, p in params.items():
            g = grads[name]
            if wd:
                g = g + wd * p
            s = opt_state["sum"][name]
            s.copy_(s + g * g)
            p.copy_(p - clr * g / (torch.sqrt(s) + self.eps))
        return params, opt_state

    def __repr__(self):
        return (f"Adagrad(lr={self.lr}, lr_decay={self.lr_decay}, "
                f"weight_decay={self.weight_decay})")
