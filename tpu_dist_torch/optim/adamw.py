"""AdamW (+ plain Adam) — counterpart of ``tpu_dist/optim/adamw.py``
(torch.optim.AdamW semantics).

The contract of :class:`~tpu_dist_torch.optim.SGD`: ``init`` builds the
state, ``update(grads, opt_state, params)`` runs in place as a few
multi-tensor ``torch._foreach_*`` calls and returns the same dicts;
:meth:`AdamW.update_plain` is the per-parameter loop it is held to.

Update rule (torch semantics), in the JAX package's order of operations,
which decides the rounding (torch.optim's own formula rounds otherwise):

    m   = b1*m + (1-b1)*g;     v = b2*v + (1-b2)*g^2
    upd = (m / c1) / (sqrt(v / c2) + eps),   c1 = 1 - b1^t,  c2 = 1 - b2^t
    p  -= lr * weight_decay * p                 (decoupled, AdamW)
    p  -= lr * upd

The bias corrections are computed in float32 from ``t``, as the JAX package
computes them on the device; ``opt_state["step"]`` is a 0-d int32 tensor on
the CPU, so no update reads it back from the card.  ``decoupled=False``
gives classic Adam (L2 folded into the gradient before the moments).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ._foreach import f32, grouped, lr_at, new_step, tick

__all__ = ["AdamW", "Adam"]


class AdamW:
    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, decoupled: bool = True):
        """``lr`` may be a float or a schedule (:mod:`.lr_scheduler`) of the
        update count, evaluated on the host."""
        if not 0.0 <= betas[0] < 1.0 or not 0.0 <= betas[1] < 1.0:
            raise ValueError(f"Invalid betas {betas}")
        if eps <= 0.0:
            raise ValueError(f"Invalid eps {eps}")
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.decoupled = decoupled

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
                "v": {k: torch.zeros_like(p) for k, p in params.items()},
                "step": new_step()}

    def _scalars(self, opt_state):
        """This update's lr, the decay's coefficient and the float32 bias
        corrections; advances the count."""
        b1, b2 = self.betas
        t0 = tick(opt_state)
        t = np.float32(t0 + 1)
        c1 = f32(np.float32(1.0) - np.float32(b1) ** t)
        c2 = f32(np.float32(1.0) - np.float32(b2) ** t)
        # a schedule of the pre-update count: the first update uses lr(0)
        lr = lr_at(self.lr, t0)
        wd = self.weight_decay
        lr_wd = f32(np.float32(lr) * np.float32(wd)) if callable(self.lr) \
            else lr * wd
        return lr, lr_wd, c1, c2

    @torch.no_grad()
    def update(self, grads, opt_state, params):
        """Apply one step in place; returns ``(params, opt_state)``."""
        b1, b2 = self.betas
        wd = self.weight_decay
        lr, lr_wd, c1, c2 = self._scalars(opt_state)
        for ps, gs, ms, vs in grouped(params, grads, opt_state["m"],
                                      opt_state["v"]):
            if wd and not self.decoupled:
                gs = torch._foreach_add(gs, ps, alpha=wd)
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, gs, alpha=1.0 - b1)
            torch._foreach_mul_(vs, b2)
            torch._foreach_addcmul_(vs, gs, gs, value=1.0 - b2)
            den = torch._foreach_div(vs, c2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_div(ms, c1)
            torch._foreach_div_(upd, den)
            del den
            if wd and self.decoupled:
                torch._foreach_add_(ps, ps, alpha=-lr_wd)
            torch._foreach_add_(ps, upd, alpha=-lr)
        return params, opt_state

    @torch.no_grad()
    def update_plain(self, grads, opt_state, params):
        """:meth:`update` as a loop of element-wise ops over the parameters,
        in the JAX package's order: the reference the multi-tensor update
        is held to."""
        b1, b2 = self.betas
        wd = self.weight_decay
        lr, lr_wd, c1, c2 = self._scalars(opt_state)
        for name, p in params.items():
            g = grads[name]
            m, v = opt_state["m"][name], opt_state["v"][name]
            if wd and not self.decoupled:
                g = g + wd * p
            m.copy_(b1 * m + (1.0 - b1) * g)
            v.copy_(b2 * v + (1.0 - b2) * g * g)
            upd = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if wd and self.decoupled:
                p.copy_(p - lr_wd * p)
            p.copy_(p - lr * upd)
        return params, opt_state

    def __repr__(self):
        return (f"AdamW(lr={self.lr}, betas={self.betas}, eps={self.eps}, "
                f"weight_decay={self.weight_decay}, "
                f"decoupled={self.decoupled})")


def Adam(lr=1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
         weight_decay: float = 0.0) -> AdamW:
    """torch.optim.Adam semantics: L2 weight decay folded into gradients."""
    return AdamW(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                 decoupled=False)
