"""Exponential moving average of parameters — counterpart of
``tpu_dist/optim/ema.py`` (torch AveragedModel parity).

The same ``init``/``update`` contract as the optimizers: the shadow is a
dict of tensors beside the parameters, updated in place by a multi-tensor
``update`` each step (:meth:`EMA.update_plain` is the per-parameter loop it
is held to)::

    ema = optim.EMA(decay=0.999)
    ema_state = ema.init(params)
    ...after each step...
    ema_state = ema.update(ema_state, params)
    ...at eval time...
    eval_params = ema.params(ema_state)   # bias-corrected average

Bias correction (``debias=True``, default): a zero-initialized shadow,
corrected the way Adam corrects its moments (shadow / (1 - decay^t), in
float32); ``debias=False`` seeds the shadow with the parameters and counts
that as the first update (``step`` starts at 1), as AveragedModel does.
``step`` is a 0-d int32 tensor on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ._foreach import f32, grouped, new_step

__all__ = ["EMA"]


class EMA:
    def __init__(self, decay: float = 0.999, debias: bool = True):
        if not 0.0 < decay < 1.0:
            raise ValueError(f"decay must be in (0, 1), got {decay}")
        self.decay = decay
        self.debias = debias

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Build the shadow state: zeros and ``step`` 0 with ``debias``,
        else a copy of ``params`` and ``step`` 1."""
        if self.debias:
            return {"shadow": {k: torch.zeros_like(p)
                               for k, p in params.items()},
                    "step": new_step()}
        return {"shadow": {k: p.detach().clone() for k, p in params.items()},
                "step": new_step().add_(1)}

    @torch.no_grad()
    def update(self, ema_state, params):
        """Fold the current params into the shadow, in place; returns
        ``ema_state``."""
        d = self.decay
        for ps, ss in grouped(params, ema_state["shadow"]):
            torch._foreach_mul_(ss, d)
            torch._foreach_add_(ss, ps, alpha=1.0 - d)
        ema_state["step"].add_(1)
        return ema_state

    @torch.no_grad()
    def update_plain(self, ema_state, params):
        """:meth:`update` as a loop of element-wise ops over the parameters:
        the reference the multi-tensor update is held to."""
        d = self.decay
        for name, p in params.items():
            s = ema_state["shadow"][name]
            s.copy_(d * s + (1.0 - d) * p)
        ema_state["step"].add_(1)
        return ema_state

    @torch.no_grad()
    def params(self, ema_state) -> Dict[str, torch.Tensor]:
        """The averaged parameters (bias-corrected when ``debias``): new
        tensors with ``debias``, the shadow's own without."""
        if not self.debias:
            return ema_state["shadow"]
        t = np.float32(int(ema_state["step"]))
        c = np.float32(1.0) - np.float32(self.decay) ** t
        c = f32(max(c, np.finfo(np.float32).tiny))
        return {k: s / c for k, s in ema_state["shadow"].items()}
