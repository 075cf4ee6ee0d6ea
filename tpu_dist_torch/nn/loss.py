"""Loss modules — counterpart of ``tpu_dist/nn/loss.py``."""

from __future__ import annotations

import torch

from . import functional as F

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(torch.nn.Module):
    """Softmax cross-entropy over integer class labels.

    ``fused=True`` computes through the cross-entropy kernels
    (:func:`tpu_dist_torch.ops.fused_cross_entropy`): one pass over the
    logits forward and one backward, with no log-softmax tensor.  Rows
    labelled ``ignore_index`` are masked outside the kernel, which matches
    labels by column id."""

    def __init__(self, reduction: str = "mean", fused: bool = False,
                 label_smoothing: float = 0.0, ignore_index: int = -100,
                 weight=None):
        super().__init__()
        self.reduction = reduction
        self.fused = fused
        self.label_smoothing = label_smoothing
        self.ignore_index = ignore_index
        self.weight = weight
        if fused and (label_smoothing or weight is not None):
            raise ValueError(
                "the fused kernel computes plain softmax CE; use fused=False "
                "with label_smoothing/weight (ignore_index IS supported on "
                "the fused path)")

    def forward(self, logits, labels):
        if not self.fused:
            return F.cross_entropy(logits, labels, self.reduction,
                                   label_smoothing=self.label_smoothing,
                                   ignore_index=self.ignore_index,
                                   weight=self.weight)
        from ..ops import fused_cross_entropy
        keep = labels != self.ignore_index
        # the kernel matches labels by column id, so an out-of-range
        # sentinel (-100) must never reach it: mask outside
        safe = torch.where(keep, labels, torch.zeros_like(labels))
        nll = fused_cross_entropy(logits, safe, "none")
        nll = torch.where(keep, nll, torch.zeros_like(nll))
        if self.reduction == "mean":
            n = keep.sum().to(nll.dtype)
            return nll.sum() / n.clamp_min(torch.finfo(nll.dtype).tiny)
        if self.reduction == "sum":
            return nll.sum()
        if self.reduction == "none":
            return nll
        raise ValueError(f"Unknown reduction {self.reduction!r}")
