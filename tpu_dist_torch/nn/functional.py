"""Stateless NN ops — counterpart of ``tpu_dist/nn/functional.py`` (the part
the port's path uses)."""

from __future__ import annotations

import torch
import torch.nn.functional as _F

__all__ = ["linear", "cross_entropy"]


def linear(x, w, b=None):
    """``x @ w.T + b`` with ``w`` in torch's (out_features, in_features)
    layout (the JAX package keeps (in, out); ``interop`` transposes)."""
    return _F.linear(x, w, b)


def cross_entropy(logits, labels, reduction: str = "mean",
                  label_smoothing: float = 0.0, ignore_index: int = -100,
                  weight=None):
    """Softmax cross-entropy with integer labels, the JAX package's
    composition (torch ``CrossEntropyLoss`` semantics): ``label_smoothing``
    blends ``(1-eps)*nll + eps*mean_c(-logp_c)``; rows labelled
    ``ignore_index`` count nothing, in the loss or the mean's denominator;
    ``weight`` rescales classes and the mean divides by the counted rows'
    weights.  Computed in the logits dtype, as the JAX package does."""
    keep = labels != ignore_index
    safe = torch.where(keep, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    if weight is not None:
        weight = torch.as_tensor(weight, dtype=nll.dtype, device=nll.device)
        wy = weight[safe]
    else:
        wy = torch.ones_like(nll)
    loss = nll * wy
    if label_smoothing:
        # the target term scales by w[y]; the uniform term weights each
        # class's -logp by its own w_c
        wc = weight if weight is not None else 1.0
        smooth = -(logp * wc).sum(-1) / logits.shape[-1]
        loss = (1.0 - label_smoothing) * loss + label_smoothing * smooth
    wy = torch.where(keep, wy, torch.zeros_like(wy))
    loss = torch.where(keep, loss, torch.zeros_like(loss))
    if reduction == "mean":
        return loss.sum() / wy.sum().clamp_min(torch.finfo(loss.dtype).tiny)
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"Unknown reduction {reduction!r}")
