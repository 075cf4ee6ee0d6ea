"""Stateless NN ops — counterpart of ``tpu_dist/nn/functional.py`` (the part
the port's paths use).

Layouts are torch's: activations NCHW, convolution weights OIHW, Linear
weights (out, in); the JAX package keeps NHWC, HWIO and (in, out), and
``interop`` converts.  Convolutions and pooling go to cuDNN (or the CPU's
kernels) through ``torch.nn.functional``, as the JAX package leaves them to
XLA."""

from __future__ import annotations

import torch
import torch.nn.functional as _F

__all__ = ["linear", "cross_entropy", "conv2d", "max_pool2d", "avg_pool2d",
           "relu", "dropout", "flatten", "batch_norm", "all_reduce_mean"]


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


def conv2d(x, w, b=None, stride=1, padding=0, dilation=1, groups: int = 1):
    """2-D convolution, NCHW input, OIHW weight; symmetric integer padding
    (torch semantics) or ``"same"``/``"valid"``."""
    if isinstance(padding, str):
        padding = padding.lower()
    return _F.conv2d(x, w, b, stride, padding, dilation, groups)


def max_pool2d(x, kernel_size, stride=None, padding=0):
    """Max pooling over NCHW, floor mode; padded cells never win (the JAX
    package pads with -inf)."""
    return _F.max_pool2d(x, kernel_size, stride if stride is not None
                         else kernel_size, padding)


def avg_pool2d(x, kernel_size, stride=None, padding=0,
               count_include_pad: bool = True):
    """Average pooling over NCHW, floor mode; with ``count_include_pad``
    (torch's default) padded zeros count in the denominator."""
    return _F.avg_pool2d(x, kernel_size, stride if stride is not None
                         else kernel_size, padding,
                         count_include_pad=count_include_pad)


def relu(x):
    return torch.relu(x)


def dropout(x, rate: float, key, training: bool = True):
    """Inverted dropout with the JAX package's mask: ``keep =
    bernoulli(key, 1 - rate)``, which is ``uniform(key, x.shape) < 1 -
    rate`` on JAX's threefry stream (:mod:`tpu_dist_torch.random`), so the
    same key drops the same elements in both packages.  Identity at eval."""
    if not training or rate == 0.0:
        return x
    from .. import random
    keep = 1.0 - rate
    mask = random.uniform(key.to(x.device), x.shape) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def flatten(x, start_dim: int = 1):
    return x.flatten(start_dim)


def batch_norm(x, mean, var, weight=None, bias=None, eps: float = 1e-5):
    """Normalize NCHW (or (N, C)) activations with the given per-channel
    statistics: ``(x - mean) * rsqrt(var + eps) * weight + bias``, the JAX
    package's formula, with the per-channel factor ``rsqrt(var + eps) *
    weight`` formed first and the affine in one ``addcmul`` (two passes
    over ``x``, not four).  Plain differentiable operations, so gradients
    flow into ``mean`` and ``var`` when they are batch statistics
    (``F.batch_norm`` does not differentiate given statistics)."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    scale = torch.rsqrt(var + eps)
    if weight is not None:
        scale = scale * weight
    centered = x - mean.reshape(shape)
    if bias is None:
        return centered * scale.reshape(shape)
    return torch.addcmul(bias.reshape(shape), centered, scale.reshape(shape))


class _AllReduceMean(torch.autograd.Function):
    """The mean over the ranks, differentiable: the cotangent is averaged
    over the ranks too, so each rank's input receives every rank's share of
    the gradient (what JAX's ``pmean`` transposes to)."""

    @staticmethod
    def forward(ctx, x, world: int, group):
        ctx.world, ctx.group = world, group
        y = x.clone()
        torch.distributed.all_reduce(y, group=group)
        return y.div_(world)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        torch.distributed.all_reduce(g, group=ctx.group)
        return g.div_(ctx.world), None, None


def all_reduce_mean(x, world: int, group=None):
    """``x`` averaged over the ``world`` ranks of the ``torch.distributed``
    group ``group`` (``None``: the default group), with the averaged
    cotangent backward."""
    return _AllReduceMean.apply(x, world, group)
