"""Parameterized layers — counterpart of ``tpu_dist/nn/layers.py`` (the
layers of the TransformerLM path and of the ConvNet and ResNet).

Layouts are torch's: a Linear weight is (out_features, in_features), where
the JAX package keeps (in, out); activations are NCHW and a convolution
weight is OIHW, where the JAX package keeps NHWC and HWIO.  Each layer
draws its parameters with the JAX package's distributions in
:meth:`reset_parameters`, from an explicit generator (``None`` = the global
one).  ``device`` follows the port's rule:
``cuda`` unless the caller names another device."""

from __future__ import annotations

import torch

from . import functional as F
from . import init as init_lib
from ..ops._build import resolve_device

__all__ = ["Linear", "Conv2d", "MaxPool2d", "AvgPool2d", "AdaptiveAvgPool2d",
           "ReLU", "Identity", "Flatten", "Dropout", "BatchNorm2d",
           "Embedding", "LayerNorm", "RMSNorm", "GELU", "unbiased_var"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Linear(torch.nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = torch.nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = (torch.nn.Parameter(torch.empty(out_features,
                                                    device=device))
                     if bias else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        init_lib.torch_default_uniform(self.weight, self.in_features, generator)
        if self.bias is not None:
            init_lib.torch_default_uniform(self.bias, self.in_features,
                                           generator)

    # set by nn.tensor_parallel.split_model_axis: column- or row-parallel
    tp = None

    def forward(self, x):
        if self.tp is None:
            return F.linear(x, self.weight, self.bias)
        from .tensor_parallel import SumGradOverLine, SumOverLine
        line = self.tp.line
        if self.tp.kind() == "column":
            return F.linear(SumGradOverLine.apply(x, line), self.weight,
                            self.bias)
        # row-parallel: partial products summed, the bias added once after
        y = SumOverLine.apply(F.linear(x, self.weight), line)
        return y if self.bias is None else y + self.bias

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


class Conv2d(torch.nn.Module):
    """2-D convolution over NCHW with an OIHW weight, torch's default
    initialization U(±1/sqrt(fan_in)) for the weight and the bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 bias: bool = True, device=None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.weight = torch.nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *self.kernel_size,
            device=device))
        self.bias = (torch.nn.Parameter(torch.empty(out_channels,
                                                    device=device))
                     if bias else None)
        self.reset_parameters()

    @property
    def fan_in(self) -> int:
        kh, kw = self.kernel_size
        return kh * kw * (self.in_channels // self.groups)

    def reset_parameters(self, generator=None):
        init_lib.torch_default_uniform(self.weight, self.fan_in, generator)
        if self.bias is not None:
            init_lib.torch_default_uniform(self.bias, self.fan_in, generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class MaxPool2d(torch.nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding)

    def extra_repr(self):
        return f"kernel={self.kernel_size}, stride={self.stride}"


class AvgPool2d(torch.nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding)


class AdaptiveAvgPool2d(torch.nn.Module):
    """Average-pool NCHW to a fixed (h, w); output cell ``i`` averages input
    rows ``[floor(i*H/out), ceil((i+1)*H/out))``, the JAX package's bin rule
    (and torch's), for sizes that do not divide too."""

    def __init__(self, output_size=1):
        super().__init__()
        self.output_size = _pair(output_size)

    def forward(self, x):
        return torch.nn.functional.adaptive_avg_pool2d(x, self.output_size)


class ReLU(torch.nn.Module):
    def forward(self, x):
        return F.relu(x)


class Identity(torch.nn.Module):
    def forward(self, x):
        return x


class Flatten(torch.nn.Module):
    def __init__(self, start_dim: int = 1):
        super().__init__()
        self.start_dim = start_dim

    def forward(self, x):
        return F.flatten(x, self.start_dim)


class Dropout(torch.nn.Module):
    """Inverted dropout, active in training mode only.  Its mask is the JAX
    package's for the same key (:func:`functional.dropout`); the key is the
    next one of the current :func:`~tpu_dist_torch.nn.module.rng_scope`,
    which the DDP train step opens with the JAX package's per-step,
    per-rank key."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        from .module import next_rng
        return F.dropout(x, self.p, next_rng(), training=True)

    def extra_repr(self):
        return f"p={self.p}"


def unbiased_var(var, n: int):
    """The batch variance ``var`` of ``n`` values made unbiased (Bessel's
    ``n / (n - 1)``), as the running variance is kept."""
    return var * (n / max(n - 1, 1))


class BatchNorm2d(torch.nn.Module):
    """Batch normalization over NCHW (or (N, C)) with the JAX package's
    maths, which are torch's semantics:

    - training: normalize with the batch's biased statistics, the mean
      and ``E[x²] − E[x]²``, each reduced in the input's dtype (bf16
      under bf16 compute, as the JAX package does); update the running
      statistics in place with the unbiased variance,
      ``running = (1 − momentum)·running + momentum·batch``;
    - eval: normalize with the running statistics, which it leaves alone.

    The running statistics are float32 buffers (``running_mean``,
    ``running_var``; the JAX package's state ``{"mean", "var"}``).  With
    ``process_group`` set to a group of more than one rank (what
    ``parallel.convert_sync_batchnorm`` does) the batch mean and mean of
    squares are averaged over the group, differentiably, and ``n`` counts
    every rank's values (SyncBatchNorm); by default the statistics are this
    rank's own, as under torch DDP."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.process_group = None
        if affine:
            self.weight = torch.nn.Parameter(torch.empty(num_features,
                                                         device=device))
            self.bias = torch.nn.Parameter(torch.empty(num_features,
                                                       device=device))
        else:
            self.weight = self.bias = None
        if track_running_stats:
            self.register_buffer("running_mean", torch.zeros(
                num_features, device=device))
            self.register_buffer("running_var", torch.ones(
                num_features, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            if self.affine:
                self.weight.fill_(1.0)
                self.bias.zero_()
            if self.track_running_stats:
                self.running_mean.zero_()
                self.running_var.fill_(1.0)

    def forward(self, x):
        if not self.training and self.track_running_stats:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, self.eps)
        dims = (0,) + tuple(range(2, x.dim()))
        mean = x.mean(dims)
        mean2 = (x * x).mean(dims)
        group = self.process_group
        world = group.size() if group is not None else 1
        if world > 1:
            mean = F.all_reduce_mean(mean, world, group.torch_group)
            mean2 = F.all_reduce_mean(mean2, world, group.torch_group)
        var = mean2 - mean * mean
        if self.track_running_stats:
            n = x.numel() // x.shape[1] * world
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean.detach())
                self.running_var.copy_(
                    (1 - m) * self.running_var
                    + m * unbiased_var(var.detach(), n))
        return F.batch_norm(x, mean, var, self.weight, self.bias, self.eps)

    def extra_repr(self):
        return f"{self.num_features}, eps={self.eps}, momentum={self.momentum}"


class Embedding(torch.nn.Module):
    """Token embedding lookup, N(0, 1) init.  Unlike the JAX package, which
    clamps an out-of-range id to the last row, torch's lookup raises (on the
    card, a device-side assert)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, device=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = torch.nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=resolve_device(device)))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        init_lib.normal(self.weight, 1.0, generator)

    # set by nn.tensor_parallel.split_model_axis: this rank's rows
    tp = None

    def forward(self, idx):
        if self.tp is None:
            return torch.nn.functional.embedding(idx, self.weight)
        # vocab-parallel: this rank's rows, the others masked to zero, the
        # lookups summed over the line (the JAX host engine's tok_shard)
        from .tensor_parallel import SumOverLine
        rows = self.weight.shape[0]
        rel = idx - self.tp.line.index * rows
        ok = (rel >= 0) & (rel < rows)
        e = torch.nn.functional.embedding(rel.clamp(0, rows - 1),
                                          self.weight)
        e = torch.where(ok[..., None], e, e.new_zeros(()))
        return SumOverLine.apply(e, self.tp.line)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class LayerNorm(torch.nn.Module):
    """Layer normalization over the trailing dimension(s), the JAX package's
    formula: mean, biased variance, ``(x - mean) * rsqrt(var + eps)``, then
    the affine ``* weight + bias``.

    The port computes it with ``F.layer_norm``, whose statistics are float32
    inside one fused kernel and whose output is in the input's dtype.  The
    JAX package runs the same formula op by op in the input's dtype (bf16
    under bf16 compute).  In float32 the two agree to rounding (the parity
    tests); under bf16 the fused call is the more accurate of the two.
    Run op by op, the formula costs ≈ 9 elementwise and reduction kernels
    per LayerNorm forward, and more backward, on the card (PERF.md)."""

    def __init__(self, normalized_shape, eps: float = 1e-5,
                 elementwise_affine: bool = True, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            device = resolve_device(device)
            self.weight = torch.nn.Parameter(
                torch.empty(self.normalized_shape, device=device))
            self.bias = torch.nn.Parameter(
                torch.empty(self.normalized_shape, device=device))
            self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        weight = self.weight if self.elementwise_affine else None
        bias = self.bias if self.elementwise_affine else None
        return torch.nn.functional.layer_norm(x, self.normalized_shape,
                                              weight, bias, self.eps)

    def extra_repr(self):
        return f"{self.normalized_shape}"


class RMSNorm(torch.nn.Module):
    """Root-mean-square normalization over the trailing dimension(s), the
    JAX package's formula: statistics in float32, ``x * rsqrt(mean(x²) +
    eps)``, cast back to ``x.dtype``, then ``* weight`` in that dtype.  No
    mean subtraction and no bias (the LLaMA-family norm).  The normalization
    is ``F.rms_norm`` without a weight, which computes exactly that in
    float32 and returns ``x.dtype`` (as the port's LayerNorm is
    ``F.layer_norm``); the JAX package has no kernel here either."""

    def __init__(self, normalized_shape, eps: float = 1e-6,
                 elementwise_affine: bool = True, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            self.weight = torch.nn.Parameter(torch.empty(
                self.normalized_shape, device=resolve_device(device)))
            self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x):
        y = torch.nn.functional.rms_norm(x, self.normalized_shape, None,
                                         self.eps)
        if self.elementwise_affine:
            y = y * self.weight.to(x.dtype)
        return y

    def extra_repr(self):
        return f"{self.normalized_shape}, eps={self.eps}"


class GELU(torch.nn.Module):
    """Gaussian error linear unit, exact erf form (``approximate=False``)."""

    def forward(self, x):
        return torch.nn.functional.gelu(x, approximate="none")
