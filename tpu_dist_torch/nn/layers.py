"""Parameterized layers — counterpart of ``tpu_dist/nn/layers.py`` (the
layers of the TransformerLM path).

Layouts are torch's: a Linear weight is (out_features, in_features), where
the JAX package keeps (in, out).  Each layer draws its parameters with the
JAX package's distributions in :meth:`reset_parameters`, from an explicit
generator (``None`` = the global one).  ``device`` follows the port's rule:
``cuda`` unless the caller names another device."""

from __future__ import annotations

import torch

from . import functional as F
from . import init as init_lib
from ..ops._build import resolve_device

__all__ = ["Linear", "Embedding", "LayerNorm", "GELU"]


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

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


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

    def forward(self, idx):
        return torch.nn.functional.embedding(idx, self.weight)

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


class GELU(torch.nn.Module):
    """Gaussian error linear unit, exact erf form (``approximate=False``)."""

    def forward(self, x):
        return torch.nn.functional.gelu(x, approximate="none")
