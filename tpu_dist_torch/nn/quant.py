"""Weight-only int8 quantization for inference — counterpart of
``tpu_dist/nn/quant.py``.

:class:`QuantLinear` keeps an int8 weight with a float32 per-output-channel
symmetric scale (``w ≈ q * scale``); activations, bias and the product stay
in the activation dtype.  The scale commutes with the contraction, so it
multiplies the product's (small) output instead of the weight, as in the
JAX package.  ``F.linear(x, q.to(x.dtype))`` is the plain form: the JAX
package has no kernel here either.

:func:`quantize_linear_weights` converts a built model in place (every
``nn.Linear`` becomes a :class:`QuantLinear`; with ``attention=True`` every
``nn.MultiheadSelfAttention`` a :class:`QuantMultiheadSelfAttention`, with
``embedding=True`` every ``nn.Embedding`` a :class:`QuantEmbedding`).  The
quantized modules hold their leaves as parameters that need no gradient, in
torch's (out, in) layout, so ``interop.load_jax_params`` loads the JAX
package's quantized trees into them.  Training them is out of scope.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import functional as F
from .attention import MultiheadSelfAttention
from .layers import Embedding, Linear
from ..ops._build import resolve_device

__all__ = ["QuantEmbedding", "QuantLinear", "QuantMultiheadSelfAttention",
           "quantize_linear_weights"]


def _frozen(t: torch.Tensor) -> torch.nn.Parameter:
    return torch.nn.Parameter(t, requires_grad=False)


def _quantized_linear(x, q, scale, bias):
    """``x @ (q * scale).T + bias`` with the scale hoisted to the output."""
    y = F.linear(x, q.to(x.dtype)) * scale.to(x.dtype)
    return y if bias is None else y + bias.to(x.dtype)


class QuantLinear(torch.nn.Module):
    """Inference-only Linear with an int8 weight and per-out-channel scale.

    Parameters: ``q_weight`` (out, in) int8, ``scale`` (out,) float32,
    optional ``bias``.  Built by :func:`quantize_linear_weights`; a fresh
    one holds identity scales and zeros."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, device=None):
        super().__init__()
        device = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.q_weight = _frozen(torch.zeros(out_features, in_features,
                                            dtype=torch.int8, device=device))
        self.scale = _frozen(torch.ones(out_features, device=device))
        self.bias = (_frozen(torch.zeros(out_features, device=device))
                     if bias else None)

    def reset_parameters(self, generator=None):
        """Identity scales and zeros: there is nothing to draw."""
        with torch.no_grad():
            self.q_weight.zero_()
            self.scale.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        return _quantized_linear(x, self.q_weight, self.scale, self.bias)

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}, int8"


class QuantMultiheadSelfAttention(MultiheadSelfAttention):
    """Inference-only MHSA with int8 qkv/out projection weights: the same
    forward (and KV cache) as the float layer, only the projections
    differ.  Parameters: ``qkv_q`` (3d, d) / ``qkv_scale``, ``out_q``
    (d, d) / ``out_scale``, plus the biases."""

    def _init_projections(self, bias: bool, device) -> None:
        d = self.embed_dim
        self.qkv_q = _frozen(torch.zeros(3 * d, d, dtype=torch.int8,
                                         device=device))
        self.qkv_scale = _frozen(torch.ones(3 * d, device=device))
        self.out_q = _frozen(torch.zeros(d, d, dtype=torch.int8,
                                         device=device))
        self.out_scale = _frozen(torch.ones(d, device=device))
        if bias:
            self.qkv_bias = _frozen(torch.zeros(3 * d, device=device))
            self.out_bias = _frozen(torch.zeros(d, device=device))
        else:
            self.qkv_bias = self.out_bias = None

    def reset_parameters(self, generator=None):
        """Identity scales and zeros: there is nothing to draw."""
        with torch.no_grad():
            for p in (self.qkv_q, self.out_q, self.qkv_bias, self.out_bias):
                if p is not None:
                    p.zero_()
            self.qkv_scale.fill_(1.0)
            self.out_scale.fill_(1.0)

    def _qkv_proj(self, x):
        return _quantized_linear(x, self.qkv_q, self.qkv_scale,
                                 self.qkv_bias)

    def _out_proj(self, out):
        return _quantized_linear(out, self.out_q, self.out_scale,
                                 self.out_bias)

    def extra_repr(self):
        return f"{super().extra_repr()}, int8"


class QuantEmbedding(torch.nn.Module):
    """Inference-only embedding with int8 rows and a per-row scale:
    ``q_weight`` (V, d) int8, ``scale`` (V,) float32.  Decode gathers one
    row a token, so this buys model size, not decode bandwidth."""

    def __init__(self, num_embeddings: int, embedding_dim: int, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.q_weight = _frozen(torch.zeros(num_embeddings, embedding_dim,
                                            dtype=torch.int8, device=device))
        self.scale = _frozen(torch.ones(num_embeddings, device=device))

    def reset_parameters(self, generator=None):
        """Identity scales and zeros: there is nothing to draw."""
        with torch.no_grad():
            self.q_weight.zero_()
            self.scale.fill_(1.0)

    def forward(self, idx):
        # output dtype follows the scale leaf, as in the JAX package
        return (self.q_weight[idx].to(self.scale.dtype)
                * self.scale[idx][..., None])

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}, int8"


@torch.no_grad()
def _quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a (out, in) weight:
    ``w ≈ q * scale[:, None]``, the amax taken per row and the quotient
    rounded half to even, as the JAX package's numpy converter does."""
    w = w.float()
    amax = w.abs().amax(1)
    # a 0-d tensor divisor: CUDA divides by a host scalar as a multiply by
    # its reciprocal, which can round otherwise
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def _quantized(mod: torch.nn.Module, attention: bool, embedding: bool):
    """The quantized replacement of ``mod``, or None to leave it as it is."""
    if isinstance(mod, Linear):
        q_mod = QuantLinear(mod.in_features, mod.out_features,
                            bias=mod.bias is not None,
                            device=mod.weight.device)
        q_mod.q_weight[:], q_mod.scale[:] = _quantize_weight(mod.weight)
        if mod.bias is not None:
            q_mod.bias.copy_(mod.bias)
        return q_mod
    if (attention and isinstance(mod, MultiheadSelfAttention)
            and not isinstance(mod, QuantMultiheadSelfAttention)):
        q_mod = QuantMultiheadSelfAttention(
            mod.embed_dim, mod.num_heads, bias=mod.qkv_bias is not None,
            causal=mod.causal, attn_impl=mod.attn_impl,
            device=mod.qkv_weight.device, sequence_axis=mod.sequence_axis,
            mode=mod.mode, rope=mod.rope, rope_theta=mod.rope_theta)
        q_mod.qkv_q[:], q_mod.qkv_scale[:] = _quantize_weight(mod.qkv_weight)
        q_mod.out_q[:], q_mod.out_scale[:] = _quantize_weight(mod.out_weight)
        if mod.qkv_bias is not None:
            q_mod.qkv_bias.copy_(mod.qkv_bias)
            q_mod.out_bias.copy_(mod.out_bias)
        return q_mod
    if embedding and isinstance(mod, Embedding):
        q_mod = QuantEmbedding(mod.num_embeddings, mod.embedding_dim,
                               device=mod.weight.device)
        # rows are the output channels: the (out, in) rule applies as is
        q_mod.q_weight[:], q_mod.scale[:] = _quantize_weight(mod.weight)
        return q_mod
    return None


@torch.no_grad()
def quantize_linear_weights(model: torch.nn.Module,
                            skip: Optional[Sequence[str]] = None,
                            attention: bool = False,
                            embedding: bool = False) -> torch.nn.Module:
    """Swap every ``nn.Linear`` in ``model`` for a :class:`QuantLinear` with
    its weight quantized; with ``attention=True`` also every
    ``nn.MultiheadSelfAttention`` for a
    :class:`QuantMultiheadSelfAttention`, and with ``embedding=True`` every
    ``nn.Embedding`` for a :class:`QuantEmbedding`.  Mutates ``model`` in
    place and returns it.  ``skip``: module paths to leave in full
    precision.  A module registered under several names (tied weights)
    becomes one quantized module under all of them."""
    skip = set(skip or ())
    q_for = {}
    for path, mod in list(model.named_modules()):
        if path and path not in skip:
            q_mod = _quantized(mod, attention, embedding)
            if q_mod is not None:
                q_for[id(mod)] = q_mod
    for parent in list(model.modules()):
        for name, child in list(parent._modules.items()):
            if id(child) in q_for:
                setattr(parent, name, q_for[id(child)])
    return model
