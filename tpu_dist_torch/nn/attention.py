"""Attention — counterpart of ``tpu_dist/nn/attention.py`` (training path).

:func:`scaled_dot_product_attention` dispatches between the dense
composition and the flash kernel; :class:`MultiheadSelfAttention` is the
fused-QKV layer without a KV cache, sequence axis or rotary embeddings
(those come with later slices)."""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from . import functional as F
from . import init as init_lib
from ..ops._build import resolve_device

__all__ = ["scaled_dot_product_attention", "MultiheadSelfAttention",
           "attention_impl"]

_IMPL_OVERRIDE: list = []

# Auto-dispatch crossover.  This is the JAX package's rule, tuned there on a
# TPU; it has not been measured on the card yet.
_FLASH_MIN_SEQ = 1024


@contextlib.contextmanager
def attention_impl(impl: str):
    """Scoped default for :func:`scaled_dot_product_attention`'s ``impl``:
    overrides the auto choice for every call inside the block (an explicit
    per-call ``impl=`` still wins)."""
    _IMPL_OVERRIDE.append(impl)
    try:
        yield
    finally:
        _IMPL_OVERRIDE.pop()


def scaled_dot_product_attention(q, k, v, causal: bool = False,
                                 mask: Optional[torch.Tensor] = None,
                                 impl: Optional[str] = None):
    """Attention.  ``q, k, v``: (..., T, H, D) → (..., T, H, D).

    ``mask``: broadcastable to (..., H, Tq, Tk), True = keep.  ``impl``:
    ``"dense"`` materializes the scores (any mask); ``"flash"`` runs the
    O(T)-memory kernel (:func:`tpu_dist_torch.ops.flash_attention`; causal
    or no mask).  Default (``None``/``"auto"``): flash for a CUDA tensor with
    no mask, a sequence of at least ``_FLASH_MIN_SEQ`` and equal batch dims
    for q, k, v; dense otherwise."""
    if impl in (None, "auto"):
        if _IMPL_OVERRIDE:
            impl = _IMPL_OVERRIDE[-1]
        else:
            flash_ok = (mask is None and q.device.type == "cuda"
                        and max(q.shape[-3], k.shape[-3]) >= _FLASH_MIN_SEQ
                        and q.shape[:-3] == k.shape[:-3] == v.shape[:-3]
                        and k.shape == v.shape)
            impl = "flash" if flash_ok else "dense"
    if impl == "flash":
        if mask is not None:
            raise ValueError("impl='flash' supports causal masking only; "
                             "pass impl='dense' for arbitrary masks")
        from ..ops.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal)
    if impl != "dense":
        raise ValueError(f"Unknown attention impl {impl!r}")
    d = q.shape[-1]
    scores = torch.einsum("...qhd,...khd->...hqk", q, k) / math.sqrt(d)
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        keep = (torch.arange(tk, device=q.device)[None, :]
                <= torch.arange(tq, device=q.device)[:, None])
        scores = scores.masked_fill(~keep, float("-inf"))
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("...hqk,...khd->...qhd", w, v)


class MultiheadSelfAttention(torch.nn.Module):
    """Multi-head self-attention with a fused QKV projection.

    Parameters keep the JAX package's names (``qkv_weight``, ``qkv_bias``,
    ``out_weight``, ``out_bias``) in torch's (out, in) layout.  The fused
    projection splits in the JAX order, ``reshape(b, t, 3, H, hd)``; q, k
    and v reach the flash kernel as strided views, with no copy."""

    def __init__(self, embed_dim: int, num_heads: int, bias: bool = True,
                 causal: bool = False, attn_impl: Optional[str] = None,
                 device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by "
                             f"num_heads {num_heads}")
        device = resolve_device(device)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.causal = causal
        self.attn_impl = attn_impl  # None = auto | "dense" | "flash"
        self.qkv_weight = torch.nn.Parameter(
            torch.empty(3 * embed_dim, embed_dim, device=device))
        self.out_weight = torch.nn.Parameter(
            torch.empty(embed_dim, embed_dim, device=device))
        if bias:
            self.qkv_bias = torch.nn.Parameter(
                torch.empty(3 * embed_dim, device=device))
            self.out_bias = torch.nn.Parameter(
                torch.empty(embed_dim, device=device))
        else:
            self.qkv_bias = self.out_bias = None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        init_lib.torch_default_uniform(self.qkv_weight, self.embed_dim,
                                       generator)
        init_lib.torch_default_uniform(self.out_weight, self.embed_dim,
                                       generator)
        if self.qkv_bias is not None:
            with torch.no_grad():
                self.qkv_bias.zero_()
                self.out_bias.zero_()

    def forward(self, x):
        b, t, _ = x.shape
        qkv = F.linear(x, self.qkv_weight, self.qkv_bias)
        qkv = qkv.reshape(b, t, 3, self.num_heads, self.head_dim)
        # unbind, not three selects: its backward stacks dq, dk, dv into
        # one buffer instead of zero-filling and adding three
        q, k, v = qkv.unbind(2)
        out = scaled_dot_product_attention(q, k, v, causal=self.causal,
                                           impl=self.attn_impl)
        return F.linear(out.reshape(b, t, self.embed_dim), self.out_weight,
                        self.out_bias)

    def extra_repr(self):
        return (f"{self.embed_dim}, heads={self.num_heads}, "
                f"causal={self.causal}")
