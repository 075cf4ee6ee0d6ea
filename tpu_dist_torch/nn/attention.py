"""Attention — counterpart of ``tpu_dist/nn/attention.py``.

:func:`scaled_dot_product_attention` dispatches between the dense
composition and the flash kernel; :class:`MultiheadSelfAttention` is the
fused-QKV layer, with the JAX package's KV cache for decoding (float32,
bfloat16 or int8 with per-(token, head) scales) and sequence parallelism
over a mesh axis (``sequence_axis``: ring attention or Ulysses).  Rotary
embeddings come with a later slice (ROADMAP A7)."""

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
    and v reach the flash kernel as strided views, with no copy.

    ``forward(x, cache=...)`` decodes through a KV cache from
    :meth:`init_cache` (see :meth:`_decode`).

    ``sequence_axis``: a mesh axis of the default process group (e.g.
    ``"seq"``) over which ``x`` is this rank's sequence shard; attention
    then spans the gathered sequence, by ``mode="ring"``
    (:func:`~tpu_dist_torch.parallel.ring_self_attention`) or
    ``"ulysses"`` (:func:`~tpu_dist_torch.parallel.ulysses_self_attention`),
    and equals the dense computation.  A KV-cache decode runs on gathered
    sequences and refuses it."""

    def __init__(self, embed_dim: int, num_heads: int, bias: bool = True,
                 causal: bool = False, attn_impl: Optional[str] = None,
                 device=None, sequence_axis: Optional[str] = None,
                 mode: str = "ring", rope: bool = False):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by "
                             f"num_heads {num_heads}")
        if mode not in ("ring", "ulysses"):
            raise ValueError(f"Unknown sequence-parallel mode {mode!r}")
        if rope:
            raise NotImplementedError(
                "rope=True: rotary embeddings come with a later slice of "
                "the port (ROADMAP A7)")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.causal = causal
        self.sequence_axis = sequence_axis
        self.mode = mode
        self.attn_impl = attn_impl  # None = auto | "dense" | "flash"
        self._init_projections(bias, resolve_device(device))

    def _init_projections(self, bias: bool, device) -> None:
        """The projection parameters; the int8 inference subclass
        (``nn.quant.QuantMultiheadSelfAttention``) overrides it."""
        embed_dim = self.embed_dim
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

    def _qkv_proj(self, x):
        return F.linear(x, self.qkv_weight, self.qkv_bias)

    def _out_proj(self, out):
        return F.linear(out, self.out_weight, self.out_bias)

    def forward(self, x, cache: Optional[dict] = None):
        """``cache``: this layer's entry of a KV cache (autoregressive
        decode), written in place; None for the uncached forward."""
        b, t, _ = x.shape
        qkv = self._qkv_proj(x)
        qkv = qkv.reshape(b, t, 3, self.num_heads, self.head_dim)
        # unbind, not three selects: its backward stacks dq, dk, dv into
        # one buffer instead of zero-filling and adding three
        q, k, v = qkv.unbind(2)
        if cache is not None:
            if self.sequence_axis is not None:
                raise ValueError("KV-cache decode runs on gathered "
                                 "sequences; build the layer without "
                                 "sequence_axis for decoding")
            out = self._decode(cache, q, k, v)
        elif self.sequence_axis is not None:
            from ..parallel.ring_attention import (ring_self_attention,
                                                   ulysses_self_attention)
            fn = (ring_self_attention if self.mode == "ring"
                  else ulysses_self_attention)
            out = fn(q, k, v, axis_name=self.sequence_axis,
                     causal=self.causal, impl=self.attn_impl)
        else:
            out = scaled_dot_product_attention(q, k, v, causal=self.causal,
                                               impl=self.attn_impl)
        return self._out_proj(out.reshape(b, t, self.embed_dim))

    @staticmethod
    def _quantize_kv(x):
        """Symmetric per-(token, head) int8: x (B, t, H, D) -> (q int8,
        scale (B, t, H) float32).  amax over the head dim only, so one
        outlier token/head cannot flatten every other's resolution."""
        xf = x.float()
        amax = xf.abs().amax(-1)
        # a 0-d tensor divisor, not a Python number: CUDA divides by a host
        # scalar as a multiply by its reciprocal, which can round otherwise
        scale = torch.where(amax > 0, amax / amax.new_tensor(127.0),
                            torch.ones_like(amax))
        q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
        return q.to(torch.int8), scale

    def _decode(self, cache: dict, q, k, v):
        """Cached attention step.  q/k/v: (B, t, H, D), t the number of new
        positions (t > 1 prefill, t = 1 one decode step).  ``cache`` holds
        ``k``/``v`` (B, Tmax, H, D) (int8: plus ``k_scale``/``v_scale``
        (B, Tmax, H)) and ``index``: an int, where every row writes, or a
        (B,) tensor, each row's own position (the slot pool of continuous
        batching).  The new keys land at [index, index + t), in place, and
        ``index`` advances by t; queries see the cache positions up to their
        own, so the zeros past the index never contribute.

        With an int8 cache the scales are hoisted out of both products, as
        in the JAX package: scores are multiplied by ``sm * k_scale`` and
        probabilities by ``v_scale`` (cast to q's dtype) before the PV
        product, in that order, so float32 results agree with it to
        rounding.  Indices must lie inside the cache: torch raises on an
        out-of-range write where JAX drops it (callers check first)."""
        index = cache["index"]
        t = q.shape[1]
        tmax = cache["k"].shape[1]
        int8_cache = cache["k"].dtype == torch.int8
        if int8_cache:
            new = dict(zip(("k", "k_scale"), self._quantize_kv(k)))
            new.update(zip(("v", "v_scale"), self._quantize_kv(v)))
        else:
            new = {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}
        kpos = torch.arange(tmax, device=q.device)
        if torch.is_tensor(index) and index.dim() == 1:
            rows = torch.arange(q.shape[0], device=q.device)[:, None]
            cols = index[:, None] + torch.arange(t, device=q.device)  # (B, t)
            for name, val in new.items():
                cache[name][rows, cols] = val
            # (B, 1, t, Tmax): each row's causal + unwritten mask
            mask = (kpos[None, None, :] <= cols[:, :, None])[:, None]
        else:
            index = int(index)
            for name, val in new.items():
                cache[name][:, index:index + t] = val
            qpos = index + torch.arange(t, device=q.device)[:, None]
            mask = kpos[None, :] <= qpos                       # (t, Tmax)
        cache["index"] = index + t
        if not int8_cache:
            return scaled_dot_product_attention(
                q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask=mask,
                impl="dense")
        sm = 1.0 / math.sqrt(self.head_dim)
        s = torch.einsum("bthd,bshd->bhts", q,
                         cache["k"].to(q.dtype)).float()
        s = s * sm * cache["k_scale"].transpose(1, 2)[:, :, None, :]
        s = s.masked_fill(~(mask if mask.dim() == 4 else mask[None, None]),
                          float("-inf"))
        p = torch.softmax(s, dim=-1)
        pv = (p * cache["v_scale"].transpose(1, 2)[:, :, None, :]).to(q.dtype)
        return torch.einsum("bhts,bshd->bthd", pv, cache["v"].to(q.dtype))

    def init_cache(self, batch: int, max_len: int,
                   dtype=torch.float32) -> dict:
        """This layer's KV-cache entry, on the layer's device.
        ``dtype=torch.int8`` allocates the quantized layout: int8 K/V plus
        float32 per-(token, head) scales (see :meth:`_decode`)."""
        device = next(self.parameters()).device
        shape = (batch, max_len, self.num_heads, self.head_dim)
        cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device),
                 "index": 0}
        if dtype == torch.int8:
            for name in ("k_scale", "v_scale"):
                cache[name] = torch.zeros(shape[:3], dtype=torch.float32,
                                          device=device)
        return cache

    def extra_repr(self):
        seq = ("" if self.sequence_axis is None else
               f", sequence_axis={self.sequence_axis!r}, mode={self.mode!r}")
        return (f"{self.embed_dim}, heads={self.num_heads}, "
                f"causal={self.causal}{seq}")
