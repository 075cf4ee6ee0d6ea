"""Decoder-only Transformer LM — counterpart of
``tpu_dist/models/transformer.py`` (training forward).

Pre-LN blocks (LN → MHSA → residual, LN → MLP(4x, GELU) → residual),
learned positional embeddings, weight-untied LM head, ``norm="layernorm"``.
With ``num_experts > 0`` every ``moe_every``-th block's MLP is a routed
:class:`~tpu_dist_torch.nn.MoELayer` (``moe_dispatch="dropless"``).  Module
paths match the JAX package's (``tok``, ``pos``, ``block0.attn``,
``block0.mlp.0`` or, for an MoE block, ``block0.mlp``, ``ln_f``, ``head``).
Remat, RMSNorm/rope, the KV cache and ``generate`` come with later
slices."""

from __future__ import annotations

from typing import Optional

import torch

from .. import nn
from ..ops._build import resolve_device

__all__ = ["TransformerLM", "TransformerBlock"]


class TransformerBlock(torch.nn.Module):
    def __init__(self, dim: int, num_heads: int, causal: bool = True,
                 mlp: Optional[torch.nn.Module] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.ln1 = nn.LayerNorm(dim, device=device)
        self.attn = nn.MultiheadSelfAttention(dim, num_heads, causal=causal,
                                              device=device)
        self.ln2 = nn.LayerNorm(dim, device=device)
        # mlp override: an nn.MoELayer for mixture-of-experts blocks
        self.mlp = mlp if mlp is not None else nn.Sequential(
            nn.Linear(dim, 4 * dim, device=device), nn.GELU(),
            nn.Linear(4 * dim, dim, device=device))

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        x = x + self.mlp(self.ln2(x))
        return x


class TransformerLM(torch.nn.Module):
    """Causal LM: tokens (B, T) → logits (B, T, vocab)."""

    def __init__(self, vocab_size: int, dim: int = 128, depth: int = 2,
                 num_heads: int = 4, max_seq_len: int = 1024,
                 causal: bool = True, num_experts: int = 0,
                 moe_top_k: int = 2, moe_every: int = 1,
                 moe_capacity_factor: float = 1.25,
                 moe_dispatch: str = "einsum", norm: str = "layernorm",
                 device=None):
        """``num_experts > 0`` makes the MLP of every block ``i`` with
        ``i % moe_every == moe_every - 1`` a routed MoELayer; its aux loss
        is the layer's ``aux_loss`` after each forward (the DDP collects it
        into ``TrainState.model_state``).  As in the JAX package the
        default dispatch is ``"einsum"``, which the port does not have yet:
        pass ``moe_dispatch="dropless"``."""
        super().__init__()
        if norm != "layernorm":
            raise NotImplementedError(
                f"norm={norm!r}: RMSNorm (with rope) comes with a later slice")
        if num_experts > 0 and moe_every < 1:
            raise ValueError(f"moe_every must be >= 1, got {moe_every}")
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.max_seq_len = max_seq_len
        self.depth = depth
        self.causal = causal
        self.tok = nn.Embedding(vocab_size, dim, device=device)
        self.pos = nn.Embedding(max_seq_len, dim, device=device)
        for i in range(depth):
            moe = num_experts > 0 and i % moe_every == moe_every - 1
            setattr(self, f"block{i}", TransformerBlock(
                dim, num_heads, causal=causal, device=device,
                mlp=nn.MoELayer(dim, num_experts, top_k=moe_top_k,
                                capacity_factor=moe_capacity_factor,
                                dispatch=moe_dispatch, device=device)
                if moe else None))
        self.ln_f = nn.LayerNorm(dim, device=device)
        self.head = nn.Linear(dim, vocab_size, device=device)

    def embed_tokens(self, idx, pos_offset: int = 0):
        """Token + learned positional embeddings for ``idx`` (B, T)."""
        t = idx.shape[1]
        pos = torch.arange(pos_offset, pos_offset + t, device=idx.device)
        return self.tok(idx) + self.pos(pos)

    def forward(self, idx, pos_offset: int = 0):
        x = self.embed_tokens(idx, pos_offset)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.head(self.ln_f(x))
