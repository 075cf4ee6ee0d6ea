"""Decoder-only Transformer LM — counterpart of
``tpu_dist/models/transformer.py`` (training forward).

Pre-LN blocks (LN → MHSA → residual, LN → MLP(4x, GELU) → residual),
learned positional embeddings, weight-untied LM head, ``norm="layernorm"``.
Module paths match the JAX package's (``tok``, ``pos``, ``block0.attn``,
``block0.mlp.0``, ``ln_f``, ``head``).  MoE, remat, RMSNorm/rope, the KV
cache and ``generate`` come with later slices."""

from __future__ import annotations

import torch

from .. import nn
from ..ops._build import resolve_device

__all__ = ["TransformerLM", "TransformerBlock"]


class TransformerBlock(torch.nn.Module):
    def __init__(self, dim: int, num_heads: int, causal: bool = True,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.ln1 = nn.LayerNorm(dim, device=device)
        self.attn = nn.MultiheadSelfAttention(dim, num_heads, causal=causal,
                                              device=device)
        self.ln2 = nn.LayerNorm(dim, device=device)
        self.mlp = nn.Sequential(nn.Linear(dim, 4 * dim, device=device),
                                 nn.GELU(),
                                 nn.Linear(4 * dim, dim, device=device))

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        x = x + self.mlp(self.ln2(x))
        return x


class TransformerLM(torch.nn.Module):
    """Causal LM: tokens (B, T) → logits (B, T, vocab)."""

    def __init__(self, vocab_size: int, dim: int = 128, depth: int = 2,
                 num_heads: int = 4, max_seq_len: int = 1024,
                 causal: bool = True, norm: str = "layernorm", device=None):
        super().__init__()
        if norm != "layernorm":
            raise NotImplementedError(
                f"norm={norm!r}: RMSNorm (with rope) comes with a later slice")
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.max_seq_len = max_seq_len
        self.depth = depth
        self.causal = causal
        self.tok = nn.Embedding(vocab_size, dim, device=device)
        self.pos = nn.Embedding(max_seq_len, dim, device=device)
        for i in range(depth):
            setattr(self, f"block{i}",
                    TransformerBlock(dim, num_heads, causal=causal,
                                     device=device))
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
