"""Decoder-only Transformer LM — counterpart of
``tpu_dist/models/transformer.py`` (training forward, KV-cache decoding and
the slot pool of continuous batching).

Pre-LN blocks (LN → MHSA → residual, LN → MLP(4x, GELU) → residual),
learned positional embeddings, weight-untied LM head, ``norm="layernorm"``.
With ``num_experts > 0`` every ``moe_every``-th block's MLP is a routed
:class:`~tpu_dist_torch.nn.MoELayer` (``moe_dispatch="dropless"``).  Module
paths match the JAX package's (``tok``, ``pos``, ``block0.attn``,
``block0.mlp.0`` or, for an MoE block, ``block0.mlp``, ``ln_f``, ``head``);
KV caches are keyed by the attention layers' paths (``block0.attn``), as
the JAX package's cache state is.  ``sequence_axis`` trains on sequence
shards over a mesh axis (ring attention or Ulysses in every block; the
parameters are the dense model's).  Remat and RMSNorm/rope come with later
slices (ROADMAP A7)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import nn
from ..ops._build import resolve_device
from .. import random

__all__ = ["TransformerLM", "TransformerBlock", "write_slot_rows"]


def write_slot_rows(cache: dict, rows: dict, slot: int) -> dict:
    """Copy ONE request's per-layer batch-1 cache rows into slot ``slot`` of
    a slot-cache pool, in place, leaving every other slot untouched — the
    write half of :meth:`TransformerLM.prefill_into_slot`.  ``rows`` holds
    one ``{"k": (1, Tmax, ...), ...}`` entry per layer path; only keys
    present in the pool entry are written (a row's ``index`` is ignored).
    Returns ``cache``."""
    for path, pool in cache.items():
        for name, buf in pool.items():
            buf[slot] = rows[path][name][0].to(buf.dtype)
    return cache


def _sample(logits, key, step: int, temperature: float, top_k: int,
            top_p: float):
    """:meth:`TransformerLM.generate`'s next tokens from (B, vocab) logits:
    greedy at temperature 0, else categorical from ``fold_in(key, step)``
    after the top-k and top-p masks, as the JAX package computes them."""
    if temperature <= 0:
        return logits.argmax(-1)
    # a 0-d tensor divisor: CUDA divides by a host scalar as a multiply by
    # its reciprocal, which can round otherwise
    logits = logits / logits.new_tensor(temperature)
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        # keep tokens whose cumulative probability BEFORE them is < p: the
        # argmax token (exclusive cumsum 0) always stays
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        thresh = torch.where(keep, desc, float("inf")).amin(-1, keepdim=True)
        logits = logits.masked_fill(logits < thresh, float("-inf"))
    return random.categorical(random.fold_in(key, step), logits)


class TransformerBlock(torch.nn.Module):
    def __init__(self, dim: int, num_heads: int, causal: bool = True,
                 mlp: Optional[torch.nn.Module] = None, device=None,
                 sequence_axis: Optional[str] = None, mode: str = "ring",
                 norm_eps: Optional[float] = None):
        """``norm_eps``: both LayerNorms' epsilon; None keeps LayerNorm's
        own default (1e-5).  ViT passes 1e-6, torchvision's."""
        super().__init__()
        device = resolve_device(device)
        eps = {} if norm_eps is None else {"eps": norm_eps}
        self.ln1 = nn.LayerNorm(dim, device=device, **eps)
        self.attn = nn.MultiheadSelfAttention(dim, num_heads, causal=causal,
                                              device=device,
                                              sequence_axis=sequence_axis,
                                              mode=mode)
        self.ln2 = nn.LayerNorm(dim, device=device, **eps)
        # mlp override: an nn.MoELayer for mixture-of-experts blocks
        self.mlp = mlp if mlp is not None else nn.Sequential(
            nn.Linear(dim, 4 * dim, device=device), nn.GELU(),
            nn.Linear(4 * dim, dim, device=device))

    def forward(self, x, cache: Optional[dict] = None):
        x = x + self.attn(self.ln1(x), cache=cache)
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
                 device=None, sequence_axis: Optional[str] = None,
                 mode: str = "ring"):
        """``num_experts > 0`` makes the MLP of every block ``i`` with
        ``i % moe_every == moe_every - 1`` a routed MoELayer; its aux loss
        is the layer's ``aux_loss`` after each forward (the DDP collects it
        into ``TrainState.model_state``).  As in the JAX package the
        default dispatch is ``"einsum"``, which the port does not have yet:
        pass ``moe_dispatch="dropless"``.

        ``sequence_axis``: a mesh axis of the default process group over
        which ``idx`` is this rank's sequence shard; every block's attention
        then runs ``mode`` (``"ring"`` or ``"ulysses"``) over the axis, and
        the learned positions start at the shard's offset."""
        super().__init__()
        if norm != "layernorm":
            raise NotImplementedError(
                f"norm={norm!r}: RMSNorm (with rope) comes with a later "
                f"slice (ROADMAP A7)")
        if num_experts > 0 and moe_every < 1:
            raise ValueError(f"moe_every must be >= 1, got {moe_every}")
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.max_seq_len = max_seq_len
        self.depth = depth
        self.causal = causal
        self.sequence_axis = sequence_axis
        self.tok = nn.Embedding(vocab_size, dim, device=device)
        self.pos = nn.Embedding(max_seq_len, dim, device=device)
        for i in range(depth):
            moe = num_experts > 0 and i % moe_every == moe_every - 1
            setattr(self, f"block{i}", TransformerBlock(
                dim, num_heads, causal=causal, device=device,
                sequence_axis=sequence_axis, mode=mode, mlp=nn.MoELayer(dim, num_experts, top_k=moe_top_k,
                                capacity_factor=moe_capacity_factor,
                                dispatch=moe_dispatch, device=device)
                if moe else None))
        self.ln_f = nn.LayerNorm(dim, device=device)
        self.head = nn.Linear(dim, vocab_size, device=device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def embed_tokens(self, idx, pos_offset=None):
        """Token + learned positional embeddings for ``idx`` (B, T).
        ``pos_offset`` is an int, or a (B,) tensor of per-row positions
        (the slot pool's decode step); None is 0, or with
        ``sequence_axis`` the shard's offset, its index on the axis times
        T (``lax.axis_index`` in the JAX package)."""
        t = idx.shape[1]
        if pos_offset is None:
            pos_offset = 0
            if self.sequence_axis is not None:
                from ..dist import axis_group
                pos_offset = axis_group(self.sequence_axis).index * t
        if torch.is_tensor(pos_offset) and pos_offset.dim():
            pos = pos_offset[:, None] + torch.arange(t, device=idx.device)
        else:
            pos = torch.arange(int(pos_offset), int(pos_offset) + t,
                               device=idx.device)
        return self.tok(idx) + self.pos(pos)

    def forward(self, idx, pos_offset=None, cache: Optional[dict] = None):
        """``cache``: a KV cache from :meth:`init_cache` (keyed by attention
        path), written in place; None for the uncached forward."""
        x = self.embed_tokens(idx, pos_offset)
        for i in range(self.depth):
            path = f"block{i}.attn"
            x = getattr(self, f"block{i}")(
                x, cache=None if cache is None else cache[path])
        return self.head(self.ln_f(x))

    # -- autoregressive inference ------------------------------------------

    def init_cache(self, batch: int, max_len: Optional[int] = None,
                   dtype=torch.float32) -> dict:
        """KV cache for :meth:`generate`: one ``{"k", "v", "index"}`` entry
        per attention layer (int8: plus the scales), keyed by module path,
        on the model's device."""
        if self.sequence_axis is not None:
            raise ValueError("KV-cache decode runs on gathered sequences; "
                             "build the model without sequence_axis for "
                             "generation")
        if not self.causal:
            raise ValueError("KV-cache decode requires causal attention: a "
                             "bidirectional model's logits depend on future "
                             "tokens and cannot be decoded incrementally")
        max_len = self.max_seq_len if max_len is None else max_len
        return {f"block{i}.attn": getattr(self, f"block{i}").attn.init_cache(
                    batch, max_len, dtype) for i in range(self.depth)}

    def init_slot_cache(self, slots: int, max_len: Optional[int] = None,
                        dtype=torch.float32) -> dict:
        """KV-cache pool for slot-based continuous batching: the
        :meth:`init_cache` layout without the per-layer write index — each
        :meth:`decode_step` call supplies every slot's position as its
        ``lengths``, so the host-side engine holds the one record of slot
        occupancy."""
        return {path: {k: v for k, v in entry.items() if k != "index"}
                for path, entry in
                self.init_cache(slots, max_len, dtype).items()}

    @torch.inference_mode()
    def decode_step(self, tokens, lengths, cache: dict):
        """ONE decode iteration over a slot pool: feed each slot its last
        token, get each slot's next-token logits.

        ``tokens``: (B,) ints, the token each slot decoded last (or its
        prompt's last token).  ``lengths``: (B,) ints on the host, the
        tokens already in each slot's cache row, i.e. its write position.
        ``cache``: from :meth:`init_slot_cache`, written in place.  Returns
        ``(logits (B, vocab), cache)``.  Free slots decode rows the caller
        ignores, at length 0.  :meth:`generate` runs its decode loop on this
        method, so slot decoding and offline generation share one path."""
        lengths = np.asarray(lengths.cpu() if torch.is_tensor(lengths)
                             else lengths, np.int64).reshape(-1)
        tmax = next(iter(cache.values()))["k"].shape[1]
        for slot in np.flatnonzero((lengths < 0) | (lengths >= tmax)):
            raise ValueError(
                f"decode_step: slot {slot} is at length {lengths[slot]}; "
                f"its cache row holds positions 0..{tmax - 1}, so the write "
                f"would fall outside it")
        device = self.device
        lengths = torch.from_numpy(lengths).to(device)
        state = {path: dict(entry, index=lengths)
                 for path, entry in cache.items()}
        tokens = torch.as_tensor(tokens, device=device).long()[:, None]
        logits = self(tokens, pos_offset=lengths, cache=state)
        return logits[:, -1], cache

    @torch.inference_mode()
    def prefill_into_slot(self, prompt, length: int, slot: int, cache: dict):
        """Prefill ONE request into slot ``slot`` of a slot-cache pool while
        the other slots' rows stay untouched — the admission half of
        continuous batching.

        ``prompt``: (P,) ints, padded past ``length`` with any valid id (the
        padding's K/V lands at positions ``>= length``, which every later
        decode step masks out or overwrites first).  The prompt runs through
        a fresh batch-1 cache and :func:`write_slot_rows` copies its whole
        row into the slot, zeros past the prompt, as in the JAX package.
        Returns ``(logits of the last real token (vocab,), cache)``."""
        entry = next(iter(cache.values()))
        slots, tmax = entry["k"].shape[:2]
        prompt = torch.as_tensor(prompt, device=self.device).long()
        if not 0 < length <= prompt.shape[0] <= tmax:
            raise ValueError(f"prefill_into_slot: need 0 < length ({length})"
                             f" <= prompt ({prompt.shape[0]}) <= cache row "
                             f"({tmax})")
        if not 0 <= slot < slots:
            raise ValueError(f"prefill_into_slot: slot {slot} outside the "
                             f"pool's {slots} slots")
        rows = self.init_cache(1, tmax, entry["k"].dtype)
        logits = self(prompt[None], cache=rows)
        write_slot_rows(cache, rows, slot)
        return logits[0, int(length) - 1], cache

    @torch.inference_mode()
    def generate(self, prompt, max_new_tokens: int, temperature: float = 0.0,
                 rng=None, cache_dtype=None, top_k: int = 0,
                 top_p: float = 1.0):
        """Autoregressive decoding with a KV cache.

        ``prompt``: int tokens (B, Tp).  Returns (B, Tp + max_new_tokens),
        the prompt with the continuation appended.  ``temperature`` 0 is
        greedy argmax; > 0 samples categorically from ``rng``, a key from
        :func:`tpu_dist_torch.serve.random_key` (the JAX package's stream,
        so a seed gives its tokens), after the optional truncations:
        ``top_k`` > 0 keeps the k most probable tokens, ``top_p`` < 1 the
        smallest set whose probability reaches p (the most probable token
        always stays).  The prompt is prefilled in one forward; each new
        token is one :meth:`decode_step` (a Python loop where the JAX
        package runs a ``lax.scan``), step ``i`` sampling from
        ``fold_in(rng, i)``."""
        prompt = torch.as_tensor(prompt, device=self.device)
        b, tp = prompt.shape
        if max_new_tokens <= 0:
            if max_new_tokens == 0:
                return prompt
            raise ValueError(f"max_new_tokens must be >= 0, got "
                             f"{max_new_tokens}")
        total = tp + max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(f"prompt ({tp}) + max_new_tokens "
                             f"({max_new_tokens}) exceeds max_seq_len "
                             f"({self.max_seq_len})")
        if temperature > 0 and rng is None:
            raise ValueError("temperature > 0 sampling requires rng=")
        if top_k < 0 or top_k > self.vocab_size:
            raise ValueError(f"top_k must be in [0, vocab_size], got "
                             f"{top_k}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")

        cache = self.init_cache(b, total, cache_dtype or torch.float32)
        logits = self(prompt, cache=cache)
        key0 = (rng.to(self.device) if rng is not None
                else random.key(0, self.device))

        def sample(logits, step):
            return _sample(logits, key0, step, temperature, top_k, top_p)

        toks = [sample(logits[:, -1], 0)]
        slot_cache = {path: {k: v for k, v in entry.items() if k != "index"}
                      for path, entry in cache.items()}
        for i in range(max_new_tokens - 1):
            logits, slot_cache = self.decode_step(
                toks[-1], np.full(b, tp + i), slot_cache)
            toks.append(sample(logits, i + 1))
        return torch.cat([prompt, torch.stack(toks, 1).to(prompt.dtype)], 1)
