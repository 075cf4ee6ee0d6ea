"""Autoregressive decode throughput — KV-cache generation on the card.

The port's twin of the JAX package's ``benchmarks/generate.py``: the
GPT-2-small-shaped TransformerLM (vocab 32768, dim 768, depth 12, heads
12) with bf16 parameters, weights from a seeded generator, decoding through
:meth:`~tpu_dist_torch.models.TransformerLM.generate` with the bf16 KV cache
by default; ``int8_weights`` swaps the Linears (the LM head included) and
the attention projections for weight-only int8
(:func:`~tpu_dist_torch.nn.quantize_linear_weights`), the embedding tables
staying bf16.  This is the serving decode step's path (ROADMAP S1) without
the scheduler.

Decode reads every parameter once a token (the embedding tables excepted:
one row a token), so each row gives tokens/s and the parameter-read
bandwidth that rate implies (:func:`per_token_read_bytes`; the KV cache's
traffic is extra, so the bandwidth is a lower bound on what moves).
Timing: CUDA events around whole ``generate`` calls, medians over
``reps``; a decode token's time is the long call's minus the short call's
over the tokens between them, which takes out the prefill.  Where that
difference is under a tenth of the long call, or implies reading the
weights faster than the card's memory rate, the row falls back to the long
call over its tokens (``gross_timing_fallback``), the JAX rule.

    python -m tpu_dist_torch.benchmarks.generate [--mode run|int8|latency|
        latency_int8|long_context|prefill]
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from ..models import TransformerLM
from ..nn import Embedding, quantize_linear_weights
from ..nn.module import reset_parameters
from ..nn.quant import QuantEmbedding
from ..ops._build import resolve_device
from ._card import device_stamp, median_seconds, timed_seconds

__all__ = ["build_lm", "per_token_read_bytes", "run", "run_int8",
           "run_latency", "run_latency_int8", "run_long_context_int8_cache",
           "run_prefill", "PEAK_BYTES_S"]

PEAK_BYTES_S = 3.35e12   # H100 SXM memory rate (data sheet)


def build_lm(max_seq_len: int, int8_weights: bool, dim: int = 768,
             depth: int = 12, heads: int = 12, vocab: int = 32768,
             device=None, seed: int = 0) -> TransformerLM:
    """The GPT-2-small-shaped LM in eval mode with bf16 parameters drawn
    from ``seed``; with ``int8_weights`` every Linear (the head too) and
    the attention projections weight-only int8, the embeddings bf16."""
    device = resolve_device(device)
    model = TransformerLM(vocab_size=vocab, dim=dim, depth=depth,
                          num_heads=heads, max_seq_len=max_seq_len,
                          device=device)
    reset_parameters(model, torch.Generator(device=device).manual_seed(seed))
    if int8_weights:
        quantize_linear_weights(model, attention=True)
    return model.to(torch.bfloat16).eval()


def per_token_read_bytes(model) -> tuple:
    """``(read, total)``: the bytes of parameters a decoded token reads —
    every tensor but the embedding tables, of which a token gathers one row
    — and the bytes of all of them."""
    embed = {path for path, mod in model.named_modules()
             if isinstance(mod, (Embedding, QuantEmbedding))}
    read = total = 0
    for path, mod in model.named_modules():
        for t in list(mod.parameters(recurse=False)) + list(
                mod.buffers(recurse=False)):
            b = t.numel() * t.element_size()
            total += b
            if path not in embed:
                read += b
    return read, total


def _decode_seconds(gen, gen_long: int, gen_short: int, reps: int, device,
                    read_bytes: int) -> tuple:
    """``(seconds a decode token, gross fallback?)`` from ``gen(n)``."""
    for n in (gen_long, gen_short):   # warm
        gen(n)
    d_long = median_seconds(lambda: gen(gen_long), device, reps)
    d_short = median_seconds(lambda: gen(gen_short), device, reps)
    diff = d_long - d_short
    sec = diff / (gen_long - gen_short)
    gross = (diff < 0.1 * d_long
             or read_bytes / max(sec, 1e-12) > PEAK_BYTES_S)
    if gross:
        sec = d_long / gen_long
    return sec, gross


def run(batch: int = 8, prompt_len: int = 128, gen_long: int = 256,
        gen_short: int = 32, dim: int = 768, depth: int = 12,
        heads: int = 12, vocab: int = 32768, reps: int = 5,
        int8_weights: bool = False, cache_dtype=None, device=None,
        keep_tokens: bool = False) -> dict:
    """Tokens/s of greedy decode at ``batch`` after a ``prompt_len``
    prompt, and the parameter-read bandwidth they imply.  ``keep_tokens``
    adds the long call's output (``tokens``, the prompt and its
    continuation) and the seed-0 prompt (``prompt``) to the row."""
    device = resolve_device(device)
    cache_dtype = cache_dtype or torch.bfloat16
    model = build_lm(prompt_len + gen_long, int8_weights, dim=dim,
                     depth=depth, heads=heads, vocab=vocab, device=device)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, vocab, (batch, prompt_len))
                              ).to(device)

    def gen(n):
        return model.generate(prompt, n, cache_dtype=cache_dtype)

    n_bytes, n_bytes_total = per_token_read_bytes(model)
    sec, gross = _decode_seconds(gen, gen_long, gen_short, reps, device,
                                 n_bytes)
    n_params = sum(t.numel() for t in model.parameters())
    gb_per_tok = n_bytes / 1e9
    kept = ({"prompt": prompt.tolist(), "tokens": gen(gen_long).tolist()}
            if keep_tokens else {})
    return {
        "metric": ("transformer_lm_decode_int8_tokens_per_sec"
                   if int8_weights else
                   "transformer_lm_decode_tokens_per_sec"),
        "value": batch / sec,
        "unit": "tokens/sec (batch total, KV-cache decode)",
        "ms_per_token": sec * 1e3,
        "model": {"params_M": n_params / 1e6, "depth": depth, "dim": dim,
                  "heads": heads, "vocab": vocab,
                  "cache_dtype": str(cache_dtype).split(".")[-1],
                  "weights": "int8(linear+head+attn)+bf16embed"
                             if int8_weights else "bfloat16"},
        "batch": batch,
        "prompt_len": prompt_len,
        "implied_weight_read_gb_per_sec": gb_per_tok / sec,
        "weight_read_mb_per_token": n_bytes / 1e6,
        "weight_total_mb": n_bytes_total / 1e6,
        "bandwidth_share_of_peak": n_bytes / sec / PEAK_BYTES_S,
        "gross_timing_fallback": gross,
        "n_chips": 1,
        **device_stamp(device),
        **kept,
    }


def run_int8(device=None) -> dict:
    """Weight-only int8 decode at the default batch 8."""
    return run(int8_weights=True, device=device)


def _latency(int8_weights: bool, device=None) -> dict:
    """Batch-1 latency: long windows (512/64 tokens)."""
    r = run(batch=1, gen_long=512, gen_short=64, reps=6,
            int8_weights=int8_weights, device=device)
    r["metric"] = ("transformer_lm_decode_batch1_int8_tokens_per_sec"
                   if int8_weights else
                   "transformer_lm_decode_batch1_tokens_per_sec")
    return r


def run_latency(device=None) -> dict:
    """Batch-1 bf16 decode latency."""
    return _latency(False, device)


def run_latency_int8(device=None) -> dict:
    """Batch-1 int8-weight decode latency."""
    return _latency(True, device)


def run_long_context_int8_cache(prompt_len: int = 7680, gen_long: int = 384,
                                gen_short: int = 48, reps: int = 6,
                                device=None, vocab: int = 32768,
                                **model_kw) -> dict:
    """Batch-1 decode after a long prompt with int8 weights, where the KV
    cache and not the weights dominates the bytes a token reads: the bf16
    cache against the int8 cache, timed in turns in one process (a rep of
    each, and again), so drift hits both alike.  A row that fell back to
    the gross rate includes the long prefill, and then the speedup is
    null."""
    device = resolve_device(device)
    model = build_lm(prompt_len + gen_long, True, vocab=vocab,
                     device=device, **model_kw)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, vocab, (1, prompt_len))
                              ).to(device)
    caches = {"bf16_cache": torch.bfloat16, "int8_cache": torch.int8}
    for dt in caches.values():
        for n in (gen_long, gen_short):
            model.generate(prompt, n, cache_dtype=dt)
    times = {name: ([], []) for name in caches}
    for _ in range(reps):
        for name, dt in caches.items():
            for i, n in enumerate((gen_long, gen_short)):
                times[name][i].append(timed_seconds(
                    lambda: model.generate(prompt, n, cache_dtype=dt),
                    device))
    rows = {}
    for name, (t_long, t_short) in times.items():
        d_long, d_short = statistics.median(t_long), statistics.median(
            t_short)
        diff = d_long - d_short
        gross = diff < 0.1 * d_long
        sec = d_long / gen_long if gross else diff / (gen_long - gen_short)
        rows[name] = {"ms_per_token": sec * 1e3, "tokens_per_sec": 1.0 / sec,
                      "gross_timing_fallback_incl_prefill": gross}
    flags = {name: r["gross_timing_fallback_incl_prefill"]
             for name, r in rows.items()}
    out = {
        "metric": "transformer_lm_decode_long_context_int8_cache",
        "value": rows["int8_cache"]["tokens_per_sec"],
        "unit": f"tokens/sec (batch 1, prompt {prompt_len}, int8 "
                "weights+cache)",
        "int8_cache_speedup_vs_bf16_cache": None if any(flags.values())
        else rows["int8_cache"]["tokens_per_sec"]
        / rows["bf16_cache"]["tokens_per_sec"],
        "prompt_len": prompt_len,
        **rows,
        "n_chips": 1,
        **device_stamp(device),
    }
    if any(flags.values()):
        out["speedup_note"] = ("speedup invalid: gross_timing_fallback rates "
                               f"include prefill ({flags})")
    return out


def run_prefill(batch: int = 8, prompt_len: int = 2048, reps: int = 6,
                device=None, vocab: int = 32768, **model_kw) -> dict:
    """Prefill throughput: ``generate(prompt, 1)`` is one causal forward
    over the prompt that fills the cache, then samples from its last
    logits (no decode step), timed whole.  Model FLOPs: 2 × the matmul
    parameters × the tokens (the embedding gathers left out) plus causal
    attention charged at the full 4·B·T²·dim a layer, as the attention rows
    count it."""
    device = resolve_device(device)
    model = build_lm(prompt_len + 8, False, vocab=vocab, device=device,
                     **model_kw)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, vocab, (batch, prompt_len))
                              ).to(device)
    model.generate(prompt, 1)
    sec = median_seconds(lambda: model.generate(prompt, 1), device, reps)
    embed = {path for path, mod in model.named_modules()
             if isinstance(mod, Embedding)}
    n_matmul = sum(t.numel() for path, mod in model.named_modules()
                   if path not in embed
                   for t in mod.parameters(recurse=False) if t.dim() >= 2)
    dim = model.tok.embedding_dim
    flops = (2 * n_matmul * batch * prompt_len
             + model.depth * 4 * batch * prompt_len * prompt_len * dim)
    return {
        "metric": "transformer_lm_prefill_tokens_per_sec",
        "value": batch * prompt_len / sec,
        "unit": f"tokens/sec (batch {batch}, {prompt_len}-token prompt "
                "prefill through generate())",
        "prefill_ms": sec * 1e3,
        "achieved_model_tflops": flops / sec / 1e12,
        "batch": batch,
        "prompt_len": prompt_len,
        "gross_timing_fallback": False,
        "n_chips": 1,
        **device_stamp(device),
    }


MODES = {"run": run, "int8": run_int8, "latency": run_latency,
         "latency_int8": run_latency_int8,
         "long_context": run_long_context_int8_cache,
         "prefill": run_prefill}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="all", choices=["all", *MODES])
    args = ap.parse_args(argv)
    for name, fn in MODES.items():
        if args.mode in ("all", name):
            print(json.dumps(fn()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
