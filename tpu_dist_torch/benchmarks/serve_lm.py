"""Continuous-batching serving on the card — counterpart of ``run()`` in
``benchmarks/bench_serve.py`` of the JAX package, at full width.

The model is the GPT-2-small ``TransformerLM`` the training slices use
(vocab 32768, dim 768, depth 12, heads 12, ``max_seq_len`` 2048, learned
positions, LayerNorm, float32 parameters) with random weights from a seeded
generator, served by ``SlotEngine(8 slots, max_len 2048)``.

The traffic is bench_serve's (:func:`workload`): 96 greedy requests, prompt
lengths drawn from four sizes, one request in five generating 96 tokens and
the others 4 or 8 — the mix that starves run-to-completion batching, since
a batch lives as long as its longest member.  One cut: bench_serve runs a
pool of 160 positions and this one 2048, so prompt lengths are scaled by
2048 / 160 (6, 12, 24, 40 become 77, 154, 307, 512 tokens) to take the same
share of the context; the request count, the order of the lengths and
counts, and the prompt ids (below 251) are bench_serve's.  At a
160-position pool the list is bench_serve's own, request for request.

Three runs, as in bench_serve, for each KV-cache dtype (float32, int8):

- ``static``: run-to-completion batching — admit ``slots`` requests, decode
  until every one of them finishes, only then admit the next batch;
- ``continuous``: the :class:`~tpu_dist_torch.serve.Scheduler` path, every
  request submitted up front — freed slots are refilled between decode
  iterations;
- ``sweep``: the continuous path at sustained request rates, 0.25, 0.5 and
  0.8 of the capacity the continuous run measured, on a second list drawn
  from seed 1.

Every request's tokens must be the same in static and continuous batching:
the pool's shapes do not depend on its occupancy, so batching is a
schedule, not a change of numbers.  Reported per run: aggregate generated
tokens/s, TTFT p50/p99, end-to-end p50/p99, decode-step p50/p99, prefill
p50, occupancy and peak device memory; per cache, continuous tokens/s over
static.  Times are host clocks around work that ends in a device sync
(every step reads its tokens back).

    python -m tpu_dist_torch.benchmarks.serve_lm [--requests 96]
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import numpy as np
import torch

from ..models import TransformerLM
from ..nn.module import reset_parameters
from ..ops._build import resolve_device
from ..serve import Request, Scheduler, SlotEngine

__all__ = ["CONFIG", "build", "workload", "warmup", "run"]

CONFIG = dict(vocab_size=32768, dim=768, depth=12, num_heads=12,
              max_seq_len=2048)
CACHE_DTYPES = {"float32": torch.float32, "int8": torch.int8}
# bench_serve's pool, whose prompt lengths workload() scales to max_len
REFERENCE_POOL = 160
SWEEP = (0.25, 0.5, 0.8)


def build(config: dict = CONFIG, seed: int = 0, device=None):
    """The served model, its weights drawn from a generator seeded with
    ``seed``."""
    device = resolve_device(device)
    model = TransformerLM(**config, device=device)
    reset_parameters(model, torch.Generator(device=device).manual_seed(seed))
    return model


def workload(n: int = 96, seed: int = 0,
             max_len: int = CONFIG["max_seq_len"]) -> list:
    """bench_serve's ``_workload(n, seed)``, prompt lengths scaled from its
    160-position pool to ``max_len``: each request's prompt length is drawn
    from {6, 12, 24, 40}, its new-token count is 96 with probability 0.2
    and else 4 or 8, and its prompt ids below 251, by bench_serve's own
    draws; each prompt is then extended (or cut) to ``max_len / 160``
    times its length, with ids from a second generator, so the lengths and
    counts come in bench_serve's order at any pool size.  Returns dicts of
    ``prompt``/``max_new_tokens``/``temperature``/``seed`` (all greedy)."""
    rng = np.random.default_rng(seed)
    more = np.random.default_rng([seed, REFERENCE_POOL])
    scale = max_len / REFERENCE_POOL
    reqs = []
    for _ in range(n):
        plen = int(rng.choice([6, 12, 24, 40]))
        gen = 96 if rng.random() < 0.2 else int(rng.choice([4, 8]))
        prompt = rng.integers(0, 251, size=plen)
        size = round(plen * scale)
        extra = more.integers(0, 251, size=max(0, size - plen))
        reqs.append({"prompt": np.concatenate([prompt, extra])[:size]
                     .astype(np.int32),
                     "max_new_tokens": gen, "temperature": 0.0, "seed": 0})
    return reqs


def warmup(engine: SlotEngine, reqs: list) -> None:
    """One request through every prompt bucket the list uses, then the
    stats are reset: first calls (allocator growth, library set-up) stay
    out of the measured window."""
    for b in sorted({engine.bucket_for(len(r["prompt"])) for r in reqs}):
        engine.admit(Request(np.zeros(min(b, engine.max_len - 2), np.int32),
                             2))
        while not engine.idle():
            engine.step()
    engine.reset_stats()


def _summary(mode: str, engine: SlotEngine, wall: float, outputs: list,
             device) -> dict:
    st = engine.stats()
    row = {"mode": mode, "wall_s": wall,
           "generated_tokens": st["generated_tokens"],
           "tokens_per_s": st["generated_tokens"] / wall,
           "occupancy": st["occupancy"],
           "decode_steps": st["decode_steps"],
           "ttft_p50_ms": st["ttft"]["p50"] * 1e3,
           "ttft_p99_ms": st["ttft"]["p99"] * 1e3,
           "e2e_p50_ms": st["e2e"]["p50"] * 1e3,
           "e2e_p99_ms": st["e2e"]["p99"] * 1e3,
           "decode_step_p50_ms": st["decode_step"]["p50"] * 1e3,
           "decode_step_p99_ms": st["decode_step"]["p99"] * 1e3,
           "prefill_p50_ms": st["prefill"]["p50"] * 1e3,
           "outputs": outputs}
    if device.type == "cuda":
        row["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device)
    return row


def _submit_args(r: dict) -> dict:
    return {k: r[k] for k in ("max_new_tokens", "temperature", "seed")}


def _engine(model, reqs: list, slots: int, cache_dtype) -> SlotEngine:
    """A warmed-up engine, the device's peak memory reset after it.  The
    previous run's engine is collected first, so the peak is this one's."""
    gc.collect()
    if model.device.type == "cuda":
        torch.cuda.empty_cache()
    engine = SlotEngine(model, num_slots=slots, cache_dtype=cache_dtype,
                        device=model.device)
    warmup(engine, reqs)
    if model.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(model.device)
    return engine


def run_static(model, reqs: list, slots: int, cache_dtype) -> dict:
    """Run-to-completion batching over the engine: the admission barrier
    is the only difference from :func:`run_continuous`."""
    engine = _engine(model, reqs, slots, cache_dtype)
    outs = {}
    order = []
    t0 = time.perf_counter()
    for i in range(0, len(reqs), slots):
        for r in reqs[i:i + slots]:
            req = Request(r["prompt"], on_token=lambda q, t: outs.setdefault(
                q.id, []).append(t), **_submit_args(r))
            order.append(req.id)
            engine.admit(req)
        while not engine.idle():      # run-to-completion barrier
            engine.step()
    wall = time.perf_counter() - t0
    return _summary("static", engine, wall, [outs[i] for i in order],
                    model.device)


def run_continuous(model, reqs: list, slots: int, cache_dtype,
                   qps: float = 0.0, batch_window: float = 0.002) -> dict:
    """The scheduler path: ``qps`` > 0 paces the submissions at that rate,
    0 submits every request up front."""
    engine = _engine(model, reqs, slots, cache_dtype)
    sched = Scheduler(engine, batch_window=batch_window)
    try:
        t0 = time.perf_counter()
        handles = []
        for i, r in enumerate(reqs):
            if qps > 0:
                time.sleep(max(0.0, t0 + i / qps - time.perf_counter()))
            handles.append(sched.submit(r["prompt"], timeout=60.0,
                                        **_submit_args(r)))
        outputs = [h.wait_done(timeout=600.0) for h in handles]
        wall = time.perf_counter() - t0
    finally:
        sched.close()
    return dict(_summary("continuous", engine, wall, outputs, model.device),
                qps_target=qps)


def run(requests: int = 96, slots: int = 8, config: dict = CONFIG,
        cache_dtypes=("float32", "int8"), device=None) -> dict:
    """Static and continuous batching and the sustained-rate sweep for
    each KV-cache dtype; returns the rows (without the token lists) and
    whether the two batching modes gave every request the same tokens."""
    device = resolve_device(device)
    model = build(config, device=device)
    max_len = config["max_seq_len"]
    reqs = workload(requests, max_len=max_len)
    rows = []
    mismatched = 0
    for name in cache_dtypes:
        dtype = CACHE_DTYPES[name]
        static = run_static(model, reqs, slots, dtype)
        cont = run_continuous(model, reqs, slots, dtype)
        mismatched += sum(a != b for a, b in zip(static["outputs"],
                                                 cont["outputs"]))
        capacity = len(reqs) / cont["wall_s"]
        runs = [static, cont] + [
            dict(run_continuous(model, workload(requests, seed=1,
                                                max_len=max_len),
                                slots, dtype, qps=frac * capacity),
                 mode="sweep", qps_frac_of_capacity=frac)
            for frac in SWEEP]
        for row in runs:
            row.pop("outputs")
            rows.append(dict(row, cache=name))
        rows.append({"mode": "continuous_vs_static", "cache": name,
                     "tokens_per_s_ratio": (cont["tokens_per_s"]
                                            / static["tokens_per_s"])})
    return {"metric": "serve_lm_generated_tokens_per_s",
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else str(device)),
            "model": dict(config), "slots": slots, "requests": len(reqs),
            "prompt_tokens": int(sum(len(r["prompt"]) for r in reqs)),
            "new_tokens": int(sum(r["max_new_tokens"] for r in reqs)),
            "rows": rows, "requests_differing_between_modes": mismatched}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=96)
    print(json.dumps(run(requests=ap.parse_args().requests)))
