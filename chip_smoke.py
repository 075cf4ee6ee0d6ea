#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_dist_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--only PHASE,...]

Phases, each printed as one JSON line:

1. ``env``/``build``: versions, the card, and the build of the CUDA kernels
   from ``tpu_dist_torch/csrc`` (one ``nvcc`` per source, all at once; the
   Triton kernels compile at first launch).
2. ``kernel``: every kernel of the training paths against its plain PyTorch
   version on the card, at the paths' shapes and at ragged shapes, with the
   tolerance it is held to; kernel, plain and library-yardstick times (CUDA
   events, median) and the least time the card could take (``bound_ms``).
   Flash attention (K2f, K2b) and the grouped products (K3 in its four
   forms, K4) are also timed against their older ``mma.sync`` design in the
   same run (``older_ms`` / ``mma_sync_ms``, in turns), every case checks
   which design each launch took (``flash_design``, ``gmm_design``), and
   two launches of K2f, K2b and K4 on the same inputs must agree bit for
   bit.  Their timed lines also split ``ms`` (one call a sample, the
   wrapper's host work included) into the card's own time (``device_ms``,
   the host kept ahead) and the wrapper's host time (``host_ms``); K2b's
   line also gives its dQ and dK/dV kernels' card time (``dq_ms``,
   ``dkv_ms``, from ``torch.profiler`` over ten calls).
3. ``slice``: the dense GPT-2-small-shaped TransformerLM trained at full
   width through the port's DDP (bf16, fused cross-entropy, flash attention
   at T = 2048), with every kernel's launch count over that run (every
   flash launch must be the wgmma design); then
   ``composition``: one step against the plain composition (dense attention,
   unfused loss) on the same weights and batch.
4. ``moe_slice``: the same trunk with a top-2-of-8 dropless MoE in every
   block, trained at full width (grouped matmuls K3/K4 too), with the launch
   counts over that run, by design for K2f/K2b/K3/K4 (every one must be the
   wgmma design); ``moe_layer``: one full-width MoE layer forward and
   backward with the kernels against the plain grouped products on the same
   inputs; ``moe_composition``: one step against the plain composition
   (plain grouped products, dense attention, unfused loss).
5. ``serve``: the full-width dense model (float32, weights from a seeded
   generator) served through ``ServeClient`` → socket → ``Frontend`` →
   ``Scheduler`` → ``SlotEngine(8 slots, max_len 2048)``: the 16 requests
   of :func:`smoke_requests` (prompts 16-1536 tokens, one above 1024; 32-128
   new tokens; 12 greedy, 4 sampled at temperature 0.8 with seeds 1-4).
   Every request must end ``done`` with all its tokens and equal
   ``generate()`` alone on the card, and two greedy ones the plain path on
   a CPU copy of the weights, token for token except at a step where the
   two largest values the reference drew its token from (its own logits
   there, replayed) lie within ``SERVE_TIE_GAP`` (each such divergence is
   printed with its gap).  The path runs no kernel: every launch count over
   the served run must be 0.  Printed: tokens/s, TTFT and decode-step
   percentiles, prefill p50, occupancy, peak memory and the decode step's
   bound.  Once the frontend, scheduler and engine are closed, the memory
   the card holds must be back to what it held before the phase, within
   ``SERVE_LEFTOVER_BYTES``, so the next phase's peak is its own.
   ``serve_int8``: the same with the int8 KV cache, against
   ``generate(cache_dtype=torch.int8)``.  ``quant``: the model with int8
   weights (``quantize_linear_weights(attention=True)``), 32 greedy tokens
   on the card against the same weights on the CPU, and its decode step
   against the float32 model's, in turns.
6. ``convnet``: the ConvNet twin example's ``train`` at world 1 on the card
   (batch 100, synthetic MNIST, float32) for 300 steps at lr 0.05: the loss
   must fall at least 5x, and ``evaluate`` over the 10,000 test images must
   count 10,000 and score above 0.9; one float32 step against the same
   step on a CPU copy of the port, TF32 off (``VISION_STEP_TOL``); then
   images/s/GPU, step ms and peak memory at bench.py's headline (batch
   8192, bf16, ``train_chunk`` of 50) and its float32 row (2048), under
   torch's default TF32 permissions.  ``resnet``: resnet18(num_classes=10)
   through the ResNet twin example's path (RandomCrop + Flip on the host,
   DataLoader, DeviceLoader), batch 256, 20 steps in float32 (then
   ``evaluate``, an exact count) and 20 in bf16: losses finite and falling,
   every BatchNorm statistic moved and finite; one float32 step (parameters
   and BatchNorm statistics) against the CPU copy; images/s/GPU at batch
   256 and 1024 (bf16).  Neither path runs a hand-written kernel: every
   launch count over each phase must be 0.
7. ``optim``: at the dense slice's 136,993,280 float32 parameters (150
   tensors), every optimizer's multi-tensor update (SGD classic, nesterov
   and with a schedule; AdamW; Adam; RMSprop centered with momentum;
   Adagrad), EMA's and ``clip_grad_norm`` against its plain per-parameter
   loop on the same state and gradients (``OPTIM_TOL``, with a planted
   1e-3 error that must be rejected); ms and launches per update against
   the bytes bound, the plain loop's, and torch.optim's fused AdamW and
   SGD as a yardstick.  An update that launches a third or more of the
   plain loop's kernels fails: the multi-tensor path must not fall back.
8. ``resume``: the dense slice at full width and depth with
   ``AdamW(lr=warmup_cosine)``, ``accum_steps=2`` and an EMA: six steps
   straight against three, a save through ``AsyncCheckpointer``, a fresh
   DDP restored with ``verify=True`` and three more; parameters, AdamW
   moments, counts and the EMA shadow must be equal bit for bit, and the
   K1/K2 launch counts those of two micro-batches a step.  Save and
   restore seconds and the checkpoint's bytes.  Then the example_mp twin
   with ``--checkpoint-dir``/``--resume`` and the train_lm twin at its
   defaults with ``--generate 32`` (the loss falls tenfold, all 32
   transitions follow the permutation).
9. ``flash_offdiag``: K2f/K2b in ``causal="offdiag"`` mode against their
   plain versions in each design (wgmma: bf16, D = 64, (8, 2048, 12) with
   blocks (1024, 1024) and (1024, 512); mma_sync: bf16, D = 128; fma:
   float32, blocks clamped to 512; and ragged T in each): tolerance, a
   bit-for-bit repeat, exact launches by design and mode, the first query
   block empty, and the plain causal result rejected; timed against the
   operations bound over the offdiag pairs and SDPA with the band as a
   boolean mask.  ``split_diag``: ``flash_attention(split_diag=True)``
   against ``split_diag=False`` at (8, 2048, 12, 64) and (1, 8192, 12, 64),
   bf16: forward and q/k/v grads, one causal and one offdiag call of each
   kernel a pass (the kernels line's offdiag launches), both timed.
10. ``ring``: the ring's hop functions over 4 virtual ranks in one process
   at GPT-2-small's attention over 8192 positions (4 shards of 2048, bf16),
   causal and not, against one K2f/K2b call on the gathered sequence, with
   n(n+1)/2 or n² launches; Ulysses' local attention (3 heads a rank);
   ``ring_self_attention`` at world 1 through its entry point.
   ``sp_train``: ``train_lm --parallel sp`` at world 1, full width
   (GPT-2-small, vocab 32768, T = 8192, batch 1, bf16), each mode: one step
   against the model without ``sequence_axis``, then 20 steps (the loss
   falls; K2f/K2b 12 launches a step; step ms, tokens/s).
11. ``augment``: ``DeviceAugment.imagenet(224, bf16)``,
   ``imagenet_eval(224, 256)`` and ``cifar10(32)`` at full batch on the
   card against the same call on a CPU copy (float32 within 1e-5, bf16
   within one ulp), the modes' invariants, images/s of the augmentation, of
   the raw host gather and of the ResNet-50 step, the pinned staging's host
   time and ``loader_keeps_card_fed``.  ``imagenet``: the
   ``example_imagenet`` twin at its defaults (ResNet-50, 224, 128, bf16,
   augmentation on the card) for 30 steps and ``--evaluate``; one float32
   step at batch 4 against the CPU copy; the ``imagenet_e2e`` twin (the
   step alone and the sustained rate).  ``vit``: the twin with ``--model
   vit_b_16`` for 20 steps at 64; one float32 step at batch 2 against the
   CPU copy; the ``vit_train`` twin; then ViT-B/16's attention at (64, 197,
   12, 64) through the dense composition and through K2f/K2b, timed in
   turns, the flash result held to its plain version.  None of the three
   paths runs a hand-written kernel: every count over each must be 0.
12. ``kernels``: one line over all kernels; the card's name and power limit
   as ``nvidia-smi`` gives them; and, last, the result line.

Each phase's wall time is printed (``phase_seconds``).  ``--only`` runs the
named phases (``cross_entropy``, ``flash``, ``gmm``, ``slice``,
``composition``, ``moe_slice``, ``moe_layer``, ``moe_composition``,
``serve``, ``serve_int8``, ``quant``, ``convnet``, ``resnet``, ``optim``,
``resume``, ``flash_offdiag``, ``split_diag``, ``ring``, ``sp_train``,
``augment``, ``imagenet``, ``vit``) and never prints the result line.

Any failure exits non-zero and prints no result line; so does a machine with
no CUDA device, or a directory without the ``tpu_dist_torch`` package.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

import torch

# H100 SXM data-sheet peaks (dense): the bound of a kernel is the larger of
# its bytes over the memory rate and its operations over the peak rate of
# their type
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16_tensor": 989e12, "f32": 67e12}

# bf16 flash: the floor under each element's own tolerance, as fractions of
# its row's rms and of the tensor's; and the relative error on the later
# half of the rows that the check must reject
BF16_ATOL_ROW = 1.6e-2
BF16_ATOL_ALL = 1e-3
SENSITIVITY = 0.03

# the tolerances flash attention's kernels are held to against their plain
# versions, by dtype
FLASH_BF16_TOL = {"rtol": 1.6e-2, "atol": 0.0, "atol_row": BF16_ATOL_ROW,
                  "atol_all": BF16_ATOL_ALL,
                  "why": "each element within 2 bf16 steps (2^-6 at the top "
                         "of a binade) of the larger of its own value and its "
                         "row's rms (the row over D: one query of o and dq, "
                         "one key of dk and dv): kernel and plain round the "
                         "outputs to bf16, and round p or dS to bf16 at other "
                         "scales or from float32 values summed in other "
                         "orders, which shows at the scale of the row's "
                         "terms even where an element sums to near 0; plus "
                         "1e-3 of the tensor's rms for a row whose terms "
                         "cancel (a causal first query: its dS = p(dP - "
                         "delta) is float32 round-off of 0)"}
FLASH_F32_TOL = {"rtol": 2e-5, "atol": 2e-5, "atol_row": 0.0, "atol_all": 0.0,
                 "why": "float32 throughout; the JAX package's forward "
                        "tolerance (tests/test_flash_attention.py:42), here "
                        "for o and the gradients alike"}

KERNEL_INFO = {
    "cross_entropy_fwd": ("K1f", "triton",
                          "tpu_dist_torch/ops/_cross_entropy_triton.py",
                          "tpu_dist/ops/cross_entropy.py:89"),
    "cross_entropy_bwd": ("K1b", "triton",
                          "tpu_dist_torch/ops/_cross_entropy_triton.py",
                          "tpu_dist/ops/cross_entropy.py:121"),
    "flash_fwd": ("K2f", "cuda", "tpu_dist_torch/csrc/flash_attention.cu",
                  "tpu_dist/ops/flash_attention.py:169"),
    "flash_bwd": ("K2b", "cuda", "tpu_dist_torch/csrc/flash_attention.cu",
                  "tpu_dist/ops/flash_attention.py:305"),
    # the same kernels in causal="offdiag" mode (_tile_live, :89-100): a row
    # key limit in place of the causal mask
    "flash_fwd_offdiag": ("K2f-o", "cuda",
                          "tpu_dist_torch/csrc/flash_attention.cu",
                          "tpu_dist/ops/flash_attention.py:169"),
    "flash_bwd_offdiag": ("K2b-o", "cuda",
                          "tpu_dist_torch/csrc/flash_attention.cu",
                          "tpu_dist/ops/flash_attention.py:305"),
    "gmm": ("K3", "cuda", "tpu_dist_torch/csrc/gmm.cu",
            "tpu_dist/ops/gmm.py:74"),
    "tgmm": ("K4", "cuda", "tpu_dist_torch/csrc/gmm.cu",
             "tpu_dist/ops/gmm.py:181"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int = 10, warm: int = 2,
            hide_host: bool = False) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds.  With
    ``hide_host`` the start event waits on the card behind a sleep of about
    a millisecond, so the host has enqueued the call before the clock
    starts: the card's own time for it, as in a training step where the
    host runs ahead (a separate reading; ``ms`` everywhere is without)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median host time of one ``fn()`` call started with the card idle:
    the wrapper's own work up to its launch, not the card's."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def split_ms(fn, lib_fn) -> dict:
    """The card's own time of a kernel call and of its library call, and
    the kernel wrapper's host time: what ``ms`` (one call a sample, host
    work included) is made of."""
    return {"device_ms": time_ms(fn, hide_host=True),
            "host_ms": host_ms(fn),
            "library_device_ms": time_ms(lib_fn, hide_host=True)}


def kernel_ms(fn, names: dict, calls: int = 10) -> dict:
    """Card time per call of each kernel whose name contains the given
    fragment, from ``torch.profiler`` over ``calls`` calls of ``fn``
    (``{label: fragment}`` → ``{label: ms}``; None where the profiler saw
    no such kernel)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names)
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total",
                        getattr(ev, "cuda_time_total", 0.0))
        for label, frag in names.items():
            if frag in ev.key:
                out[label] = (out[label] or 0.0) + total / 1e3 / calls
    return out


def bound(bytes_moved: float, ops: float, kind: str):
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, rtol: float, atol: float, atol_row: float = 0.0,
            atol_all: float = 0.0):
    """Hold every element to its own scale: ``|got - want| <= atol +
    atol_row*rms_row(want) + atol_all*rms(want) + rtol*|want|``, where
    ``rms_row`` is the rms of the element's row (its last axis) and ``rms``
    that of the whole tensor.  Returns the max abs error, that error
    relative to max |want|, the margin (the largest error over its limit;
    within tolerance when <= 1) and whether got is finite and within
    tolerance everywhere."""
    got, want = got.detach().float(), want.detach().float()
    diff = (got - want).abs()
    floor = (atol + atol_all * float(want.pow(2).mean().sqrt())
             + atol_row * want.pow(2).mean(-1, keepdim=True).sqrt())
    margin = float((diff / (floor + rtol * want.abs())).max())
    ok = margin <= 1.0 and bool(torch.isfinite(got).all())
    err = float(diff.max())
    return err, err / max(float(want.abs().max()), 1e-30), margin, ok


def offdiag_live(t: int, blocks) -> tuple:
    """The rows offdiag mode reads at Tq = Tk = t (``blocks`` = the clamped
    (bq, bk)): queries from the first whose key limit is above 0 (the rows
    before it see no key), and the keys below the last query's limit."""
    bq, bk = blocks
    return min(-(-bk // bq) * bq, t), min((t - 1) // bq * bq // bk * bk, t)


def causal_pairs(tq: int, tk: int, causal, blocks=None) -> int:
    """The (query, key) pairs a head computes: all, k <= q (causal), or k <
    floor((q // bq) * bq / bk) * bk (offdiag, ``blocks`` = the clamped
    (bq, bk))."""
    if causal == "offdiag":
        bq, bk = blocks
        return sum(min((i // bq) * bq // bk * bk, tk) for i in range(tq))
    if not causal:
        return tq * tk
    return sum(min(i + 1, tk) for i in range(tq))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_cross_entropy(results):
    import torch.nn.functional as F

    from tpu_dist_torch import nn
    from tpu_dist_torch.ops import cross_entropy as ce

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    # path shapes: (B*T, V) = (16384, 32768) bf16, int64 labels
    n, v = 8 * 2048, 32768
    logits = torch.randn(n, v, device=dev, generator=g).to(torch.bfloat16)
    labels = torch.randint(0, v, (n,), device=dev, generator=g)
    cot = torch.rand(n, device=dev, generator=g)

    t0 = time.perf_counter()
    nll_k, lse_k = ce.cross_entropy_fwd(logits, labels)
    torch.cuda.synchronize()
    first_fwd_s = time.perf_counter() - t0
    nll_p, lse_p = ce.cross_entropy_fwd_plain(logits, labels)
    # both reduce the same bf16 inputs in float32, in other orders
    tol_f = {"rtol": 1e-5, "atol": 1e-4,
             "why": "float32 sums of 32768 terms in another order"}
    e1, r1, m1, ok1 = compare(nll_k, nll_p, tol_f["rtol"], tol_f["atol"])
    e2, r2, m2, ok2 = compare(lse_k, lse_p, tol_f["rtol"], tol_f["atol"])
    t0 = time.perf_counter()
    d_k = ce.cross_entropy_bwd(logits, labels, lse_p, cot)
    torch.cuda.synchronize()
    first_bwd_s = time.perf_counter() - t0
    d_p = ce.cross_entropy_bwd_plain(logits, labels, lse_p, cot)
    tol_b = {"rtol": 8e-3, "atol": 1e-8,
             "why": "both round the same float32 value to bf16 (step 2^-8); "
                    "exp differs in the last float32 bits, which can flip "
                    "one rounding"}
    e3, r3, m3, ok3 = compare(d_k, d_p, tol_b["rtol"], tol_b["atol"])

    lg = logits.detach().requires_grad_(True)
    lib_out = F.cross_entropy(lg, labels, reduction="none")
    lib_cot = cot.to(lib_out.dtype)
    t_fwd = (time_ms(lambda: ce.cross_entropy_fwd(logits, labels)),
             time_ms(lambda: ce.cross_entropy_fwd_plain(logits, labels)),
             time_ms(lambda: F.cross_entropy(logits, labels,
                                             reduction="none")))
    t_bwd = (time_ms(lambda: ce.cross_entropy_bwd(logits, labels, lse_p, cot)),
             time_ms(lambda: ce.cross_entropy_bwd_plain(logits, labels,
                                                        lse_p, cot)),
             time_ms(lambda: torch.autograd.grad(lib_out, lg, lib_cot,
                                                 retain_graph=True)))
    el, lb = logits.element_size(), labels.element_size()
    bf = bound(n * v * el + n * lb + 2 * n * 4, 4 * n * v, "f32")
    bb = bound(2 * n * v * el + n * (lb + 8), 4 * n * v, "f32")
    shape = {"logits": [n, v], "dtype": "bfloat16", "labels": "int64"}
    emit("kernel", name="cross_entropy_fwd", shape=shape,
         max_abs_err=max(e1, e2), max_rel_err=max(r1, r2),
         margin={"nll": m1, "lse": m2}, tolerance=tol_f, ok=ok1 and ok2,
         first_call_s=first_fwd_s, ms=t_fwd[0], plain_ms=t_fwd[1],
         library_ms=t_fwd[2], library="F.cross_entropy(reduction='none')",
         bound_ms=bf[0], bound_by=bf[1])
    emit("kernel", name="cross_entropy_bwd", shape=shape, max_abs_err=e3,
         max_rel_err=r3, margin=m3, tolerance=tol_b, ok=ok3,
         first_call_s=first_bwd_s,
         ms=t_bwd[0],
         plain_ms=t_bwd[1], library_ms=t_bwd[2],
         library="F.cross_entropy backward", bound_ms=bb[0], bound_by=bb[1])
    results["cross_entropy_fwd"] = dict(max_abs_err=max(e1, e2), ms=t_fwd[0],
                                        plain_ms=t_fwd[1],
                                        library_ms=t_fwd[2],
                                        bound_ms=bf[0], bound_by=bf[1])
    results["cross_entropy_bwd"] = dict(max_abs_err=e3, ms=t_bwd[0],
                                        plain_ms=t_bwd[1],
                                        library_ms=t_bwd[2],
                                        bound_ms=bb[0], bound_by=bb[1])
    ok = ok1 and ok2 and ok3
    del logits, lg, lib_out, d_k, d_p

    # ragged: (1000, 50257) float32, int32 labels, a tenth ignore_index;
    # the kernels on the masked labels, and the loss module end to end
    n, v = 1000, 50257
    logits = torch.randn(n, v, device=dev, generator=g) * 3
    labels = torch.randint(0, v, (n,), device=dev, generator=g,
                           dtype=torch.int32)
    labels[torch.rand(n, device=dev, generator=g) < 0.1] = -100
    safe = torch.where(labels != -100, labels, torch.zeros_like(labels))
    cot = torch.rand(n, device=dev, generator=g)
    nll_k, lse_k = ce.cross_entropy_fwd(logits, safe)
    nll_p, lse_p = ce.cross_entropy_fwd_plain(logits, safe)
    tol_r = {"rtol": 1e-5, "atol": 1e-4,
             "why": "float32 throughout; sums in another order"}
    e4, r4, m4, ok4 = compare(torch.stack([nll_k, lse_k]),
                              torch.stack([nll_p, lse_p]), tol_r["rtol"],
                              tol_r["atol"])
    e5, r5, m5, ok5 = compare(
        ce.cross_entropy_bwd(logits, safe, lse_p, cot),
        ce.cross_entropy_bwd_plain(logits, safe, lse_p, cot),
        tol_r["rtol"], 1e-7)
    lf = logits.detach().requires_grad_(True)
    loss_k = nn.CrossEntropyLoss(fused=True)(lf, labels)
    (gk,) = torch.autograd.grad(loss_k, lf)
    lp = logits.detach().requires_grad_(True)
    loss_p = nn.CrossEntropyLoss(fused=False)(lp, labels)
    (gp,) = torch.autograd.grad(loss_p, lp)
    e6, r6, m6, ok6 = compare(loss_k, loss_p, tol_r["rtol"], tol_r["atol"])
    e7, r7, m7, ok7 = compare(gk, gp, tol_r["rtol"], 1e-9)
    emit("kernel", name="cross_entropy_ragged",
         shape={"logits": [n, v], "dtype": "float32", "labels": "int32",
                "ignored_rows": int((labels == -100).sum())},
         max_abs_err={"fwd": e4, "bwd": e5, "loss": e6, "loss_grad": e7},
         max_rel_err={"fwd": r4, "bwd": r5, "loss": r6, "loss_grad": r7},
         margin={"fwd": m4, "bwd": m5, "loss": m6, "loss_grad": m7},
         tolerance=tol_r, ok=ok4 and ok5 and ok6 and ok7)
    return ok and ok4 and ok5 and ok6 and ok7


def check_flash(results):
    import torch.nn.functional as F

    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    ok_all = True

    def by_design():
        return {k.__name__: dict(k.launches_by_design)
                for k in (fa.flash_fwd, fa.flash_bwd)}

    def run_case(b, t, h, d, dtype, causal, tol, timed):
        nonlocal ok_all
        # q, k, v as the strided views of a fused projection, as on the path
        qkv = torch.randn(b, t, 3, h, d, device=dev, generator=g).to(dtype)
        q, k, v = qkv.unbind(2)
        do = torch.randn(b, t, h, d, device=dev, generator=g).to(dtype)
        scale = 1.0 / math.sqrt(d)
        # the design every launch of the case must take, from the shapes
        design = fa.flash_design(dtype, t, t, d,
                                 [x.stride() for x in (q, k, v)])
        before = by_design()
        t0 = time.perf_counter()
        o_k, lse_k = fa.flash_fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale)
        delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
        grads_k = fa.flash_bwd(q, k, v, do, lse_p, delta, causal, scale)
        torch.cuda.synchronize()
        grads_p = fa.flash_bwd_plain(q, k, v, do, lse_p, delta, causal, scale)
        # a second launch of each kernel on the same inputs must agree bit
        # for bit: no atomics, a fixed order of sums
        o_k2, lse_k2 = fa.flash_fwd(q, k, v, causal, scale)
        grads_k2 = fa.flash_bwd(q, k, v, do, lse_p, delta, causal, scale)
        torch.cuda.synchronize()
        bitwise = {"fwd": (torch.equal(o_k, o_k2)
                           and torch.equal(lse_k, lse_k2)),
                   "bwd": all(torch.equal(a, b2)
                              for a, b2 in zip(grads_k, grads_k2))}
        after = by_design()
        ran = {k: {dn: after[k][dn] - before[k][dn] for dn in fa.DESIGNS}
               for k in after}
        ok_design = all(ran[k][design] == 2 and sum(ran[k].values()) == 2
                        for k in ran)
        lims = (tol["rtol"], tol["atol"], tol["atol_row"], tol["atol_all"])
        pairs_kp = {"o": (o_k, o_p), "dq": (grads_k[0], grads_p[0]),
                    "dk": (grads_k[1], grads_p[1]),
                    "dv": (grads_k[2], grads_p[2])}
        errs, rels, margins = {}, {}, {}
        ok = True
        for name, (got, want) in pairs_kp.items():
            errs[name], rels[name], margins[name], ok_t = compare(
                got, want, *lims)
            ok = ok and ok_t
        errs["lse"], rels["lse"], margins["lse"], ok_l = compare(
            lse_k, lse_p, 1e-5, 1e-4)
        ok = ok and ok_l and ok_design and all(bitwise.values())
        shape = {"q": [b, t, h, d], "dtype": str(dtype).split(".")[-1],
                 "causal": causal}
        fields = {}
        if timed:
            # the check must reject a kernel that is wrong by a few percent
            # on the later half of the rows (queries for o and dq, keys for
            # dk and dv: the small values under a causal mask)
            caught = {}
            for name, (got, want) in pairs_kp.items():
                bad = got.clone()
                bad[:, t // 2:] *= 1 + SENSITIVITY
                caught[name] = compare(bad, want, *lims)[2]
            fields["sensitivity"] = {"late_half_scaled_by": 1 + SENSITIVITY,
                                     "margin": caught}
            ok = ok and all(m > 1.0 for m in caught.values())
        ok_all = ok_all and ok
        emit("kernel", name="flash", shape=shape, design=design,
             launches_by_design=ran, ok_design=ok_design,
             repeat_bitwise=bitwise, max_abs_err=errs,
             max_rel_err=rels, margin=margins, tolerance=tol, ok=ok,
             first_call_s=first_s, **fields)
        if not timed:
            return
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        lib_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        def fwd(older=False):
            return fa.flash_fwd(q, k, v, causal, scale, _older=older)

        def bwd(older=False):
            return fa.flash_bwd(q, k, v, do, lse_p, delta, causal, scale,
                                _older=older)

        def lib_fwd():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)

        def lib_bwd():
            return torch.autograd.grad(lib_o, (qt, kt, vt),
                                       do.transpose(1, 2), retain_graph=True)

        def ab(fn):
            """Same-call times of the design the shape takes and of the
            older mma.sync design, in turns (new, old, old, new): the mean
            of each pair."""
            t_new, t_old = time_ms(fn), time_ms(lambda: fn(True))
            t_old = (t_old + time_ms(lambda: fn(True))) / 2
            return (t_new + time_ms(fn)) / 2, t_old

        t_f = (*ab(fwd),
               time_ms(lambda: fa.flash_fwd_plain(q, k, v, causal, scale),
                       reps=5),
               time_ms(lib_fwd))
        t_b = (*ab(bwd),
               time_ms(lambda: fa.flash_bwd_plain(q, k, v, do, lse_p, delta,
                                                  causal, scale), reps=5),
               time_ms(lib_bwd))
        el = q.element_size()
        pairs = b * h * causal_pairs(t, t, causal)
        tile = b * t * h * d * el
        bf = bound(4 * tile + b * h * t * 4, 4 * d * pairs, "bf16_tensor")
        bb = bound(7 * tile + 2 * b * h * t * 4, 10 * d * pairs,
                   "bf16_tensor")
        # the backward's two kernels apart: card time by kernel name
        split_b = kernel_ms(bwd, {"dq_ms": "flash_dq_wgmma_kernel",
                                  "dkv_ms": "flash_dkv_wgmma_kernel"})
        for name, tt, bd, flop, lib, split in (
                ("flash_fwd", t_f, bf, 4 * d * pairs,
                 "F.scaled_dot_product_attention", split_ms(fwd, lib_fwd)),
                ("flash_bwd", t_b, bb, 10 * d * pairs,
                 "F.scaled_dot_product_attention backward",
                 {**split_ms(bwd, lib_bwd), **split_b})):
            emit("kernel", name=name, shape=shape, design=design, ms=tt[0],
                 older_ms=tt[1], plain_ms=tt[2], library_ms=tt[3],
                 library=lib, bound_ms=bd[0], bound_by=bd[1],
                 tflops=flop / tt[0] / 1e9,
                 older_tflops=flop / tt[1] / 1e9,
                 bound_share=bd[0] / tt[0],
                 older_speedup=tt[1] / tt[0], library_ratio=tt[0] / tt[3],
                 **split)
        t_f = (t_f[0], t_f[2], t_f[3])
        t_b = (t_b[0], t_b[2], t_b[3])
        results["flash_fwd"] = dict(max_abs_err=max(errs["o"], errs["lse"]),
                                    ms=t_f[0], plain_ms=t_f[1],
                                    library_ms=t_f[2], bound_ms=bf[0],
                                    bound_by=bf[1])
        results["flash_bwd"] = dict(
            max_abs_err=max(errs["dq"], errs["dk"], errs["dv"]), ms=t_b[0],
            plain_ms=t_b[1], library_ms=t_b[2], bound_ms=bb[0],
            bound_by=bb[1])

    bf16_tol, f32_tol = FLASH_BF16_TOL, FLASH_F32_TOL
    run_case(8, 2048, 12, 64, torch.bfloat16, True, bf16_tol, timed=True)
    # ragged T through the wgmma design (D = 64): a partial last tile of
    # queries and of keys, causal and not
    for causal in (True, False):
        run_case(2, 1000, 3, 64, torch.bfloat16, causal, bf16_tol,
                 timed=False)
    run_case(1, 515, 2, 64, torch.bfloat16, True, bf16_tol, timed=False)
    # a ring hop's shape (a 2048-row shard of RING_SHAPE), causal (the
    # diagonal block) and not (a block below it): full tiles, both modes
    for causal in (True, False):
        run_case(1, 2048, 12, 64, torch.bfloat16, causal, bf16_tol,
                 timed=False)
    # ragged T and D, both head-dim instantiations of the older kernels
    # (D <= 64, D <= 128), both dtypes: the designs flash_design picks
    for dtype, tol in ((torch.bfloat16, bf16_tol), (torch.float32, f32_tol)):
        for causal in (True, False):
            run_case(2, 1000, 3, 40, dtype, causal, tol, timed=False)
        run_case(1, 515, 2, 128, dtype, True, tol, timed=False)
    return ok_all


# ---------------------------------------------------------------------------
# phase 3: the slice
# ---------------------------------------------------------------------------

def check_slice(results):
    from tpu_dist_torch.benchmarks.transformer_lm import run
    from tpu_dist_torch.ops import KERNELS

    zero_launch_counts()
    res = run()
    counts = {k.__name__: k.launches for k in KERNELS}
    steps, depth = res["steps_run"], res["model"]["depth"]
    per_step = {"cross_entropy_fwd": 1, "cross_entropy_bwd": 1,
                "flash_fwd": depth, "flash_bwd": depth}
    ok_counts = all(counts[n] == steps * c for n, c in per_step.items())
    # every flash launch of the path ran the wgmma design
    by_design = {k.__name__: dict(k.launches_by_design)
                 for k in KERNELS if hasattr(k, "launches_by_design")}
    ok_design = all(d["wgmma"] == counts[n] for n, d in by_design.items())
    ok_loss = all(math.isfinite(x) for x in res["losses"])
    for name in per_step:
        results.setdefault(name, {})["launches"] = counts[name]
    emit("slice", tokens_per_s_per_gpu=res["value"], step_ms=res["step_ms"],
         peak_mem_bytes=res["peak_mem_bytes"], n_params=res["n_params"],
         achieved_model_tflops=res["achieved_model_tflops"],
         model=res["model"], steps_run=steps, launches=counts,
         launches_per_step_expected=per_step, ok_launches=ok_counts,
         launches_by_design=by_design, ok_design=ok_design,
         losses=res["losses"], ok_losses_finite=ok_loss)
    return ok_counts and ok_design and ok_loss


def check_composition(results):
    """One step of the kernel path against the plain composition (dense
    attention, unfused loss) from the same seed and batch."""
    from tpu_dist_torch import nn, optim
    from tpu_dist_torch.benchmarks.transformer_lm import build
    from tpu_dist_torch.parallel import DistributedDataParallel

    ddp, x, y = build(device="cuda")
    state = ddp.init(seed=0)
    p0 = {k: p.detach().clone() for k, p in state.params.items()}
    state, m_k = ddp.train_step(state, x, y)
    upd_k = {k: state.params[k].detach() - p0[k] for k in p0}
    plain = DistributedDataParallel(
        ddp.module, optimizer=optim.SGD(lr=0.01),
        loss_fn=nn.CrossEntropyLoss(fused=False),
        compute_dtype=torch.bfloat16)
    state_p = plain.init(seed=0)
    same_init = all(torch.equal(state_p.params[k], p0[k]) for k in p0)
    with nn.attention_impl("dense"):
        state_p, m_p = plain.train_step(state_p, x, y)
    # the relative error of each leaf's update, so that a fault confined to
    # the attention leaves is not hidden under the embedding and head
    num, den = {}, {}
    with torch.no_grad():
        for k in p0:
            upd_p = state_p.params[k] - p0[k]
            num[k] = float((upd_p - upd_k[k]).pow(2).sum())
            den[k] = float(upd_p.pow(2).sum())
    rel = math.sqrt(sum(num.values()) / sum(den.values()))
    leaf = {k: math.sqrt(num[k] / den[k]) if den[k] else
            (0.0 if num[k] == 0 else math.inf) for k in p0}
    worst = max(leaf, key=leaf.get)
    attn = {k: e for k, e in leaf.items() if ".attn." in k}
    worst_attn = max(attn, key=attn.get)
    loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
    tol = {"loss_rtol": 1e-2, "update_rel": 5e-2, "attn_leaf_update_rel": 3e-2,
           "leaf_update_rel": 0.25,
           "why": "bf16 compute on both paths: the plain loss is a bf16 "
                  "mean (step 2^-8 relative) and dense attention rounds its "
                  "scores and softmax to bf16 where the kernel keeps "
                  "float32. Leaf limits are twice the worst leaf errors "
                  "measured on an H100 (attention 1.5e-2; any leaf 0.125, "
                  "a LayerNorm gain, whose gradient is a sum over all "
                  "16384 tokens that mostly cancels); the run is seeded "
                  "and its kernels deterministic"}
    ok = (same_init and abs(loss_k - loss_p) <= tol["loss_rtol"] * abs(loss_p)
          and rel <= tol["update_rel"]
          and attn[worst_attn] <= tol["attn_leaf_update_rel"]
          and leaf[worst] <= tol["leaf_update_rel"])
    emit("composition", loss_kernel_path=loss_k, loss_plain_path=loss_p,
         update_rel_err=rel, worst_leaf=[worst, leaf[worst]],
         worst_attn_leaf=[worst_attn, attn[worst_attn]],
         worst_leaves=sorted(leaf.items(), key=lambda kv: -kv[1])[:5],
         same_init=same_init, tolerance=tol, ok=ok)
    return ok


# ---------------------------------------------------------------------------
# the grouped matmuls (K3 gmm, K4 tgmm) against their plain versions
# ---------------------------------------------------------------------------

def grouped_case(counts, b, d, h, dtype, g, g_w2=None):
    """The MoE layer's layout for the given tokens per expert: rows sorted
    by expert into segments padded to ``b`` rows (padding rows zero), the
    static bound of ``ceil(kN/b) + E`` blocks with the tail on the last
    expert.  Returns x (M, d), dy (M, h) (zero on padding rows, as the
    backward gives), w (E, d, h), w2 (E, h, d) (from ``g_w2`` if given),
    bias (E, h), the block map, the live-block count and the padded segment
    ends."""
    e, kn = len(counts), sum(counts)
    nb = -(-kn // b) + e
    mask = torch.zeros(nb * b, dtype=torch.bool)
    bg, start = [], 0
    for i, c in enumerate(counts):
        blocks = -(-c // b)
        mask[start:start + c] = True
        bg += [i] * blocks
        start += blocks * b
    n_live = len(bg)
    bg += [e - 1] * (nb - n_live)
    ends = torch.tensor([sum(-(-c // b) * b for c in counts[:i + 1])
                         for i in range(e)], dtype=torch.int32)
    dev = "cuda"
    mask = mask.to(dev)[:, None]
    x = (torch.randn(nb * b, d, device=dev, generator=g) * mask).to(dtype)
    dy = (torch.randn(nb * b, h, device=dev, generator=g) * mask).to(dtype)
    w = (torch.randn(e, d, h, device=dev, generator=g) / math.sqrt(d)
         ).to(dtype)
    bias = torch.randn(e, h, device=dev, generator=g).to(dtype)
    w2 = (torch.randn(e, h, d, device=dev, generator=g_w2 or g)
          / math.sqrt(h)).to(dtype)
    return dict(x=x, dy=dy, w=w, w2=w2, bias=bias,
                bg=torch.tensor(bg, dtype=torch.int32, device=dev),
                n_live=torch.tensor([n_live], dtype=torch.int32, device=dev),
                ends=ends.to(dev), routed=kn)


def launches_by_design(gm):
    """A copy of each grouped kernel's launch counts by design."""
    return {k.__name__: dict(k.launches_by_design) for k in (gm.gmm, gm.tgmm)}


def zero_launch_counts():
    """Every kernel's launch count, and the grouped kernels' counts by
    design, set to 0 just before a slice is driven."""
    from tpu_dist_torch.ops import KERNELS
    for k in KERNELS:
        k.launches = 0
        for by in ("launches_by_design", "launches_by_mode"):
            if hasattr(k, by):
                getattr(k, by).update(dict.fromkeys(getattr(k, by), 0))


def library_grouped(fn_variants):
    """The first variant of a PyTorch grouped-product call that runs here
    (layout rules differ between versions): ``(label, fn)`` or ``(None,
    None)``.  A yardstick only; the port never calls it."""
    for label, fn in fn_variants:
        try:
            fn()
            torch.cuda.synchronize()
            return label, fn
        except Exception as exc:  # try the next layout
            print(f"chip_smoke: {label}: {type(exc).__name__}: {exc}"[:300],
                  file=sys.stderr)
    return None, None


def check_gmm(results):
    gm = importlib.import_module("tpu_dist_torch.ops.gmm")

    g = torch.Generator(device="cuda").manual_seed(3)
    ok_all = True
    bf16_tol = {"rtol": 8e-3, "atol": 0.0, "atol_row": 0.0, "atol_all": 1e-5,
                "why": "kernel and plain sum the same exact bf16 products in "
                       "float32 in other orders and round once to bf16, which "
                       "can flip one rounding: one bf16 step, at most 2^-7 "
                       "of the value; plus 1e-5 of the tensor's rms for an "
                       "element that sums to near 0"}
    f32_tol = {"rtol": 1e-5, "atol": 0.0, "atol_row": 0.0, "atol_all": 1e-6,
               "why": "float32 throughout, sums in other orders (the CPU "
                      "parity tests' 1e-5 relative); 1e-6 of the tensor's "
                      "rms for an element that sums to near 0"}

    def lims(tol):
        return tol["rtol"], tol["atol"], 0.0, tol["atol_all"]

    def run_case(name, c, b, tol, design, out_dtype=None, timed=False):
        """``design``: the kernel design every launch of the case must
        take (gm.gmm_design of its shapes)."""
        nonlocal ok_all
        x, dy, w, bias, bg, n_live = (c[k] for k in ("x", "dy", "w", "bias",
                                                     "bg", "n_live"))
        e = w.shape[0]
        before = launches_by_design(gm)
        t0 = time.perf_counter()
        out_k = gm.gmm(x, w, bg, n_live, bias=bias, block_rows=b,
                       out_dtype=out_dtype)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        out_p = gm.gmm_plain(x, w, bg, n_live, bias=bias, block_rows=b,
                             out_dtype=out_dtype)
        dx_k = gm.gmm(dy, w.transpose(1, 2), bg, n_live, block_rows=b)
        dx_p = gm.gmm_plain(dy, w.transpose(1, 2), bg, n_live, block_rows=b)
        dw_k, db_k = gm.tgmm(x, dy, bg, e, block_rows=b, with_rowsum=True,
                             out_dtype=out_dtype, n_live_blocks=n_live)
        dw_p, db_p = gm.tgmm_plain(x, dy, bg, e, block_rows=b,
                                   with_rowsum=True, out_dtype=out_dtype,
                                   n_live_blocks=n_live)
        # the other two forms of the path: w2 (H -> D) forward, and its dx
        # pass through the transpose view of the contiguous (E, H, D) w2
        w2 = c["w2"]
        pairs = {"out": (out_k, out_p), "dx": (dx_k, dx_p),
                 "dw": (dw_k, dw_p), "db": (db_k, db_p)}
        for key, (a, wm) in {"out_w2": (dy, w2),
                             "dx_w2": (x, w2.transpose(1, 2))}.items():
            if x.dtype == torch.bfloat16:  # float32 keeps its two forms
                pairs[key] = (gm.gmm(a, wm, bg, n_live, block_rows=b),
                              gm.gmm_plain(a, wm, bg, n_live, block_rows=b))
        # a second tgmm launch must agree bit for bit: no atomics
        dw_k2, db_k2 = gm.tgmm(x, dy, bg, e, block_rows=b, with_rowsum=True,
                               out_dtype=out_dtype, n_live_blocks=n_live)
        torch.cuda.synchronize()
        bitwise = torch.equal(dw_k, dw_k2) and torch.equal(db_k, db_k2)
        errs, margins, ok = {}, {}, bitwise
        for key, (got, want) in pairs.items():
            errs[key], _, margins[key], ok_t = compare(got, want, *lims(tol))
            ok = ok and ok_t
        # the dx form reads w^T through a transpose view; a contiguous copy
        # of w^T (the other layout of the kernel) gives the same products
        errs["dx_contig"], _, margins["dx_contig"], ok_t = compare(
            gm.gmm(dy, w.transpose(1, 2).contiguous(), bg, n_live,
                   block_rows=b), dx_p, *lims(tol))
        ok = ok and ok_t
        fields = {}
        if timed:
            # planted faults the check must reject: two experts' weights
            # swapped, one block sent to another expert, and two experts'
            # weight gradients swapped
            w_bad = w.clone()
            w_bad[[0, 1]] = w[[1, 0]]
            bg_bad = bg.clone()
            bg_bad[0] = (bg[0] + 1) % e
            caught = {
                "w_swapped": compare(gm.gmm(x, w_bad, bg, n_live, bias=bias,
                                            block_rows=b), out_p,
                                     *lims(tol))[2],
                "block_to_other_expert": compare(
                    gm.gmm(x, w, bg_bad, n_live, bias=bias, block_rows=b),
                    out_p, *lims(tol))[2],
                "dw_swapped": compare(dw_k[[1, 0, *range(2, e)]], dw_p,
                                      *lims(tol))[2]}
            fields["planted_faults_margin"] = caught
            ok = ok and all(m > 1.0 for m in caught.values())
        after = launches_by_design(gm)
        ran = {k: {d: after[k][d] - before[k][d] for d in gm.DESIGNS}
               for k in after}
        ok_design = all(ran[k][design] > 0 and sum(ran[k].values())
                        == ran[k][design] for k in ran)
        ok = ok and ok_design
        ok_all = ok_all and ok
        counts = torch.diff(c["ends"], prepend=c["ends"][:1] * 0)
        emit("kernel", name=name, design=design, launches_by_design=ran,
             ok_design=ok_design, tgmm_repeat_bitwise=bitwise,
             shape={"x": list(x.shape), "w": list(w.shape),
                    "dtype": str(x.dtype).split(".")[-1], "block_rows": b,
                    "out_dtype": str(out_dtype or x.dtype).split(".")[-1],
                    "padded_rows_per_expert": counts.tolist(),
                    "routed_rows": c["routed"],
                    "live_blocks": int(n_live), "blocks": bg.numel()},
             max_abs_err=errs, margin=margins, tolerance=tol, ok=ok,
             first_call_s=first_s, **fields)
        if not timed:
            return
        ends = c["ends"]
        live = int(n_live) * b
        el = x.element_size()

        def lib_gmm(a, bmat):
            return [("torch._grouped_mm", lambda: torch._grouped_mm(
                        a[:live], bmat, offs=ends)),
                    ("torch._grouped_mm (column-major b)",
                     lambda: torch._grouped_mm(
                         a[:live], bmat.transpose(1, 2).contiguous()
                         .transpose(1, 2), offs=ends))]

        def ab(new, old):
            """Same-call times of the new design and the older one, taken
            in turns (new, old, old, new): the mean of each pair."""
            t_new, t_old = time_ms(new), time_ms(old)
            t_old = (t_old + time_ms(old)) / 2
            return (t_new + time_ms(new)) / 2, t_old

        forms = {}
        # the four grouped products of the path: w1 (D->H) and w2 (H->D)
        # forward, and their dx passes against w^T (transpose views); the
        # kernels line keeps the w1 form
        w2 = c["w2"]
        for form, (a, bm, bb) in {"w1": (x, w, bias),
                                  "w2": (dy, w2, None),
                                  "dx_w1T": (dy, w.transpose(1, 2), None),
                                  "dx_w2T": (x, w2.transpose(1, 2), None)
                                  }.items():
            k_dim, n_dim = bm.shape[1], bm.shape[2]
            label, lib_fn = library_grouped(lib_gmm(a, bm))
            if lib_fn is None:
                dense = a[:c["routed"]]
                label = "torch.matmul dense (same live-row product)"
                lib_fn = (lambda dense=dense, w0=bm[0]: dense @ w0)
            new = (lambda a=a, bm=bm, bb=bb: gm.gmm(a, bm, bg, n_live,
                                                    bias=bb, block_rows=b))
            t_new, t_old = ab(
                new,
                lambda a=a, bm=bm, bb=bb: gm.gmm(a, bm, bg, n_live, bias=bb,
                                                 block_rows=b,
                                                 _older=True))
            flop = 2 * c["routed"] * k_dim * n_dim
            forms[form] = {
                **split_ms(new, lib_fn),
                "ms": t_new, "mma_sync_ms": t_old,
                "plain_ms": time_ms(lambda a=a, bm=bm, bb=bb: gm.gmm_plain(
                    a, bm, bg, n_live, bias=bb, block_rows=b), reps=3),
                "library_ms": time_ms(lib_fn), "library": label,
                "bound": bound(c["routed"] * k_dim * el
                               + e * k_dim * n_dim * el
                               + a.shape[0] * n_dim * el, flop,
                               "bf16_tensor"),
                "tflops": flop / t_new / 1e9,
                "mma_sync_tflops": flop / t_old / 1e9}
        d, h = x.shape[1], dy.shape[1]
        label, lib_fn = library_grouped([
            ("torch._grouped_mm (x^T . dy)", lambda: torch._grouped_mm(
                x[:live].t(), dy[:live], offs=ends)),
            ("torch._grouped_mm (x^T . dy, row-major a)",
             lambda: torch._grouped_mm(x[:live].t().contiguous(), dy[:live],
                                       offs=ends))])
        if lib_fn is None:
            label = "torch.matmul dense (same live-row product)"
            xr, dyr = x[:c["routed"]], dy[:c["routed"]]
            lib_fn = lambda: xr.t() @ dyr  # noqa: E731
        def new():
            return gm.tgmm(x, dy, bg, e, block_rows=b, with_rowsum=True,
                           n_live_blocks=n_live)

        t_new, t_old = ab(
            new,
            lambda: gm.tgmm(x, dy, bg, e, block_rows=b, with_rowsum=True,
                            n_live_blocks=n_live, _older=True))
        split_t = split_ms(new, lib_fn)
        t_t = (t_new,
               time_ms(lambda: gm.tgmm_plain(x, dy, bg, e, block_rows=b,
                                             with_rowsum=True,
                                             n_live_blocks=n_live), reps=3),
               time_ms(lib_fn))
        flop_t = 2 * c["routed"] * d * h
        bt = bound(c["routed"] * (d + h) * el + e * (d * h + h) * el,
                   flop_t, "bf16_tensor")
        for form, f in forms.items():
            emit("kernel", name=f"gmm_{form}", ms=f["ms"],
                 mma_sync_ms=f["mma_sync_ms"], plain_ms=f["plain_ms"],
                 library_ms=f["library_ms"], library=f["library"],
                 bound_ms=f["bound"][0], bound_by=f["bound"][1],
                 tflops=f["tflops"], mma_sync_tflops=f["mma_sync_tflops"],
                 device_ms=f["device_ms"], host_ms=f["host_ms"],
                 library_device_ms=f["library_device_ms"])
        emit("kernel", name="tgmm_w1", ms=t_t[0], mma_sync_ms=t_old,
             plain_ms=t_t[1], library_ms=t_t[2], library=label,
             bound_ms=bt[0], bound_by=bt[1], tflops=flop_t / t_t[0] / 1e9,
             mma_sync_tflops=flop_t / t_old / 1e9, **split_t)
        f = forms["w1"]
        results["gmm"] = dict(
            max_abs_err=max(errs[k] for k in ("out", "dx", "out_w2",
                                              "dx_w2")),
            ms=f["ms"], plain_ms=f["plain_ms"], library_ms=f["library_ms"],
            bound_ms=f["bound"][0], bound_by=f["bound"][1])
        results["tgmm"] = dict(max_abs_err=max(errs["dw"], errs["db"]),
                               ms=t_t[0], plain_ms=t_t[1],
                               library_ms=t_t[2], bound_ms=bt[0],
                               bound_by=bt[1])

    # path shapes: 16384 tokens routed top-2 of 8 by a random router, block
    # rows 512 (the MoE layer's choice at kN = 32768), D = 768, H = 3072
    probs = torch.randn(16384, 8, device="cuda", generator=g).softmax(-1)
    top2 = probs.topk(2, dim=-1).indices.reshape(-1)
    counts = torch.bincount(top2, minlength=8).tolist()
    run_case("grouped_path", grouped_case(counts, 512, 768, 3072,
                                          torch.bfloat16, g),
             512, bf16_tol, "wgmma", timed=True)
    # ragged: block rows 8 and 24, D and H not multiples of 64, one expert
    # with no rows, dead tail blocks; float32 output of bf16 once.  Their w2
    # (the forms added after these cases were first drawn) comes from a
    # generator of its own, so x, dy, w and bias stay as they were
    ragged = [37, 0, 81, 5, 60]
    g_w2 = torch.Generator(device="cuda").manual_seed(5)
    for dtype, tol, design in ((torch.bfloat16, bf16_tol, "mma_sync"),
                               (torch.float32, f32_tol, "fma")):
        for b in (8, 24):
            out_dtype = (torch.float32 if dtype == torch.bfloat16 and b == 24
                         else None)
            run_case("grouped_ragged",
                     grouped_case(ragged, b, 200, 360, dtype, g, g_w2), b,
                     tol, design, out_dtype=out_dtype)
    # the wgmma design off the path's shapes: block rows 128, D = 256, H =
    # 640 (a partial 192-wide column tile), one expert with no rows, dead
    # tail blocks
    run_case("grouped_wgmma_small",
             grouped_case([300, 0, 517, 129, 64], 128, 256, 640,
                          torch.bfloat16, g, g_w2), 128, bf16_tol, "wgmma")
    return ok_all


# ---------------------------------------------------------------------------
# the MoE slice
# ---------------------------------------------------------------------------

def check_moe_slice(results):
    from tpu_dist_torch.benchmarks.moe_lm import run
    from tpu_dist_torch.ops import KERNELS

    zero_launch_counts()
    res = run()
    counts = {k.__name__: k.launches for k in KERNELS}
    steps, depth = res["steps_run"], res["model"]["depth"]
    per_step = {"gmm": 4 * depth, "tgmm": 2 * depth, "cross_entropy_fwd": 1,
                "cross_entropy_bwd": 1, "flash_fwd": depth,
                "flash_bwd": depth}
    ok_counts = all(counts[n] == steps * c for n, c in per_step.items())
    # every grouped and every flash launch of the path ran the wgmma design
    by_design = {k.__name__: dict(k.launches_by_design)
                 for k in KERNELS if hasattr(k, "launches_by_design")}
    ok_design = all(d["wgmma"] == counts[n] for n, d in by_design.items())
    ok_loss = all(math.isfinite(x) for x in res["losses"])
    ok_aux = all(math.isfinite(x) for x in res["aux_losses_last_step"].values())
    for name in ("gmm", "tgmm"):
        results.setdefault(name, {})["launches"] = counts[name]
    emit("moe_slice", tokens_per_s_per_gpu=res["value"],
         step_ms=res["step_ms"], peak_mem_bytes=res["peak_mem_bytes"],
         n_params=res["n_params"], n_active_params=res["n_active_params"],
         achieved_model_tflops_active=res["achieved_model_tflops_active"],
         model=res["model"], steps_run=steps, launches=counts,
         launches_per_step_expected=per_step, ok_launches=ok_counts,
         launches_by_design=by_design, ok_design=ok_design,
         losses=res["losses"], ok_losses_finite=ok_loss,
         aux_losses_last_step=res["aux_losses_last_step"], ok_aux_finite=ok_aux,
         tokens_per_expert_last_step=res["tokens_per_expert_last_step"])
    return ok_counts and ok_design and ok_loss and ok_aux


MOE_LAYER_TOL = {
    "rtol": 1.6e-2, "atol_row": 1.6e-2, "atol_all": 1e-3,
    "x_scale": 2.0,
    "why": "bf16 on both sides, identical routing: each grouped product "
           "rounds its float32 sums to bf16, where one rounding can flip (a "
           "bf16 step, up to 2^-7), and the flip travels through the GELU "
           "and the second product: two bf16 steps of the element or of its "
           "row's rms (one token's features), plus 1e-3 of the tensor's rms. "
           "dx is held to x_scale times that: it adds the router path, "
           "whose bf16 softmax backward subtracts nearly equal terms; the "
           "common limit gave dx a margin of 1.64 on an H100 (relative norm "
           "error 9.4e-4) and every other tensor at most 0.95"}


def check_moe_layer(results):
    """One full-width MoE layer (16384 tokens) forward and backward with the
    kernels against the same layer with the plain grouped products."""
    from tpu_dist_torch.nn import MoELayer
    from tpu_dist_torch.ops.gmm import gmm_impl

    g = torch.Generator(device="cuda").manual_seed(4)
    layer = MoELayer(768, 8, hidden=3072, top_k=2, dispatch="dropless",
                     device="cuda")
    layer.reset_parameters(g)
    with torch.no_grad():  # non-zero biases, so their paths are checked too
        layer.b1.normal_(0.0, 0.1, generator=g)
        layer.b2.normal_(0.0, 0.1, generator=g)
    layer.to(torch.bfloat16)
    x = torch.randn(8, 2048, 768, device="cuda", generator=g).to(
        torch.bfloat16)
    cot = torch.randn(8, 2048, 768, device="cuda", generator=g).to(
        torch.bfloat16)
    leaves = ["router", "w1", "b1", "w2", "b2"]

    def run_once():
        xr = x.detach().requires_grad_(True)
        y = layer(xr)
        grads = torch.autograd.grad(
            y, [xr] + [getattr(layer, k) for k in leaves], cot)
        route = {k: v.clone() for k, v in layer.routing.items()}
        return y.detach(), dict(zip(["x"] + leaves, grads)), route

    y_k, g_k, r_k = run_once()
    with gmm_impl("plain"):
        y_p, g_p, r_p = run_once()
    # a planted fault the check must reject: two experts' w1 swapped
    with torch.no_grad():
        layer.w1[[0, 1]] = layer.w1[[1, 0]]
    y_bad = run_once()[0]
    with torch.no_grad():
        layer.w1[[0, 1]] = layer.w1[[1, 0]]
    same_route = all(torch.equal(r_k[k], r_p[k]) for k in r_k)
    tol = MOE_LAYER_TOL
    lims = (tol["rtol"], 0.0, tol["atol_row"], tol["atol_all"])
    errs, margins, diag, ok = {}, {}, {}, True
    for k, (got, want) in {"y": (y_k, y_p), **{
            n: (g_k[n], g_p[n]) for n in g_k}}.items():
        scale = tol["x_scale"] if k == "x" else 1.0
        errs[k], _, margins[k], ok_t = compare(
            got, want, *(scale * v for v in lims))
        ok = ok and ok_t
        gf, wf = got.float(), want.float()
        diag[k] = {"rel_norm_err": float((gf - wf).norm() / wf.norm()),
                   "rms": float(wf.pow(2).mean().sqrt())}
    caught = compare(y_bad, y_p, *lims)[2]
    emit("moe_layer", tokens=16384, same_block_map=same_route,
         tokens_per_expert=r_k["counts"].tolist(),
         live_blocks=int(r_k["n_live_blocks"]),
         max_abs_err=errs, margin=margins, diagnostics=diag,
         planted_w1_swap_margin=caught, tolerance=MOE_LAYER_TOL,
         ok=ok and same_route and caught > 1.0)
    return ok and same_route and caught > 1.0


MOE_STEP_TOL = {
    "plain_products": {"loss_rtol": 1e-3, "update_rel": 0.35,
                       "leaf_update_rel": 1.0, "aux_rtol": 1.6e-2,
                       "moved_share": 0.057},
    "plain_composition": {"loss_rtol": 1e-2, "update_rel": 0.4,
                          "leaf_update_rel": 1.0, "aux_rtol": 1.6e-2,
                          "moved_share": 0.073},
    "why": "bf16 compute on both paths.  A token near a routing tie can "
           "pick another expert when its input moves by a bf16 step, and its "
           "whole expert FFN changes: the flips cascade through the layers "
           "and show most in the LayerNorm gains, whose gradients are sums "
           "over all 16384 tokens that mostly cancel.  An H100 measured, "
           "against the plain grouped products alone (their bf16 roundings "
           "differ by a step here and there), an update error of 0.171, "
           "worst leaf 0.47 and 5597 of 196608 token-layers on other "
           "experts (2.85%, none in the first layer); against the full "
           "plain composition (dense attention also rounds scores and "
           "softmax to bf16) 0.197, 0.49 and 7180 (3.65%).  The limits are "
           "about twice that.  aux: two bf16 steps.  Loss: the plain loss "
           "is a bf16 mean (1e-2 as in the dense check); with the fused "
           "loss kept, 1e-3"}


def _update_diff(p0, upd_k, params_p):
    """Relative error of the plain step's parameter update against the
    kernel step's: over all parameters, per leaf, and the worst leaf of
    each group (so a fault confined to one group is not hidden)."""
    num, den = {}, {}
    with torch.no_grad():
        for k in p0:
            upd_p = params_p[k] - p0[k]
            num[k] = float((upd_p - upd_k[k]).pow(2).sum())
            den[k] = float(upd_p.pow(2).sum())
    rel = math.sqrt(sum(num.values()) / sum(den.values()))
    leaf = {k: math.sqrt(num[k] / den[k]) if den[k] else
            (0.0 if num[k] == 0 else math.inf) for k in p0}
    groups = {"attention": (".attn.",), "router": (".mlp.router",),
              "expert_ffn": (".mlp.w", ".mlp.b"), "layernorm": (".ln",),
              "block0": ("block0.",)}
    group_worst = {}
    for gname, frags in groups.items():
        members = {k: v for k, v in leaf.items()
                   if any(f in k for f in frags)}
        wk = max(members, key=members.get)
        group_worst[gname] = [wk, members[wk]]
    return rel, leaf, group_worst


def check_moe_composition(results):
    """One step of the MoE kernel path from a seed and batch against (1)
    the same step with the plain grouped products, which isolates K3/K4,
    and (2) the full plain composition: plain grouped products, dense
    attention, unfused loss."""
    from tpu_dist_torch import nn, optim
    from tpu_dist_torch.benchmarks.moe_lm import build
    from tpu_dist_torch.ops.gmm import gmm_impl
    from tpu_dist_torch.parallel import DistributedDataParallel

    ddp, x, y = build(device="cuda")
    moe = [(p, m) for p, m in ddp.module.named_modules()
           if isinstance(m, nn.MoELayer)]
    state = ddp.init(seed=0)
    p0 = {k: p.detach().clone() for k, p in state.params.items()}
    state, m_k = ddp.train_step(state, x, y)
    upd_k = {k: state.params[k].detach() - p0[k] for k in p0}
    route_k = {p: m.routing["gate_idx"].clone() for p, m in moe}
    aux_k = {p: float(v["aux_loss"]) for p, v in state.model_state.items()}
    loss_k = float(m_k["loss"])
    ok_all = True
    for name, fused, dense in (("plain_products", True, False),
                               ("plain_composition", False, True)):
        plain = DistributedDataParallel(
            ddp.module, optimizer=optim.SGD(lr=0.01),
            loss_fn=nn.CrossEntropyLoss(fused=fused),
            compute_dtype=torch.bfloat16)
        state_p = plain.init(seed=0)
        same_init = all(torch.equal(state_p.params[k], p0[k]) for k in p0)
        attn = (nn.attention_impl("dense") if dense
                else contextlib.nullcontext())
        with attn, gmm_impl("plain"):
            state_p, m_p = plain.train_step(state_p, x, y)
        aux_p = {p: float(v["aux_loss"])
                 for p, v in state_p.model_state.items()}
        # tokens whose ordered expert choice differs between the two paths
        moved = {p: int((m.routing["gate_idx"] != route_k[p]).any(-1).sum())
                 for p, m in moe}
        share = sum(moved.values()) / (x.numel() * len(moe))
        rel, leaf, group_worst = _update_diff(p0, upd_k, state_p.params)
        worst = max(leaf, key=leaf.get)
        loss_p = float(m_p["loss"])
        aux_err = max(abs(aux_k[p] - aux_p[p]) / abs(aux_p[p])
                      for p in aux_p)
        tol = MOE_STEP_TOL[name]
        ok = (same_init
              and abs(loss_k - loss_p) <= tol["loss_rtol"] * abs(loss_p)
              and rel <= tol["update_rel"]
              and leaf[worst] <= tol["leaf_update_rel"]
              and aux_err <= tol["aux_rtol"] and share <= tol["moved_share"])
        ok_all = ok_all and ok
        emit("moe_composition", against=name, loss_kernel_path=loss_k,
             loss_plain_path=loss_p, update_rel_err=rel,
             worst_leaf=[worst, leaf[worst]],
             worst_leaf_by_group=group_worst,
             worst_leaves=sorted(leaf.items(), key=lambda kv: -kv[1])[:5],
             aux_rel_err=aux_err, aux_kernel_path=aux_k,
             tokens_with_other_experts=moved,
             tokens_with_other_experts_total=sum(moved.values()),
             moved_share=share, tokens_per_layer=x.numel(),
             same_init=same_init,
             tolerance={**tol, "why": MOE_STEP_TOL["why"]}, ok=ok)
    return ok_all


# ---------------------------------------------------------------------------
# the serving slice: no kernel on its path
# ---------------------------------------------------------------------------

# Token-for-token equality is required, except at a step where the
# reference's two largest argmax operands lie within this gap: batch size
# and cache length change cuBLAS's and the softmax's reduction order, so
# float32 results across pool sizes are equal only to rounding.
SERVE_TIE_GAP = 1e-4
# What the card may hold after a serve phase beyond what it held before:
# room for the cuBLAS workspaces of the scheduler thread's handle (32 MiB
# each on sm_90), far below the smallest pool (int8, 0.32 GB)
SERVE_LEFTOVER_BYTES = 128 << 20
_SERVE: dict = {}   # the full-width model, built once for the serve phases


def smoke_requests() -> list:
    """The serve phases' 16 requests for the 2048-position pool, from
    ``np.random.default_rng(0)``: prompt lengths uniform in 16-1536 (the
    longest raised to 1536 when none exceeds 1024, so the longest bucket
    runs), new-token counts uniform in 32-128, no eos; the last 4 requests
    at temperature 0.8 with seeds 1-4.  A check of every bucket and of
    sampling, not a traffic mix: the benchmark's traffic is
    ``serve_lm.workload``."""
    import numpy as np

    rng = np.random.default_rng(0)
    plens = rng.integers(16, 1536 + 1, 16)
    if plens.max() <= 1024:
        plens[int(plens.argmax())] = 1536
    gens = rng.integers(32, 128 + 1, 16)
    reqs = []
    for i, (p, g) in enumerate(zip(plens, gens)):
        s = i - 12 + 1
        reqs.append({"prompt": rng.integers(0, 32768, int(p)).astype(np.int32),
                     "max_new_tokens": int(g),
                     "temperature": 0.8 if s > 0 else 0.0,
                     "seed": max(s, 0)})
    return reqs


def _serve_model():
    from tpu_dist_torch.benchmarks.serve_lm import build
    if "model" not in _SERVE:
        _SERVE["model"] = build(device="cuda")
    return _SERVE["model"]


def _reference_logits(model, req, want, d, cache_dtype):
    """The (1, vocab) logits the reference, ``generate()`` of ``req`` with
    ``cache_dtype``, drew its token ``d`` from: its own path replayed — the
    prompt prefilled into a cache of the same length, then
    ``decode_step`` fed its tokens before ``d``."""
    prompt = torch.from_numpy(req["prompt"]).to(model.device).long()
    tp = prompt.shape[0]
    with torch.inference_mode():
        cache = model.init_cache(1, tp + req["max_new_tokens"], cache_dtype)
        logits = model(prompt[None], cache=cache)[:, -1]
        slots = {path: {k: v for k, v in entry.items() if k != "index"}
                 for path, entry in cache.items()}
        for i in range(d):
            logits, slots = model.decode_step(
                torch.tensor([want[i]], device=model.device), [tp + i],
                slots)
    return logits.float()


def _first_divergence(model, req, got, want, cache_dtype):
    """None when ``got`` equals the reference ``want``; else ``{"step",
    "gap", "replayed"}`` at the first differing step, ``gap`` being the
    distance of the two largest values whose argmax chose the reference's
    token there: the reference's own logits at that step, divided by the
    temperature and plus the step's Gumbel noise when the request samples.
    ``replayed``: their argmax is the reference's token, so the replay
    reproduced the reference."""
    from tpu_dist_torch import random

    if got == want:
        return None
    d = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    v = _reference_logits(model, req, want, d, cache_dtype)
    if req["temperature"] > 0:
        key = random.fold_in(random.key(req["seed"], model.device), d)
        v = random.gumbel(key, v.shape) + v / v.new_tensor(req["temperature"])
    top = v[0].topk(2)
    return {"step": d, "gap": float(top.values[0] - top.values[1]),
            "replayed": d < len(want) and int(top.indices[0]) == want[d]}


def _generate(model, req, cache_dtype):
    from tpu_dist_torch.serve import random_key
    prompt = torch.from_numpy(req["prompt"]).to(model.device)
    out = model.generate(
        prompt[None], req["max_new_tokens"],
        temperature=req["temperature"], cache_dtype=cache_dtype,
        rng=random_key(req["seed"]) if req["temperature"] else None)
    return out[0, len(req["prompt"]):].tolist()


def _tie_rule(model, reqs, got, want, cache_dtype, against: str) -> list:
    """Every request's tokens against the reference's under the tie rule:
    a list of ``(request, ok, divergence)``; each divergence is printed."""
    out = []
    for i, (r, a, b) in enumerate(zip(reqs, got, want)):
        div = _first_divergence(model, r, a, b, cache_dtype)
        ok = len(a) == r["max_new_tokens"] and (
            div is None or (div["replayed"] and div["gap"] <= SERVE_TIE_GAP))
        if div is not None:
            emit("serve_divergence", against=against, request=i, **div,
                 tie_gap_limit=SERVE_TIE_GAP, ok=ok)
        out.append((i, ok, div))
    return out


def decode_bound(model, engine) -> dict:
    """The least time of one decode step over the whole pool: the bytes it
    must move (every weight matrix once, one row of each embedding table
    per slot, the whole pool that dense cached attention reads) over the
    card's memory rate; its operations (≈ 2 per weight element and slot
    and 4 per cached element and slot) take far less at the float32
    rate."""
    slots = engine.num_slots
    w_bytes = sum(p.numel() * p.element_size()
                  for name, p in model.named_parameters()
                  if not name.startswith(("tok.", "pos.")))
    w_bytes += 2 * slots * model.tok.weight[0].numel() * 4
    pool_bytes = sum(t.numel() * t.element_size()
                     for entry in engine.cache.values()
                     for t in entry.values())
    ops = 2 * slots * sum(p.numel() for name, p in model.named_parameters()
                          if not name.startswith(("tok.", "pos.")))
    ops += 2 * sum(t.numel() for entry in engine.cache.values()
                   for name, t in entry.items() if not name.endswith("scale"))
    ms, by = bound(w_bytes + pool_bytes, ops, "f32")
    return {"bound_ms": ms, "bound_by": by, "weight_bytes": w_bytes,
            "pool_bytes": pool_bytes}


def _serve_over_socket(model, reqs, dtype) -> dict:
    """``reqs`` through ServeClient → socket → Frontend → Scheduler →
    SlotEngine(8 slots, max_len 2048), every serving object closed on
    return: the tokens, end reasons, the engine's stats over the wire,
    wall time, kernel launches, peak memory and the decode step's bound."""
    from tpu_dist_torch import serve
    from tpu_dist_torch.benchmarks.serve_lm import warmup
    from tpu_dist_torch.ops import KERNELS

    engine = serve.SlotEngine(model, num_slots=8, max_len=2048,
                              cache_dtype=dtype, device=model.device)
    warmup(engine, reqs)
    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    sched = serve.Scheduler(engine, batch_window=0.002)
    fe = serve.Frontend(sched, port=0)
    try:
        with serve.ServeClient("127.0.0.1", fe.port, connect_retry=10,
                               timeout=60) as cli:
            t0 = time.perf_counter()
            handles = [cli.submit(r["prompt"].tolist(),
                                  max_new_tokens=r["max_new_tokens"],
                                  temperature=r["temperature"],
                                  seed=r["seed"]) for r in reqs]
            got = [h.wait_done(600.0) for h in handles]
            wall = time.perf_counter() - t0
            reasons = [h.reason for h in handles]
            stats = cli.stats(timeout=60.0)
    finally:
        fe.close()
        sched.close()
    return {"got": got, "reasons": reasons, "stats": stats, "wall": wall,
            "launches": {k.__name__: k.launches for k in KERNELS},
            "peak": torch.cuda.max_memory_allocated(),
            "bound": decode_bound(model, engine)}


def check_serve(results, cache: str = "float32"):
    """The full-width model served through ServeClient → socket → Frontend
    → Scheduler → SlotEngine(8 slots, max_len 2048); every request against
    ``generate()`` alone on the card, and (float32) two greedy ones against
    the plain path on a CPU copy of the weights.  The memory the card holds
    after the phase must be back to what it held before it."""
    import gc

    from tpu_dist_torch.benchmarks.serve_lm import CACHE_DTYPES, CONFIG
    from tpu_dist_torch.models import TransformerLM

    model = _serve_model()
    dtype = CACHE_DTYPES[cache]
    reqs = smoke_requests()
    held_before = torch.cuda.memory_allocated()
    run = _serve_over_socket(model, reqs, dtype)
    gc.collect()
    torch.cuda.empty_cache()
    leftover = torch.cuda.memory_allocated() - held_before
    ok_memory = leftover <= SERVE_LEFTOVER_BYTES
    got, st = run["got"], run["stats"]
    ok_served = (run["reasons"] == ["length"] * len(reqs)
                 and all(len(a) == r["max_new_tokens"]
                         for a, r in zip(got, reqs)))
    ok_launches = not any(run["launches"].values())
    t1 = time.perf_counter()
    want = [_generate(model, r, dtype) for r in reqs]
    vs_gen = _tie_rule(model, reqs, got, want, dtype, f"generate_{cache}")
    gen_s = time.perf_counter() - t1
    vs_cpu = []
    if cache == "float32":
        cpu = TransformerLM(**CONFIG, device="cpu")
        cpu.load_state_dict(model.state_dict())
        greedy = sorted((i for i, r in enumerate(reqs)
                         if not r["temperature"]),
                        key=lambda i: len(reqs[i]["prompt"]))[:2]
        sub = [reqs[i] for i in greedy]
        cpu_want = [_generate(cpu, r, dtype) for r in sub]
        vs_cpu = [(greedy[i], ok, div) for i, ok, div in _tie_rule(
            cpu, sub, [got[i] for i in greedy], cpu_want, dtype, "cpu")]
        del cpu
    ok_ties = all(ok for _, ok, _ in vs_gen + vs_cpu)
    emit(f"serve{'' if cache == 'float32' else '_int8'}", cache=cache,
         requests=len(reqs), greedy=sum(not r["temperature"] for r in reqs),
         prompt_lens=[len(r["prompt"]) for r in reqs],
         max_new_tokens=[r["max_new_tokens"] for r in reqs],
         generated_tokens=st["generated_tokens"], wall_s=run["wall"],
         tokens_per_s=st["generated_tokens"] / run["wall"],
         ttft_p50_ms=st["ttft"]["p50"] * 1e3,
         ttft_p99_ms=st["ttft"]["p99"] * 1e3,
         decode_step_p50_ms=st["decode_step"]["p50"] * 1e3,
         decode_step_p99_ms=st["decode_step"]["p99"] * 1e3,
         prefill_p50_ms=st["prefill"]["p50"] * 1e3,
         occupancy=st["occupancy"], decode_steps=st["decode_steps"],
         peak_mem_bytes=run["peak"], held_before_bytes=held_before,
         leftover_bytes=leftover, ok_memory_released=ok_memory,
         decode_step_bound=run["bound"],
         kernel_launches=run["launches"], ok_launches_zero=ok_launches,
         ok_served=ok_served,
         divergent_vs_generate=[i for i, _, d in vs_gen if d],
         divergent_vs_cpu=[i for i, _, d in vs_cpu if d],
         cpu_checked_requests=[i for i, _, _ in vs_cpu],
         reference_seconds=gen_s, ok_tie_rule=ok_ties)
    return ok_served and ok_launches and ok_ties and ok_memory


def check_serve_int8(results):
    return check_serve(results, cache="int8")


def check_quant(results):
    """``quantize_linear_weights(attention=True)`` on the full-width model:
    greedy ``generate`` of 32 tokens on the card against the same int8
    weights on the CPU, and the decode step (8 slots, float32 pool) of the
    quantized model against the unquantized one, in turns."""
    import copy

    from tpu_dist_torch.nn import quantize_linear_weights

    model = _serve_model()
    qmodel = quantize_linear_weights(copy.deepcopy(model), attention=True)
    reqs = smoke_requests()
    req = dict(min(reqs, key=lambda r: len(r["prompt"])), max_new_tokens=32,
               temperature=0.0, seed=0)
    got = _generate(qmodel, req, torch.float32)
    cpu = copy.deepcopy(qmodel).to("cpu")
    want = _generate(cpu, req, torch.float32)
    [(_, ok_tie, div)] = _tie_rule(cpu, [req], [got], [want], torch.float32,
                                   "quant_cpu")
    del cpu

    lengths = [len(r["prompt"]) for r in reqs[:8]]
    tokens = torch.zeros(8, dtype=torch.long, device=model.device)

    def step_ms(m, cache, n=20):
        times = []
        for _ in range(n + 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.decode_step(tokens, lengths, cache)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[3:])

    caches = {name: m.init_slot_cache(8, 2048)
              for name, m in (("float", model), ("int8", qmodel))}
    timing = {"float": [], "int8": []}
    for name in ("float", "int8", "int8", "float"):
        timing[name].append(step_ms(model if name == "float" else qmodel,
                                    caches[name]))
    q_bytes = sum(p.numel() * p.element_size()
                  for p in qmodel.parameters())
    f_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    emit("quant", prompt_len=len(req["prompt"]), new_tokens=32,
         tokens_card=got, divergence_vs_cpu=div,
         decode_step_ms_float32_weights=timing["float"],
         decode_step_ms_int8_weights=timing["int8"],
         weight_bytes_float32=f_bytes, weight_bytes_int8=q_bytes,
         ok_tie_rule=ok_tie)
    return ok_tie and len(got) == 32


# ---------------------------------------------------------------------------
# the vision slice: ConvNet/MNIST and ResNet-18/CIFAR-10 DDP training
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def tf32(cudnn: bool):
    """Whether cuDNN may use TF32 for float32 convolutions in the block
    (cuBLAS may not, torch's default), restored after it.  ``tf32(True)`` is
    torch's default, under which the vision timing lines run; the strict
    comparisons run under ``tf32(False)``."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def launch_counts() -> dict:
    from tpu_dist_torch.ops import KERNELS
    return {k.__name__: k.launches for k in KERNELS}


def step_against_cpu(ddp, make_cpu_model, x, y, tol: dict, prepare=None):
    """One float32 train step of ``ddp`` on the card against the same step
    of a CPU copy of the port (same weights, state and batch), TF32 off:
    the loss, every parameter's update and every BatchNorm statistic.
    ``prepare(module)`` changes the initialized weights in place first.
    Returns the fields to print and whether each is within ``tol``."""
    from tpu_dist_torch.parallel import DistributedDataParallel

    with tf32(False):
        state = ddp.init(seed=0)
        if prepare is not None:
            prepare(ddp.module)
        cpu_model = make_cpu_model()
        cpu = DistributedDataParallel(cpu_model, optimizer=ddp.optimizer,
                                      loss_fn=ddp.loss_fn)
        cpu_state = cpu.init(seed=0)
        cpu_model.load_state_dict(ddp.module.state_dict())
        p0 = {k: v.detach().cpu().clone() for k, v in state.params.items()}
        state, m = ddp.train_step(state, x, y)
        cpu_state, m_cpu = cpu.train_step(cpu_state, x.cpu(), y.cpu())
    leaf = {}
    for k, p in state.params.items():
        upd_c = cpu_state.params[k].detach() - p0[k]
        err = float((p.detach().cpu() - p0[k] - upd_c).norm())
        leaf[k] = err / max(float(upd_c.norm()), 1e-30)
    bn = {}
    for path, leaves in state.model_state.items():
        for name, t in leaves.items():
            want = cpu_state.model_state[path][name]
            bn[f"{path}.{name}"] = float((t.cpu() - want).abs().max()
                                         / want.abs().max().clamp_min(1e-30))
    loss, loss_cpu = float(m["loss"]), float(m_cpu["loss"])
    worst = max(leaf, key=leaf.get)
    worst_bn = max(bn, key=bn.get) if bn else None
    ok = (abs(loss - loss_cpu) <= tol["loss_rtol"] * abs(loss_cpu)
          and leaf[worst] <= tol["update_rel"]
          and (not bn or bn[worst_bn] <= tol["state_rel"])
          and int(m["correct"]) == int(m_cpu["correct"]))
    return {"loss_card": loss, "loss_cpu": loss_cpu,
            "correct_card": int(m["correct"]),
            "correct_cpu": int(m_cpu["correct"]),
            "worst_update_leaf": [worst, leaf[worst]],
            "worst_bn_stat": [worst_bn, bn.get(worst_bn)],
            "tolerance": tol, "ok": ok}


def example_args(module, argv):
    return module.parse_args(["--synthetic", "--epochs", "1"] + argv)


def timed_row(fn, **kw) -> dict:
    """One benchmark run under torch's default TF32 permissions."""
    with tf32(True):
        r = fn(**kw)
    return {k: r[k] for k in ("value", "step_ms", "peak_mem_bytes",
                              "per_gpu_batch", "dtype", "cudnn_allow_tf32")}


def bn_moved(stats) -> bool:
    """Every BatchNorm statistic finite and moved from its initial value
    (mean 0, variance 1)."""
    return all(bool(torch.isfinite(t).all()) and bool(
        (t != (0.0 if leaf == "mean" else 1.0)).all())
        for leaves in stats.values() for leaf, t in leaves.items())


VISION_STEP_TOL = {
    "loss_rtol": 1e-5, "update_rel": 1.2e-2, "state_rel": 1e-5,
    "why": "float32 with TF32 off on both sides: cuDNN and the CPU's "
           "convolutions sum the same products in other orders (the CPU "
           "parity tests' 1e-5 relative on the loss and statistics). A "
           "leaf's update is its gradient, a sum over the batch and the "
           "image whose terms largely cancel (a first-layer weight, a "
           "BatchNorm bias), so its error is held to its own norm: about "
           "twice the worst leaves measured on an H100 (ConvNet "
           "conv1.weight 5.2e-3, ResNet-18 layer3.0.bn2.bias 3.0e-3)"}


def check_convnet(results):
    """The ConvNet twin's ``train`` at world 1 (batch 100, synthetic MNIST,
    float32) to convergence at lr 0.05 and evaluated; one step against the
    CPU copy; images/s/GPU at bench.py's headline (batch 8192, bf16,
    ``train_chunk``) and its float32 row (2048).  No hand-written kernel
    may launch."""
    from tpu_dist_torch.benchmarks import convnet
    from tpu_dist_torch.data import MNIST, DataLoader, transforms
    from tpu_dist_torch.examples import mpspawn_dist
    from tpu_dist_torch.models import ConvNet

    zero_launch_counts()
    t0 = time.perf_counter()
    run = mpspawn_dist.train(example_args(mpspawn_dist, [
        "--max-steps", "300", "--lr", "0.05", "--evaluate"]))
    train_s = time.perf_counter() - t0
    losses = [float(v) for v in run["losses"]]
    ev = run["eval"]
    fall = losses[0] / statistics.mean(losses[-10:])
    ok_train = (len(losses) == 300 and all(map(math.isfinite, losses))
                and fall >= 5.0 and ev["count"] == 10000
                and ev["accuracy"] > 0.9)

    ds = MNIST("./data", train=True, synthetic_fallback=True,
               transform=transforms.Normalize(transforms.MNIST_MEAN,
                                              transforms.MNIST_STD))
    x, y = next(iter(DataLoader(ds, batch_size=100)))
    ddp = convnet.build(batch=100, dtype="float32", device="cuda")[0]
    cmp_ = step_against_cpu(ddp, lambda: ConvNet(device="cpu"),
                            x.cuda(), y.cuda(), VISION_STEP_TOL)

    rows = [timed_row(convnet.run, batch=8192, steps=50, dtype="bfloat16"),
            timed_row(convnet.run, batch=2048, steps=50, dtype="float32")]
    counts = launch_counts()
    ok_launches = not any(counts.values())
    emit("convnet", train_steps=len(losses), first_loss=losses[0],
         last_losses=losses[-5:], loss_fall=fall, eval=ev,
         train_and_eval_s=train_s, ok_converged=ok_train,
         step_vs_cpu=cmp_, timing=rows,
         timing_note="torch's default TF32 permissions (cuDNN yes, cuBLAS "
                     "no); images/s/GPU at world 1",
         kernel_launches=counts, ok_launches_zero=ok_launches)
    return ok_train and cmp_["ok"] and ok_launches


def check_resnet(results):
    """resnet18(num_classes=10) through the ResNet twin's path (synthetic
    CIFAR-10, RandomCrop + Flip on the host, DataLoader → DeviceLoader),
    batch 256 and the example's recipe, 20 steps in float32 (then evaluated)
    and 20 in bf16: losses finite and falling, every BatchNorm statistic
    moved and finite, an exact evaluation count; one float32 step against
    the CPU copy; images/s/GPU at batch 256 and 1024 (bf16).  No
    hand-written kernel may launch."""
    from tpu_dist_torch.benchmarks import resnet_cifar
    from tpu_dist_torch.examples import example_mp
    from tpu_dist_torch.models import resnet18

    zero_launch_counts()
    runs = {}
    ok_train = True
    for name, argv in (("float32", ["--evaluate"]), ("bf16", ["--bf16"])):
        t0 = time.perf_counter()
        r = example_mp.train(example_args(example_mp,
                                          ["--max-steps", "20"] + argv))
        losses = [float(v) for v in r["losses"]]
        stats = r["state"].model_state
        moved = bn_moved(stats)
        falling = statistics.mean(losses[-5:]) < statistics.mean(losses[:5])
        ev = r["eval"]
        ok = (len(losses) == 20 and all(map(math.isfinite, losses))
              and falling and moved and len(stats) == 20
              and (ev is None or ev["count"] == 10000))
        ok_train = ok_train and ok
        runs[name] = {"losses": losses, "bn_layers": len(stats),
                      "bn_stats_moved_and_finite": moved,
                      "loss_falling": falling, "eval": ev,
                      "seconds": time.perf_counter() - t0, "ok": ok}
    ok_train = ok_train and runs["float32"]["eval"] is not None

    ddp, x, y = resnet_cifar.build(batch=256, dtype="float32", device="cuda")
    cmp_ = step_against_cpu(ddp, lambda: resnet18(num_classes=10,
                                                  device="cpu"),
                            x, y, VISION_STEP_TOL)
    rows = [timed_row(resnet_cifar.run, batch=b) for b in (256, 1024)]
    counts = launch_counts()
    ok_launches = not any(counts.values())
    emit("resnet", runs=runs, step_vs_cpu=cmp_, timing=rows,
         timing_note="bf16 compute over float32 masters, torch's default "
                     "TF32 permissions (cuDNN yes, cuBLAS no); "
                     "images/s/GPU at world 1",
         kernel_launches=counts, ok_launches_zero=ok_launches)
    return ok_train and cmp_["ok"] and ok_launches


# ---------------------------------------------------------------------------
# the training recipe: optimizers (multi-tensor) and checkpoint/resume
# ---------------------------------------------------------------------------

OPTIM_TOL = {
    "rtol": 4.8e-7, "atol_update": 1e-5, "sensitivity": 1e-3,
    "why": "float32 on both sides, from the same state and gradients: the "
           "multi-tensor kernels fuse multiply-adds the plain loop rounds "
           "twice and divide by a host scalar differently, so an element "
           "differs in its last bits. Each tensor (parameters and every "
           "state leaf) is held element by element to 4 ulps of its value "
           "(rtol 4.8e-7) plus 1e-5 of its largest change in the update; "
           "the plain result moved by 1e-3 of its own change must be "
           "rejected"}


def dense_shapes() -> dict:
    """The dense GPT-2-small slice's parameter shapes by name (136,993,280
    float32 values)."""
    from tpu_dist_torch.models import TransformerLM

    model = TransformerLM(vocab_size=32768, dim=768, depth=12, num_heads=12,
                          max_seq_len=2048, device="meta")
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _tensors(tree, prefix=""):
    """``{path: tensor}`` of a dict tree (the optimizer states)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tensors(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def count_launches(fn, names: bool = False):
    """Kernels the card ran for one ``fn()`` (``torch.profiler``); with
    ``names`` also the three commonest kernel names and their counts."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not names:
        return len(kernels)
    common = collections.Counter(k[:60] for k in kernels).most_common(3)
    return len(kernels), common


def optim_cases():
    """(name, optimizer, bytes a parameter moves, operations a parameter):
    each input read once and each output written once, float32."""
    from tpu_dist_torch import optim

    sched = optim.warmup_cosine(3e-4, 10, 100)
    return [
        ("sgd_momentum", optim.SGD(lr=0.02, momentum=0.9,
                                   weight_decay=1e-4), 20, 6),
        ("sgd_nesterov", optim.SGD(lr=0.02, momentum=0.9, nesterov=True,
                                   weight_decay=1e-4), 20, 8),
        ("sgd_schedule", optim.SGD(lr=sched, momentum=0.9), 20, 4),
        ("adamw", optim.AdamW(lr=sched, weight_decay=0.1), 28, 16),
        ("adam", optim.Adam(lr=1e-3, weight_decay=1e-4), 28, 16),
        ("rmsprop_centered_momentum", optim.RMSprop(
            lr=1e-3, momentum=0.9, centered=True), 36, 16),
        ("adagrad", optim.Adagrad(lr=1e-2, lr_decay=1e-3), 20, 7),
    ]


def _hold(after: dict, want: dict, before: dict, tol: dict) -> tuple:
    """Worst margin of ``after`` against ``want`` over the tensors, each
    element held to ``rtol*|want| + atol_update*max|want - before|``; and
    the worst margin of the plain result moved by ``sensitivity`` of its
    change (must exceed 1)."""
    worst, worst_key, planted = 0.0, None, math.inf
    for k, w in want.items():
        step = float((w - before[k]).abs().max())
        _, _, margin, ok = compare(after[k], w, tol["rtol"],
                                   tol["atol_update"] * step)
        if not ok and margin <= 1.0:
            margin = math.inf  # not finite
        if margin > worst:
            worst, worst_key = margin, k
        if step > 0:
            moved = w + tol["sensitivity"] * (w - before[k])
            planted = min(planted, compare(moved, w, tol["rtol"],
                                           tol["atol_update"] * step)[2])
    return worst, worst_key, planted


def check_optim(results):
    """Every optimizer's multi-tensor update (and EMA's, and
    clip_grad_norm) at the dense slice's 136,993,280 float32 parameters
    against its plain per-parameter loop on the same state and gradients;
    ms per update (CUDA events), launches per update (torch.profiler),
    the bytes bound, and torch.optim's fused AdamW/SGD as a yardstick."""
    from tpu_dist_torch import optim

    shapes = dense_shapes()
    n = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(scale):
        return {k: torch.randn(s, device="cuda", generator=gen) * scale
                for k, s in shapes.items()}

    params, grads = randn(0.02), randn(1e-2)
    lines, ok_all = [], True
    for name, opt, bytes_per, ops_per in optim_cases():
        p = _clone(params)
        state = opt.init(p)
        for _ in range(2):  # moments away from their zero start
            opt.update(grads, state, p)
        before = {**{f"p.{k}": v.clone() for k, v in p.items()},
                  **{k: v.clone() for k, v in _tensors(state).items()
                     if v.is_cuda}}
        p2, state2 = _clone(p), _clone(state)
        opt.update(grads, state, p)
        opt.update_plain(grads, state2, p2)
        got = {**{f"p.{k}": v for k, v in p.items()},
               **{k: v for k, v in _tensors(state).items() if v.is_cuda}}
        want = {**{f"p.{k}": v for k, v in p2.items()},
                **{k: v for k, v in _tensors(state2).items() if v.is_cuda}}
        worst, worst_key, planted = _hold(got, want, before, OPTIM_TOL)
        same_steps = all(int(a) == int(b) for a, b in zip(
            [v for v in _tensors(state).values() if not v.is_cuda],
            [v for v in _tensors(state2).values() if not v.is_cuda]))
        del p2, state2, before, got, want
        launches, common = count_launches(
            lambda: opt.update(grads, state, p), names=True)
        plain_launches = count_launches(
            lambda: opt.update_plain(grads, state, p))
        ms = time_ms(lambda: opt.update(grads, state, p))
        plain_ms = time_ms(lambda: opt.update_plain(grads, state, p),
                           reps=3, warm=1)
        b_ms, b_by = bound(bytes_per * n, ops_per * n, "f32")
        line = {"name": name, "ms": ms, "plain_ms": plain_ms,
                "launches": launches, "plain_launches": plain_launches,
                "commonest_kernels": common,
                "bound_ms": b_ms, "bound_by": b_by,
                "bytes_per_param": bytes_per, "worst_margin": worst,
                "worst_tensor": worst_key, "planted_margin": planted,
                # the per-tensor fallback would launch as many as the loop
                "multi_tensor": 3 * launches < plain_launches,
                "ok": (worst <= 1.0 and planted > 1.0 and same_steps
                       and 3 * launches < plain_launches)}
        if name in ("adamw", "sgd_momentum"):
            line["library_ms"] = _torch_optim_ms(name, params, grads)
        lines.append(line)
        ok_all = ok_all and line["ok"]
        del p, state
        torch.cuda.empty_cache()

    # EMA and clip_grad_norm, the same way
    ema = optim.EMA(0.999)
    shadow = ema.init(params)
    ema.update(shadow, grads)
    s2 = _clone(shadow)
    before = {k: v.clone() for k, v in shadow["shadow"].items()}
    ema.update(shadow, params)
    ema.update_plain(s2, params)
    worst, worst_key, planted = _hold(shadow["shadow"], s2["shadow"], before,
                                      OPTIM_TOL)
    same_steps = int(shadow["step"]) == int(s2["step"])
    line = {"name": "ema", "ms": time_ms(lambda: ema.update(shadow, params)),
            "plain_ms": time_ms(lambda: ema.update_plain(shadow, params),
                                reps=3, warm=1),
            "launches": count_launches(lambda: ema.update(shadow, params)),
            "plain_launches": count_launches(
                lambda: ema.update_plain(shadow, params)),
            "worst_margin": worst, "worst_tensor": worst_key,
            "planted_margin": planted, "bytes_per_param": 12}
    line["bound_ms"], line["bound_by"] = bound(12 * n, 3 * n, "f32")
    line["ok"] = (worst <= 1.0 and planted > 1.0 and same_steps
                  and 3 * line["launches"] < line["plain_launches"])
    lines.append(line)
    ok_all = ok_all and line["ok"]
    del shadow, s2, before

    # clip_grad_norm: the norm against float64 per-leaf sums, the clipped
    # leaves against the plain scale
    g = _clone(grads)
    want_norm = math.sqrt(sum(float(v.double().square().sum())
                              for v in grads.values()))
    clipped, norm = optim.clip_grad_norm(g, 1.0)
    scale = min(1.0, 1.0 / max(want_norm, 1e-12))
    err_norm = abs(float(norm) - want_norm) / want_norm
    # (a floor under the relative limit: an element may be exactly 0)
    worst = max(compare(clipped[k], grads[k] * scale, 4.8e-7, 1e-30)[2]
                for k in grads)
    clip_tol = {"norm_rtol": 1e-5, "rtol": 4.8e-7,
                "why": "the norm is float32 sums of float32 squares, "
                       "against float64; the scale is one float32 multiply"}
    line = {"name": "clip_grad_norm",
            "ms": time_ms(lambda: optim.clip_grad_norm(grads, 1e9)),
            "launches": count_launches(
                lambda: optim.clip_grad_norm(grads, 1e9)),
            "norm": float(norm), "norm_rel_err": err_norm,
            "worst_margin": worst, "bytes_per_param": 8,
            "tolerance": clip_tol}
    line["bound_ms"], line["bound_by"] = bound(8 * n, 3 * n, "f32")
    line["ok"] = (err_norm <= clip_tol["norm_rtol"] and worst <= 1.0
                  and line["launches"] < len(shapes))
    lines.append(line)
    ok_all = ok_all and line["ok"]
    emit("optim", n_params=n, n_tensors=len(shapes), tolerance=OPTIM_TOL,
         updates=lines, ok=ok_all)
    return ok_all


def _torch_optim_ms(name: str, params: dict, grads: dict) -> float:
    """torch.optim's fused update of the same tensors (a yardstick, used
    nowhere in the port)."""
    ps = [torch.nn.Parameter(v.clone()) for v in params.values()]
    for p, g in zip(ps, grads.values()):
        p.grad = g
    opt = (torch.optim.AdamW(ps, lr=3e-4, weight_decay=0.1, fused=True)
           if name == "adamw" else
           torch.optim.SGD(ps, lr=0.02, momentum=0.9, weight_decay=1e-4,
                           fused=True))
    return time_ms(opt.step)


RESUME_STEPS, RESUME_AT = 6, 3


def check_resume(results):
    """The dense slice at full width and depth (T 2048, batch 8, bf16 over
    float32 masters, fused loss, flash attention) through DDP with
    ``AdamW(lr=warmup_cosine)``, ``accum_steps=2`` and an EMA updated each
    step: RESUME_STEPS steps straight, against RESUME_AT steps, a save
    through AsyncCheckpointer, a fresh DDP restored (``verify=True``) and
    the rest; the final parameters, AdamW moments and counts and EMA
    shadow must be equal bit for bit.  Then the example_mp twin's
    ``--checkpoint-dir``/``--resume`` round trip, and the train_lm twin at
    its defaults with ``--generate 32``."""
    import io
    import shutil
    import tempfile

    import numpy as np

    from tpu_dist_torch import checkpoint, nn, optim
    from tpu_dist_torch.examples import example_mp, train_lm
    from tpu_dist_torch.models import TransformerLM
    from tpu_dist_torch.ops import KERNELS
    from tpu_dist_torch.parallel import DistributedDataParallel

    ema = optim.EMA(0.999)

    def build():
        model = TransformerLM(vocab_size=32768, dim=768, depth=12,
                              num_heads=12, max_seq_len=2048, device="cuda")
        return DistributedDataParallel(
            model, optimizer=optim.AdamW(
                lr=optim.warmup_cosine(3e-4, 2, RESUME_STEPS),
                weight_decay=0.1),
            loss_fn=nn.CrossEntropyLoss(fused=True),
            compute_dtype=torch.bfloat16, accum_steps=2)

    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, 32768, (8, 2048))).cuda()
               for _ in range(RESUME_STEPS + 1)]

    def run(ddp, state, ema_state, first, last, losses):
        for s in range(first, last):
            state, m = ddp.train_step(state, batches[s], batches[s + 1])
            ema.update(ema_state, state.params)
            losses.append(m["loss"])
        return state, ema_state

    zero_launch_counts()
    ddp = build()
    state = ddp.init(seed=0)
    losses_full = []
    full, full_ema = run(ddp, state, ema.init(state.params), 0,
                         RESUME_STEPS, losses_full)
    torch.cuda.synchronize()
    counts = launch_counts()
    by_design = {k.__name__: dict(k.launches_by_design)
                 for k in KERNELS if hasattr(k, "launches_by_design")}
    per_step = {"cross_entropy_fwd": 2, "cross_entropy_bwd": 2,
                "flash_fwd": 24, "flash_bwd": 24}
    ok_counts = all(counts[k] == RESUME_STEPS * c
                    for k, c in per_step.items())
    ok_design = all(d["wgmma"] == counts[k] for k, d in by_design.items())
    del ddp, state

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ddp = build()
        state = ddp.init(seed=0)
        losses_resumed = []
        state, ema_state = run(ddp, state, ema.init(state.params), 0,
                               RESUME_AT, losses_resumed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with checkpoint.AsyncCheckpointer(root) as ckpt:
            ckpt.save({"state": state, "ema": ema_state}, step=state.step)
            save_call_s = time.perf_counter() - t0
        save_s = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f))
                         for dp, _, fs in os.walk(root) for f in fs)
        del ddp, state, ema_state
        torch.cuda.empty_cache()

        fresh = build()
        template = {"state": fresh.init(seed=1)}
        template["ema"] = ema.init(template["state"].params)
        t0 = time.perf_counter()
        got = checkpoint.restore(root, template, verify=True,
                                 device=checkpoint.devices(template))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del template
        state, ema_state = run(fresh, got["state"], got["ema"], RESUME_AT,
                               RESUME_STEPS, losses_resumed)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    differ = [f"params.{k}" for k, v in state.params.items()
              if not torch.equal(v, full.params[k])]
    differ += [f"opt_state.{t}.{k}" for t in ("m", "v")
               for k, v in state.opt_state[t].items()
               if not torch.equal(v, full.opt_state[t][k])]
    differ += [f"ema.{k}" for k, v in ema_state["shadow"].items()
               if not torch.equal(v, full_ema["shadow"][k])]
    steps_equal = (state.step == full.step == RESUME_STEPS
                   and int(state.opt_state["step"]) == RESUME_STEPS
                   == int(full.opt_state["step"])
                   and int(ema_state["step"]) == int(full_ema["step"]))
    losses_equal = [float(a) == float(b)
                    for a, b in zip(losses_full, losses_resumed)]
    ok_resume = not differ and steps_equal and all(losses_equal)
    del fresh, state, ema_state, full, full_ema, got
    torch.cuda.empty_cache()

    # the example twins
    d = tempfile.mkdtemp(prefix="chip_smoke_example_mp_")
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            example_mp.train(example_args(example_mp, [
                "--max-steps", "3", "--checkpoint-every", "2",
                "--checkpoint-dir", d]))
            first_dirs = sorted(os.listdir(d))
            example_mp.train(example_args(example_mp, [
                "--max-steps", "2", "--resume", "--checkpoint-dir", d]))
        last_dirs = sorted(os.listdir(d))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    ok_example = (first_dirs == ["step_00000002", "step_00000003"]
                  and "resumed from step 3" in out.getvalue()
                  and "step_00000005" in last_dirs)

    t0 = time.perf_counter()
    lm = train_lm.train(train_lm.parse_args(["--generate", "32"]))
    lm_s = time.perf_counter() - t0
    lm_losses = lm["losses"]
    consistent = f"{lm['consistent']}/{lm['transitions']}"
    ok_lm = (all(map(math.isfinite, lm_losses))
             and statistics.mean(lm_losses[-10:]) < lm_losses[0] / 10
             and lm["consistent"] == lm["transitions"] == 32)
    del lm
    emit("resume", steps=RESUME_STEPS, saved_at=RESUME_AT,
         bit_exact=ok_resume, differing=differ[:10], n_differing=len(differ),
         losses=[float(v) for v in losses_full], losses_equal=losses_equal,
         save_call_s=save_call_s, save_s=save_s, restore_s=restore_s,
         checkpoint_bytes=ckpt_bytes, launches=counts,
         launches_per_step_expected=per_step, ok_launches=ok_counts,
         launches_by_design=by_design, ok_design=ok_design,
         example_mp={"first_run": first_dirs, "after_resume": last_dirs,
                     "ok": ok_example},
         train_lm={"first_loss": lm_losses[0], "last_losses": lm_losses[-5:],
                   "permutation_consistent": consistent,
                   "seconds": lm_s, "ok": ok_lm})
    return ok_resume and ok_counts and ok_design and ok_example and ok_lm


# ---------------------------------------------------------------------------
# the sequence-parallel slice: K2's offdiag mode, the split, the ring and
# train_lm --parallel sp
# ---------------------------------------------------------------------------

# design, (B, T, H, D), dtype, (block_q, block_k), timed: every design in
# causal="offdiag" mode, at the path's shape and at ragged ones; the first
# case gives the kernels line's rows
OFFDIAG_CASES = (
    ("wgmma", (8, 2048, 12, 64), torch.bfloat16, (1024, 1024), True),
    ("wgmma", (8, 2048, 12, 64), torch.bfloat16, (1024, 512), True),
    ("wgmma", (2, 1000, 3, 64), torch.bfloat16, (256, 384), False),
    ("mma_sync", (8, 2048, 6, 128), torch.bfloat16, (1024, 1024), True),
    ("mma_sync", (2, 1000, 3, 40), torch.bfloat16, (256, 128), False),
    ("fma", (2, 2048, 6, 64), torch.float32, (1024, 1024), True),
    ("fma", (2, 1000, 3, 40), torch.float32, (128, 384), False),
)


def check_flash_offdiag(results):
    """K2f/K2b in causal="offdiag" mode against their plain versions, in
    each design: within tolerance, two launches bit for bit alike, every
    launch of the design and mode the case must take, the first query
    block's rows empty (lse -1e30, o 0), and the plain causal result
    rejected by the same comparison (the planted fault).  Timed against the
    operations bound over the offdiag pairs, the plain version and SDPA
    with the band as a boolean mask."""
    import torch.nn.functional as F

    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")
    g = torch.Generator(device="cuda").manual_seed(2)
    ok_all = True
    for design, (b, t, h, d), dtype, blocks, timed in OFFDIAG_CASES:
        qkv = torch.randn(b, t, 3, h, d, device="cuda", generator=g).to(dtype)
        q, k, v = qkv.unbind(2)
        do = torch.randn(b, t, h, d, device="cuda", generator=g).to(dtype)
        scale = 1.0 / math.sqrt(d)
        bq, bk = fa.clamp_blocks(dtype, t, t, *blocks)
        tol = FLASH_BF16_TOL if dtype == torch.bfloat16 else FLASH_F32_TOL
        lims = (tol["rtol"], tol["atol"], tol["atol_row"], tol["atol_all"])
        picked = fa.flash_design(dtype, t, t, d,
                                 [x.stride() for x in (q, k, v)])

        def fwd():
            return fa.flash_fwd(q, k, v, "offdiag", scale, *blocks)

        zero_launch_counts()
        o_k, lse_k = fwd()
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, "offdiag", scale, *blocks)
        delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()

        def bwd():
            return fa.flash_bwd(q, k, v, do, lse_p, delta, "offdiag", scale,
                                *blocks)

        grads_k = bwd()
        grads_p = fa.flash_bwd_plain(q, k, v, do, lse_p, delta, "offdiag",
                                     scale, *blocks)
        o_k2, lse_k2 = fwd()
        grads_k2 = bwd()
        torch.cuda.synchronize()
        bitwise = {"fwd": torch.equal(o_k, o_k2) and torch.equal(lse_k,
                                                                 lse_k2),
                   "bwd": all(torch.equal(a, b2)
                              for a, b2 in zip(grads_k, grads_k2))}
        ran = {w.__name__: {"by_design": dict(w.launches_by_design),
                            "by_mode": dict(w.launches_by_mode)}
               for w in (fa.flash_fwd, fa.flash_bwd)}
        ok_launches = picked == design and all(
            r["by_design"][design] == 2 == sum(r["by_design"].values())
            and r["by_mode"]["offdiag"] == 2 == sum(r["by_mode"].values())
            for r in ran.values())
        pairs_kp = {"o": (o_k, o_p), "dq": (grads_k[0], grads_p[0]),
                    "dk": (grads_k[1], grads_p[1]),
                    "dv": (grads_k[2], grads_p[2])}
        errs, margins = {}, {}
        ok = True
        for name, (got, want) in pairs_kp.items():
            errs[name], _, margins[name], ok_t = compare(got, want, *lims)
            ok = ok and ok_t
        # rows before the first query block past key block 0 see no key:
        # lse -1e30 and o 0 (held apart: the rms of -1e30 overflows)
        first = offdiag_live(t, (bq, bk))[0]
        ok_empty = (bool((lse_k[:, :, :first] <= -1e29).all())
                    and bool((lse_p[:, :, :first] <= -1e29).all())
                    and not bool(o_k[:, :first].any()))
        errs["lse"], _, margins["lse"], ok_l = compare(
            lse_k[:, :, first:], lse_p[:, :, first:], 1e-5, 1e-4)
        # the planted fault: the plain causal pass (its own lse and delta)
        # in place of the kernels' must fail every comparison
        o_c, lse_c = fa.flash_fwd_plain(q, k, v, True, scale)
        delta_c = (do.float() * o_c.float()).sum(-1).transpose(1, 2)
        g_c = fa.flash_bwd_plain(q, k, v, do, lse_c, delta_c.contiguous(),
                                 True, scale)
        caught = {name: compare(got, pairs_kp[name][1], *lims)[2]
                  for name, got in zip(("o", "dq", "dk", "dv"),
                                       (o_c, *g_c))}
        ok_fault = all(m > 1.0 for m in caught.values())
        del o_c, lse_c, g_c, delta_c
        ok = (ok and ok_l and ok_launches and ok_empty and ok_fault
              and all(bitwise.values()))
        ok_all = ok_all and ok
        shape = {"q": [b, t, h, d], "dtype": str(dtype).split(".")[-1],
                 "blocks": list(blocks), "clamped_blocks": [bq, bk]}
        fields = {}
        if timed:
            keep = fa._keep_mask(t, t, "offdiag", dtype, "cuda", *blocks)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))

            def lib_fwd():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=keep)

            lib_o = lib_fwd()

            def lib_bwd():
                return torch.autograd.grad(lib_o, (qt, kt, vt),
                                           do.transpose(1, 2),
                                           retain_graph=True)

            # bytes: only the rows the mode reads (q and dO from the first
            # live query, k and v below the last query's limit, lse and
            # delta of the live queries), every output written in full
            row = b * h * d * q.element_size()
            q0, k_end = offdiag_live(t, (bq, bk))
            live_q = t - q0
            pairs = b * h * causal_pairs(t, t, "offdiag", (bq, bk))
            kind = "bf16_tensor" if dtype == torch.bfloat16 else "f32"
            bf = bound(row * (live_q + 2 * k_end + t) + b * h * t * 4,
                       4 * d * pairs, kind)
            bb = bound(row * (2 * live_q + 2 * k_end + 3 * t)
                       + 2 * b * h * live_q * 4, 10 * d * pairs, kind)
            t_f = (time_ms(fwd), time_ms(lambda: fa.flash_fwd_plain(
                q, k, v, "offdiag", scale, *blocks), reps=3),
                time_ms(lib_fwd))
            t_b = (time_ms(bwd), time_ms(lambda: fa.flash_bwd_plain(
                q, k, v, do, lse_p, delta, "offdiag", scale, *blocks),
                reps=3), time_ms(lib_bwd))
            del lib_o, qt, kt, vt, keep
            fields = {"pairs": pairs,
                      "fwd": dict(ms=t_f[0], plain_ms=t_f[1],
                                  library_ms=t_f[2], bound_ms=bf[0],
                                  bound_by=bf[1], bound_share=bf[0] / t_f[0]),
                      "bwd": dict(ms=t_b[0], plain_ms=t_b[1],
                                  library_ms=t_b[2], bound_ms=bb[0],
                                  bound_by=bb[1], bound_share=bb[0] / t_b[0]),
                      "library": "F.scaled_dot_product_attention with the "
                                 "offdiag band as a boolean attn_mask"}
            if "flash_fwd_offdiag" not in results:  # the path's shape
                results["flash_fwd_offdiag"] = dict(
                    max_abs_err=max(errs["o"], errs["lse"]), ms=t_f[0],
                    plain_ms=t_f[1], library_ms=t_f[2], bound_ms=bf[0],
                    bound_by=bf[1])
                results["flash_bwd_offdiag"] = dict(
                    max_abs_err=max(errs["dq"], errs["dk"], errs["dv"]),
                    ms=t_b[0], plain_ms=t_b[1], library_ms=t_b[2],
                    bound_ms=bb[0], bound_by=bb[1])
        emit("flash_offdiag", shape=shape, design=design, picked=picked,
             launches=ran, ok_launches=ok_launches, repeat_bitwise=bitwise,
             max_abs_err=errs, margin=margins, tolerance=tol,
             first_block_empty=ok_empty, planted_causal_margin=caught,
             ok_fault_rejected=ok_fault, ok=ok, **fields)
        del qkv, q, k, v, do, o_k, o_p, grads_k, grads_p, o_k2, grads_k2
    return ok_all


SPLIT_SHAPES = ((8, 2048, 12, 64), (1, 8192, 12, 64))


def _split_pass(fa, qkv, do, split: bool, grad: bool = True):
    """One causal flash pass over the fused projection's q/k/v views,
    split or not: ``o``, or ``(o, (dq, dk, dv))`` for the cotangent
    ``do``."""
    q, k, v = qkv.unbind(2)
    o = fa.flash_attention(q, k, v, causal=True, split_diag=split)
    if not grad:
        return o
    return o.detach(), torch.autograd.grad(o, qkv, do)[0].unbind(2)


def check_split_diag(results):
    """``flash_attention(split_diag=True)`` against ``split_diag=False``:
    the forward and the q/k/v grads (through the fused projection's views,
    as on the path) within the flash tolerance, and two K2f and two K2b
    calls a split pass, one causal and one offdiag each (this phase's
    offdiag launches are the kernels line's).  Both timed, forward and
    forward + backward, in turns; beside them the split's plain forward
    (the plain versions of its two calls and the merge), SDPA's causal
    call and the bound of the causal pairs (the split's executed area)."""
    import torch.nn.functional as F

    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")
    g = torch.Generator(device="cuda").manual_seed(3)
    lims = tuple(FLASH_BF16_TOL[k] for k in ("rtol", "atol", "atol_row",
                                             "atol_all"))
    ok_all = True
    runs = []
    zero_launch_counts()
    for b, t, h, d in SPLIT_SHAPES:
        qkv = torch.randn(b, t, 3, h, d, device="cuda", generator=g).to(
            torch.bfloat16).requires_grad_(True)
        do = torch.randn(b, t, h, d, device="cuda", generator=g).to(
            torch.bfloat16)
        before = {w.__name__: dict(w.launches_by_mode)
                  for w in (fa.flash_fwd, fa.flash_bwd)}
        o_s, g_s = _split_pass(fa, qkv, do, True)
        torch.cuda.synchronize()
        split_calls = {w.__name__: {m: w.launches_by_mode[m]
                                    - before[w.__name__][m]
                                    for m in fa.MODES}
                       for w in (fa.flash_fwd, fa.flash_bwd)}
        o_1, g_1 = _split_pass(fa, qkv, do, False)
        torch.cuda.synchronize()
        ok_calls = all(c == {"none": 0, "causal": 1, "offdiag": 1}
                       for c in split_calls.values())
        errs, margins, ok = {}, {}, ok_calls
        for name, got, want in (("o", o_s, o_1), *zip(
                ("dq", "dk", "dv"), g_s, g_1)):
            errs[name], _, margins[name], ok_t = compare(got, want, *lims)
            ok = ok and ok_t
        runs.append(dict(shape=[b, t, h, d], calls_a_pass=split_calls,
                         ok_calls=ok_calls, max_abs_err=errs,
                         margin=margins, ok=ok, qkv=qkv, do=do))
        ok_all = ok_all and ok
    for name in ("flash_fwd", "flash_bwd"):
        w = getattr(fa, name)
        results.setdefault(f"{name}_offdiag", {})["launches"] = \
            w.launches_by_mode["offdiag"]
    for r in runs:
        qkv, do = r.pop("qkv"), r.pop("do")

        def fwd(split):
            with torch.no_grad():
                return _split_pass(fa, qkv, do, split, grad=False)

        def fwd_bwd(split):
            return _split_pass(fa, qkv, do, split)

        times = {}
        for label, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
            one = time_ms(lambda: fn(False))
            split = (time_ms(lambda: fn(True)) + time_ms(lambda: fn(True))) / 2
            one = (one + time_ms(lambda: fn(False))) / 2
            times[label] = {"single_ms": one, "split_ms": split,
                            "split_over_single": split / one}
        b, t, h, d = r["shape"]
        q, k, v = (x.detach() for x in qkv.unbind(2))
        scale, band = 1.0 / math.sqrt(d), min(1024, t)

        def plain_split():
            o_d, lse_d = fa.flash_fwd_plain(
                *(fa._to_bands(x, band) for x in (q, k, v)), True, scale)
            o_off, lse_off = fa.flash_fwd_plain(q, k, v, "offdiag", scale)
            return fa.merge_lse(o_off, lse_off, o_d.reshape(b, t, h, d),
                                fa._rows_from_bands(lse_d, b))

        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        lib_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        times["fwd"]["plain_ms"] = time_ms(plain_split, reps=3)
        times["fwd"]["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True))
        times["fwd_bwd"]["library_ms"] = times["fwd"]["library_ms"] + \
            time_ms(lambda: torch.autograd.grad(
                lib_o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
        pairs = b * h * causal_pairs(t, t, True)
        tile = b * t * h * d * q.element_size()
        times["fwd"]["bound_ms"], times["fwd"]["bound_by"] = bound(
            4 * tile + b * h * t * 4, 4 * d * pairs, "bf16_tensor")
        bb = bound(7 * tile + 2 * b * h * t * 4, 10 * d * pairs,
                   "bf16_tensor")
        times["fwd_bwd"]["bound_ms"] = times["fwd"]["bound_ms"] + bb[0]
        del qkv, do, q, k, v, qt, kt, vt, lib_o
        results.setdefault("split_diag", []).append(
            {"shape": r["shape"], **times})
        emit("split_diag", tolerance=FLASH_BF16_TOL["why"][:60], **r,
             times=times)
    return ok_all


RING_N = 4
RING_SHAPE = (1, 8192, 12, 64)  # global (B, T, H, D): 4 shards of 2048


def check_ring(results):
    """The ring's per-hop functions over ``RING_N`` virtual ranks in one
    process (``ring_one_process``: lists stand in for the shifts) at
    GPT-2-small's attention over 8192 positions, causal and not: first one
    K2f/K2b call on the gathered sequence against the plain versions (o,
    lse, q/k/v grads); then the ring's output and q/k/v grads against that
    call, and n(n+1)/2 (causal) or n² launches of each; then Ulysses' local
    attention (3 heads a rank over the whole sequence) the same way, n
    launches each; then ``ring_self_attention`` at world 1 through its
    entry point (one launch each, equal to the single call).  The hops'
    own shape, (1, 2048, 12, 64) causal and not, is held against the plain
    versions in the ``flash`` phase."""
    from tpu_dist_torch import dist
    from tpu_dist_torch.nn.attention import scaled_dot_product_attention
    from tpu_dist_torch.parallel import ring_self_attention
    from tpu_dist_torch.parallel.ring_attention import ring_one_process

    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")
    g = torch.Generator(device="cuda").manual_seed(4)
    b, t, h, d = RING_SHAPE
    n = RING_N
    q, k, v, do = (torch.randn(b, t, h, d, device="cuda", generator=g).to(
        torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    lims = tuple(FLASH_BF16_TOL[key] for key in ("rtol", "atol", "atol_row",
                                                 "atol_all"))
    ok_all = True

    def launches():
        return fa.flash_fwd.launches, fa.flash_bwd.launches

    def held(got, want):
        """Errors and margins of o, dq, dk, dv against the reference."""
        out = {}
        for name, x, y in zip(("o", "dq", "dk", "dv"), got, want):
            err, _, margin, ok = compare(x, y, *lims)
            out[name] = {"max_abs_err": err, "margin": margin, "ok": ok}
        return out, all(r["ok"] for r in out.values())

    for causal in (True, False):
        o_ref, lse_ref = fa.flash_fwd(q, k, v, causal, scale)
        delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        g_ref = fa.flash_bwd(q, k, v, do, lse_ref, delta, causal, scale)
        ref = (o_ref, *g_ref)
        # the reference itself against the plain versions on its inputs
        # (the backward from the kernel's own lse and delta): the single
        # call at T = 8192, which the sp step's attention also runs
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale)
        g_p = fa.flash_bwd_plain(q, k, v, do, lse_ref, delta, causal, scale)
        single_err, ok_single = held(ref, (o_p, *g_p))
        lse_err, _, lse_margin, ok_lse = compare(lse_ref, lse_p, 1e-5, 1e-4)
        single_err["lse"] = {"max_abs_err": lse_err, "margin": lse_margin,
                             "ok": ok_lse}
        ok_single = ok_single and ok_lse
        del o_p, lse_p, g_p
        torch.cuda.empty_cache()
        shards = [list(x.chunk(n, 1)) for x in (q, k, v, do)]

        def ring():
            return ring_one_process(*shards[:3], causal, "flash",
                                    dos=shards[3])

        zero_launch_counts()
        outs, grads = ring()
        torch.cuda.synchronize()
        ring_launches = launches()
        want = n * (n + 1) // 2 if causal else n * n
        got = (torch.cat(outs, 1),
               *(torch.cat([gr[i] for gr in grads], 1) for i in range(3)))
        ring_err, ok_ring = held(got, ref)
        ok_ring = ok_ring and ring_launches == (want, want)

        def ulysses():
            per = h // n
            o_u, g_u = [], []
            for r in range(n):
                hs = slice(r * per, (r + 1) * per)
                qh, kh, vh = (x[:, :, hs].detach().requires_grad_(True)
                              for x in (q, k, v))
                o = scaled_dot_product_attention(qh, kh, vh, causal=causal)
                g_u.append(torch.autograd.grad(o, (qh, kh, vh),
                                               do[:, :, hs]))
                o_u.append(o.detach())
            return (torch.cat(o_u, 2),
                    *(torch.cat([gr[i] for gr in g_u], 2) for i in range(3)))

        zero_launch_counts()
        got_u = ulysses()
        torch.cuda.synchronize()
        uly_launches = launches()
        uly_err, ok_uly = held(got_u, ref)
        ok_uly = ok_uly and uly_launches == (n, n)

        dist.init_process_group(axis_names=("seq",), mesh_shape=(1,))
        try:
            qx, kx, vx = (x.detach().requires_grad_(True) for x in (q, k, v))
            zero_launch_counts()
            o_w1 = ring_self_attention(qx, kx, vx, "seq", causal=causal)
            g_w1 = torch.autograd.grad(o_w1, (qx, kx, vx), do)
            torch.cuda.synchronize()
            w1_launches = launches()
        finally:
            dist.destroy_process_group()
        got_w1 = (o_w1.detach(), *g_w1)
        w1_err, ok_w1 = held(got_w1, ref)
        w1_bitwise = all(torch.equal(x, y) for x, y in zip(got_w1, ref))
        ok_w1 = ok_w1 and w1_launches == (1, 1)

        def single():
            o, lse = fa.flash_fwd(q, k, v, causal, scale)
            dl = (do.float() * o.float()).sum(-1).transpose(1, 2)
            return fa.flash_bwd(q, k, v, do, lse, dl.contiguous(), causal,
                                scale)

        times = {"single_fwd_bwd_ms": time_ms(single, reps=5),
                 "ring_one_process_fwd_bwd_ms": time_ms(ring, reps=5),
                 "ulysses_local_fwd_bwd_ms": time_ms(ulysses, reps=5)}
        ok = ok_single and ok_ring and ok_uly and ok_w1
        ok_all = ok_all and ok
        results.setdefault("ring", {})[f"causal={causal}"] = times
        emit("ring", causal=causal, virtual_ranks=n, global_shape=[b, t, h, d],
             single_call_vs_plain={"held": single_err, "ok": ok_single},
             ring={"launches": ring_launches, "expected": [want, want],
                   "held": ring_err, "ok": ok_ring},
             ulysses_local={"launches": uly_launches, "expected": [n, n],
                            "held": uly_err, "ok": ok_uly},
             world1_entry_point={"launches": w1_launches, "held": w1_err,
                                 "bitwise_equal_single_call": w1_bitwise,
                                 "ok": ok_w1},
             times=times, tolerance=FLASH_BF16_TOL["why"][:60], ok=ok)
        del outs, grads, got, got_u, got_w1, o_ref, g_ref, ref, shards
    return ok_all


# GPT-2-small at long context through the sp twin, bf16 over float32
# masters; SGD at SP_LR (see SP_STEP_TOL)
SP_ARGV = ["--seq-len", "8192", "--batch-size", "1", "--dim", "768",
           "--depth", "12", "--heads", "12", "--vocab", "32768",
           "--compute-dtype", "bfloat16", "--log-every", "5"]
SP_LR = "2.0"
SP_STEPS = 20
SP_STEP_TOL = {"loss_rtol": 1e-2, "update_rel": 5e-2, "leaf_update_rel": 0.25,
               "why": "the dense slice's composition limits (loss, update "
                      "and worst leaf): at world 1 the ring is one "
                      "diagonal block and Ulysses' all-to-all the "
                      "identity, so both run the dense model's kernels "
                      "on the same inputs (bit for bit expected, reported "
                      "as bitwise)"}


def check_sp_train(results):
    """``train_lm --parallel sp`` at world 1 on the card, full width
    (GPT-2-small, vocab 32768, T = 8192, batch 1, bf16): one step of each
    mode against the same model built without ``sequence_axis``
    (``--parallel dp``) from the same seed and batch (``SP_STEP_TOL``);
    then ``SP_STEPS`` steps a mode: the loss falls, K2f/K2b launch ``depth``
    times a step (all wgmma), step ms and tokens/s."""
    from tpu_dist_torch.examples import train_lm
    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")

    def run(parallel, mode, steps):
        return train_lm.train(train_lm.parse_args(
            SP_ARGV + ["--parallel", parallel, "--sp-mode", mode,
                       "--steps", str(steps), "--lr", SP_LR]))

    def params(r):
        return {k: p.detach() for k, p in r["state"].params.items()}

    p0 = params(run("dp", "ring", 0))
    dense = run("dp", "ring", 1)
    p_dense, loss_dense = params(dense), dense["losses"][0]
    del dense
    ok_all = True
    for mode in ("ring", "ulysses"):
        one = run("sp", mode, 1)
        p_sp, loss_sp = params(one), one["losses"][0]
        del one
        num = {k: float((p_sp[k] - p_dense[k]).pow(2).sum()) for k in p0}
        den = {k: float((p_dense[k] - p0[k]).pow(2).sum()) for k in p0}
        rel = math.sqrt(sum(num.values()) / max(sum(den.values()), 1e-30))
        leaf = {k: math.sqrt(num[k] / den[k]) if den[k] else
                (0.0 if num[k] == 0 else math.inf) for k in p0}
        worst = max(leaf, key=leaf.get)
        bitwise = all(torch.equal(p_sp[k], p_dense[k]) for k in p0)
        ok_step = (abs(loss_sp - loss_dense)
                   <= SP_STEP_TOL["loss_rtol"] * abs(loss_dense)
                   and rel <= SP_STEP_TOL["update_rel"]
                   and leaf[worst] <= SP_STEP_TOL["leaf_update_rel"])
        del p_sp
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        r = run("sp", mode, SP_STEPS)
        counts = {w.__name__: {"launches": w.launches,
                               "by_design": dict(w.launches_by_design)}
                  for w in (fa.flash_fwd, fa.flash_bwd)}
        depth = int(SP_ARGV[SP_ARGV.index("--depth") + 1])
        ok_counts = all(c["launches"] == SP_STEPS * depth
                        == c["by_design"]["wgmma"] for c in counts.values())
        losses = r["losses"]
        ok_loss = (all(map(math.isfinite, losses))
                   and statistics.mean(losses[-5:]) < losses[0])
        step_ms = r["loop_seconds"] / (SP_STEPS - 1) * 1e3
        tokens_s = (r["batch"] * r["seq_len"] * (SP_STEPS - 1)
                    / r["loop_seconds"])
        r_first = r["first_step_seconds"]
        peak = torch.cuda.max_memory_allocated()
        del r
        ok = ok_step and ok_counts and ok_loss
        ok_all = ok_all and ok
        results.setdefault("sp_train", {})[mode] = {
            "step_ms": step_ms, "tokens_per_s": tokens_s}
        emit("sp_train", mode=mode, world=1,
             one_step={"loss_sp": loss_sp, "loss_dense": loss_dense,
                       "update_rel_err": rel, "worst_leaf": [worst,
                                                             leaf[worst]],
                       "bitwise": bitwise, "tolerance": SP_STEP_TOL,
                       "ok": ok_step},
             steps=SP_STEPS, losses=losses, ok_loss_falls=ok_loss,
             launches=counts, launches_per_step=depth, ok_launches=ok_counts,
             step_ms=step_ms, tokens_per_s=tokens_s,
             first_step_s=r_first, peak_mem_bytes=peak, ok=ok)
    return ok_all


# ---------------------------------------------------------------------------
# ImageNet-class training: augmentation on the card, ResNet-50, ViT-B/16
# ---------------------------------------------------------------------------

AUG_BATCH, AUG_RAW = 128, 256  # the example's batch of raw 256² uint8


def bf16_ulps(got, want) -> float:
    """The largest difference in units of bf16's spacing at the larger of
    the two magnitudes (a value rounded the other way is one unit off)."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got - want).abs() / ulp).max())


def check_augment(results):
    """``DeviceAugment.imagenet(224, bf16)``, ``imagenet_eval(224, 256)`` and
    ``cifar10(32)`` at the example's batch (128 × 256² × 3 uint8; 256 × 32²
    × 3) on the card, each against the same call on a CPU copy with the
    same key: float32 within 1e-5, bf16 within one bf16 ulp.  The modes'
    invariants: a forced flip mirrors the image, a pad_crop window is an
    integer crop of the padded image, the eval output ignores the key.
    Images/s of the card's augmentation, of the raw host gather from an
    in-RAM uint8 array (``DataLoader(to_float=False)``, one thread, as
    ``benchmarks/input_pipeline.py`` measures it) and of the ResNet-50 step
    alone; the pinned staging's host time and the H2D bytes a batch; and
    ``loader_keeps_card_fed`` (``raw_host_rate >= 1/(1/aug_rate +
    1/step_rate)``, the JAX benchmark's verdict)."""
    import numpy as np

    from tpu_dist_torch import random as trandom
    from tpu_dist_torch.benchmarks import imagenet_e2e
    from tpu_dist_torch.data import (ArrayImageDataset, DataLoader,
                                     DeviceAugment)

    zero_launch_counts()
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(rng.integers(
        0, 256, (AUG_BATCH, AUG_RAW, AUG_RAW, 3), np.uint8))
    small = torch.from_numpy(rng.integers(0, 256, (256, 32, 32, 3),
                                          np.uint8))
    key = trandom.fold_in(trandom.key(3), 7)
    cases = (("imagenet", DeviceAugment.imagenet(224, dtype=torch.bfloat16),
              raw),
             ("imagenet_eval", DeviceAugment.imagenet_eval(224, 256), raw),
             ("cifar10", DeviceAugment.cifar10(32), small))
    ok_all = True
    rates = {}
    for name, aug, x in cases:
        x_dev = x.cuda()
        got = aug(x_dev, key.cuda())
        want = aug(x, key)
        on_card = got.device.type == "cuda"
        if aug.dtype == torch.bfloat16:
            err, limit = bf16_ulps(got.cpu(), want), 1.0
        else:
            err, limit = float((got.cpu() - want).abs().max()), 1e-5
        ok = (on_card and err <= limit and got.dtype == aug.dtype
              and tuple(got.shape) == (x.shape[0], 3, *aug.size)
              and bool(torch.isfinite(got).all()))
        k_dev = key.cuda()
        ms = time_ms(lambda: aug(x_dev, k_dev))
        rates[name] = x.shape[0] / ms * 1e3
        emit("augment", case=name, mode=aug.mode,
             dtype=str(aug.dtype).split(".")[-1], shape=list(got.shape),
             err_vs_cpu=err, limit=limit,
             limit_unit="bf16 ulps" if aug.dtype == torch.bfloat16
             else "abs", ms=ms, images_per_s=rates[name], ok=ok)
        ok_all = ok_all and ok

    # invariants, on the card
    x_dev = raw.cuda()
    k_dev = key.cuda()
    flip = DeviceAugment.imagenet(224, flip_p=1.0)(x_dev, k_dev)
    keep = DeviceAugment.imagenet(224, flip_p=0.0)(x_dev, k_dev)
    ok_flip = torch.equal(flip, keep.flip(3))
    plain = DeviceAugment(32, mode="pad_crop", padding=4, flip_p=0.0,
                          mean=(0.0,) * 3, std=(1.0,) * 3)
    s_dev = small.cuda()
    out = plain(s_dev, k_dev)
    # the augmentation's own /255: a tensor divisor (CUDA divides by a
    # Python number as a multiply by its reciprocal)
    padded = torch.nn.functional.pad(
        s_dev.float() / torch.full((), 255.0, device="cuda"),
        (0, 0, 4, 4, 4, 4))
    keys = trandom.split(k_dev, 5)
    top = trandom.randint(keys[2], (256,), 0, 9)
    left = trandom.randint(keys[3], (256,), 0, 9)
    windows = torch.stack([padded[i, t:t + 32, l:l + 32] for i, (t, l) in
                           enumerate(zip(top.tolist(), left.tolist()))])
    ok_pad = torch.equal(out, windows.permute(0, 3, 1, 2))
    ev = DeviceAugment.imagenet_eval(224, 256)
    ok_eval = torch.equal(ev(x_dev, k_dev),
                          ev(x_dev, trandom.key(99).cuda()))
    emit("augment", invariants={"forced_flip_mirrors": ok_flip,
                                "pad_crop_is_integer_window": ok_pad,
                                "eval_ignores_key": ok_eval})
    ok_all = ok_all and ok_flip and ok_pad and ok_eval

    # the host's half: the raw gather, the pinned copy
    n_img = 1024
    ds = ArrayImageDataset(rng.integers(0, 256, (n_img, AUG_RAW, AUG_RAW, 3),
                                        np.uint8),
                           rng.integers(0, 1000, n_img))
    loader = DataLoader(ds, batch_size=AUG_BATCH, shuffle=True,
                        drop_last=True, to_float=False)
    best = math.inf
    for ep in range(3):
        loader.set_epoch(ep)
        t0 = time.perf_counter()
        seen = 0
        for xb, _ in loader:
            seen += xb.shape[0]
        best = min(best, (time.perf_counter() - t0) / seen)
    raw_host = 1.0 / best
    pin_ms, copy_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pinned = raw.pin_memory()
        t1 = time.perf_counter()
        pinned.to("cuda", non_blocking=True)
        torch.cuda.synchronize()
        pin_ms.append((t1 - t0) * 1e3)
        copy_ms.append((time.perf_counter() - t1) * 1e3)
    with tf32(True):
        ddp, xs, ys = imagenet_e2e.build(device="cuda")
        state = ddp.init(seed=0)
        step = lambda: ddp.train_step(state, xs, ys)
        step_ms = time_ms(step, reps=5, warm=3)
    del ddp, state, xs, ys
    step_rate = AUG_BATCH / step_ms * 1e3
    consume = 1.0 / (1.0 / rates["imagenet"] + 1.0 / step_rate)
    counts = launch_counts()
    ok_launches = not any(counts.values())
    results["augment"] = {"aug_images_per_s": rates["imagenet"],
                          "raw_host_images_per_s": raw_host,
                          "step_images_per_s": step_rate}
    emit("augment", aug_images_per_s=rates,
         raw_host_images_per_s=raw_host,
         h2d_bytes_per_batch=raw.numel(),
         pin_memory_ms=statistics.median(pin_ms),
         h2d_copy_ms=statistics.median(copy_ms),
         resnet50_step_ms=step_ms, resnet50_step_images_per_s=step_rate,
         card_consumes_images_per_s=consume,
         loader_keeps_card_fed=raw_host >= consume,
         kernel_launches=counts, ok_launches_zero=ok_launches)
    return ok_all and ok_launches


def _randomize_head(module) -> None:
    """A ViT's head drawn N(0, 0.02) in place (its init is zero, under which
    a first step reaches no parameter below the head)."""
    g = torch.Generator(device=module.head.weight.device).manual_seed(5)
    with torch.no_grad():
        module.head.weight.normal_(0.0, 0.02, generator=g)


RESNET50_STEP_TOL = {
    "loss_rtol": 1e-5, "update_rel": 8e-2, "state_rel": 1e-4,
    "why": "float32 with TF32 off on both sides, ResNet-50 at batch 4: "
           "VISION_STEP_TOL's reasons, over 53 BatchNorm layers. A leaf is "
           "held to the CPU parity tests' LEAF_TOL (tests/"
           "test_torch_vision_ddp.py: a ReLU input within rounding of 0 "
           "takes the other branch in one of two runs); measured on an "
           "H100 at 700 W, bn1.bias 3.7e-2. The statistics to about 3.5 "
           "times the worst measured there, layer4.2.bn1.var 2.8e-5: the "
           "rounding of 50 layers below compounds into layer4's 7x7 maps"}


def _one_step_vs_cpu(model_fn, batch, tol, prepare=None):
    """One float32 step of ``model_fn``'s model on the card at ``batch``
    images, SGD lr 0.1, against the CPU copy; the batch is
    ``DeviceAugment.imagenet(224)`` (float32) over raw 256² images."""
    import numpy as np

    from tpu_dist_torch import nn, optim
    from tpu_dist_torch import random as trandom
    from tpu_dist_torch.data import DeviceAugment
    from tpu_dist_torch.parallel import DistributedDataParallel

    rng = np.random.default_rng(1)
    raw = torch.from_numpy(rng.integers(0, 256, (batch, 256, 256, 3),
                                        np.uint8)).cuda()
    x = DeviceAugment.imagenet(224)(raw, trandom.key(1).cuda())
    y = torch.from_numpy(rng.integers(0, 1000, batch)).cuda()
    ddp = DistributedDataParallel(model_fn("cuda"),
                                  optimizer=optim.SGD(lr=0.1),
                                  loss_fn=nn.CrossEntropyLoss())
    return step_against_cpu(ddp, lambda: model_fn("cpu"), x, y, tol,
                            prepare=prepare)


def check_imagenet(results):
    """The ``example_imagenet`` twin at its defaults (ResNet-50, 224, 128 a
    replica, bf16 over float32 masters, SGD 0.1/0.9/1e-4, augmentation on
    the card) on ``SyntheticImageNet`` for 30 steps: the loss finite and
    falling, every BatchNorm statistic moved and finite; ``--evaluate``
    (``imagenet_eval`` on the card) counts exactly the set's 512 images.
    One float32 step at batch 4 against the CPU copy (``RESNET50_STEP_TOL``).
    Then the ``imagenet_e2e`` twin under torch's default TF32: the step
    alone and the sustained rate with the loader and the augmentation in
    the loop, and the peak memory.  No hand-written kernel may launch."""
    from tpu_dist_torch.benchmarks import imagenet_e2e
    from tpu_dist_torch.examples import example_imagenet
    from tpu_dist_torch.models import resnet50

    zero_launch_counts()
    t0 = time.perf_counter()
    r = example_imagenet.train(example_imagenet.parse_args(
        ["--epochs", "2", "--max-steps", "30", "--evaluate"]))
    run_s = time.perf_counter() - t0
    losses = [float(v) for v in r["losses"]]
    stats = r["state"].model_state
    moved = bn_moved(stats)
    falling = statistics.mean(losses[-5:]) < statistics.mean(losses[:5])
    ev = r["eval"]
    ok_train = (len(losses) == 30 and all(map(math.isfinite, losses))
                and falling and moved and len(stats) == 53
                and ev["count"] == 512)
    del r
    cmp_ = _one_step_vs_cpu(
        lambda d: resnet50(num_classes=1000, device=d), 4, RESNET50_STEP_TOL)
    with tf32(True):
        e2e = imagenet_e2e.run()
    counts = launch_counts()
    ok_launches = not any(counts.values())
    fed = results.get("augment")
    if fed:
        consume = 1.0 / (1.0 / fed["aug_images_per_s"]
                         + 1.0 / e2e["step_only_images_per_sec"])
        fed = {**fed, "e2e_step_images_per_s":
               e2e["step_only_images_per_sec"],
               "loader_keeps_card_fed":
                   fed["raw_host_images_per_s"] >= consume}
    emit("imagenet", steps=len(losses), first_losses=losses[:5],
         last_losses=losses[-5:], loss_falling=falling, bn_layers=len(stats),
         bn_stats_moved_and_finite=moved, eval=ev, run_and_eval_s=run_s,
         ok_train=ok_train, step_vs_cpu=cmp_, e2e=e2e, feed=fed,
         timing_note="torch's default TF32 permissions (cuDNN yes, cuBLAS "
                     "no); images/s/GPU at world 1",
         kernel_launches=counts, ok_launches_zero=ok_launches)
    return ok_train and cmp_["ok"] and ok_launches


VIT_SHAPE = (64, 197, 12, 64)  # ViT-B/16 at 224, 64 images: (B, T, H, D)
# the training run's classes: at 1000 (two images a class in the set) the
# loss stays at ln(1000) within bf16's resolution over 20 AdamW steps at
# 3e-4 from the zero head (measured on one H100); at 10 the class
# templates are learnable that soon
VIT_CLASSES = 10


def check_vit(results):
    """The twin with ``--model vit_b_16`` for 20 steps at 64 a card in bf16
    (AdamW 3e-4, weight decay 0.05; ``VIT_CLASSES`` classes): the loss
    finite and falling.  One
    float32 step at batch 2 against the CPU copy (SGD, from a random head:
    AdamW's first update is lr·sign(g), which a rounding flips wherever a
    gradient is near 0).  The ``vit_train`` twin: images/s, step ms, model
    TFLOP/s, peak memory.  No hand-written kernel may launch.  Then
    ``_FLASH_MIN_SEQ`` measured: ViT-B/16's attention at (64, 197, 12, 64)
    bf16, forward and backward, as the dense composition and through
    K2f/K2b (``impl="flash"``), the flash result held against its plain
    version at that ragged T."""
    from tpu_dist_torch.benchmarks import vit_train
    from tpu_dist_torch.examples import example_imagenet
    from tpu_dist_torch.models import vit_b_16
    from tpu_dist_torch.nn import scaled_dot_product_attention

    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")
    zero_launch_counts()
    t0 = time.perf_counter()
    r = example_imagenet.train(example_imagenet.parse_args(
        ["--model", "vit_b_16", "--batch-size", "64", "--max-steps", "20",
         "--num-classes", str(VIT_CLASSES)]))
    run_s = time.perf_counter() - t0
    losses = [float(v) for v in r["losses"]]
    n_params = sum(p.numel() for p in r["state"].params.values())
    del r
    falling = statistics.mean(losses[-5:]) < statistics.mean(losses[:5])
    ok_train = (len(losses) == 20 and all(map(math.isfinite, losses))
                and falling
                and n_params == 86_567_656 - 990 * (768 + 1))
    cmp_ = _one_step_vs_cpu(lambda d: vit_b_16(num_classes=1000, device=d),
                            2, VISION_STEP_TOL, prepare=_randomize_head)
    with tf32(True):
        row = vit_train.run()
    row.pop("losses")
    counts = launch_counts()
    ok_launches = not any(counts.values())
    emit("vit", steps=len(losses), classes=VIT_CLASSES,
         first_losses=losses[:5],
         last_losses=losses[-5:], loss_falling=falling, n_params=n_params,
         run_s=run_s, ok_train=ok_train, step_vs_cpu=cmp_, timing=row,
         peak_tflops_bf16=PEAK_OPS_S["bf16_tensor"] / 1e12,
         kernel_launches=counts, ok_launches_zero=ok_launches)

    # the dispatch crossover at ViT's shape: dense against flash
    b, t, h, d = VIT_SHAPE
    g = torch.Generator(device="cuda").manual_seed(4)
    qkv = torch.randn(b, t, 3, h, d, device="cuda",
                      generator=g).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn(b, t, h, d, device="cuda",
                     generator=g).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    o_k, lse = fa.flash_fwd(q, k, v, False, scale)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, False, scale)
    delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
    gk = fa.flash_bwd(q, k, v, do, lse_p, delta, False, scale)
    gp = fa.flash_bwd_plain(q, k, v, do, lse_p, delta, False, scale)
    tol = FLASH_BF16_TOL
    lims = (tol["rtol"], tol["atol"], tol["atol_row"], tol["atol_all"])
    margins = {n: compare(a, w, *lims)[2] for n, a, w in
               (("o", o_k, o_p), ("dq", gk[0], gp[0]), ("dk", gk[1], gp[1]),
                ("dv", gk[2], gp[2]))}
    ok_flash = all(m <= 1.0 for m in margins.values())
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

    def fwd(impl):
        return lambda: scaled_dot_product_attention(*leaves, impl=impl)

    def fwd_bwd(impl):
        def f():
            o = scaled_dot_product_attention(*leaves, impl=impl)
            torch.autograd.grad(o, leaves, do)
        return f

    times = {}
    for impl in ("dense", "flash", "flash", "dense"):  # in turns
        for what, fn in (("fwd", fwd(impl)), ("fwd_bwd", fwd_bwd(impl))):
            times.setdefault(f"{impl}_{what}_ms", []).append(time_ms(fn))
    times = {k: statistics.mean(v) for k, v in times.items()}
    emit("vit_attention", shape=list(VIT_SHAPE), dtype="bfloat16",
         flash_margin=margins, flash_tolerance=tol, ok_flash=ok_flash,
         flash_min_seq=importlib.import_module(
             "tpu_dist_torch.nn.attention")._FLASH_MIN_SEQ,
         flash_over_dense_fwd=times["flash_fwd_ms"] / times["dense_fwd_ms"],
         flash_over_dense_fwd_bwd=(times["flash_fwd_bwd_ms"]
                                   / times["dense_fwd_bwd_ms"]), **times)
    results["vit"] = {"images_per_s": row["value"],
                      "tflops": row["achieved_model_tflops"]}
    return ok_train and cmp_["ok"] and ok_launches and ok_flash


PHASES = (("cross_entropy", check_cross_entropy), ("flash", check_flash),
          ("gmm", check_gmm), ("slice", check_slice),
          ("composition", check_composition), ("moe_slice", check_moe_slice),
          ("moe_layer", check_moe_layer),
          ("moe_composition", check_moe_composition),
          ("serve", check_serve), ("serve_int8", check_serve_int8),
          ("quant", check_quant), ("convnet", check_convnet),
          ("resnet", check_resnet), ("optim", check_optim),
          ("resume", check_resume), ("flash_offdiag", check_flash_offdiag),
          ("split_diag", check_split_diag), ("ring", check_ring),
          ("sp_train", check_sp_train), ("augment", check_augment),
          ("imagenet", check_imagenet), ("vit", check_vit))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run; prints no result "
                         "line")
    args = ap.parse_args()
    only = [p for p in args.only.split(",") if p]
    unknown = set(only) - {name for name, _ in PHASES}
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to smoke-test",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import tpu_dist_torch  # noqa: F401  (fails alone, without the repo)
    from tpu_dist_torch.ops import _build
    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")
    gm = importlib.import_module("tpu_dist_torch.ops.gmm")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi)
    t0 = time.perf_counter()
    _build.build_all()  # one nvcc per source, all at once
    fa._lib()
    gm._lib()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={name: [ln.strip() for ln in
                       _build.compile_log(name).splitlines()
                       if "registers" in ln or "spill" in ln
                       or "Compiling" in ln]
                for name in _build.SOURCES})

    results: dict = {}
    failed = []
    for name, fn in PHASES:
        if only and name not in only:
            continue
        t_phase = time.perf_counter()
        try:
            ok = fn(results)
        except Exception:  # report every phase, then fail
            traceback.print_exc()
            ok = False
        emit("phase_seconds", name=name,
             seconds=time.perf_counter() - t_phase, ok=bool(ok))
        if not ok:
            failed.append(name)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    if only:
        print(f"chip_smoke: phases {only}: "
              f"{'FAILED ' + str(failed) if failed else 'passed'}",
              file=sys.stderr)
        return 1 if failed else 0

    kernels = []
    for name, (kid, route, source, replaces) in KERNEL_INFO.items():
        r = results.get(name, {})
        kernels.append({"name": name, "id": kid, "route": route,
                        "source": source, "replaces": replaces,
                        "launches": r.get("launches"),
                        "max_abs_err": r.get("max_abs_err"),
                        "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                        "bound_ms": r.get("bound_ms"),
                        "bound_by": r.get("bound_by"),
                        "library_ms": r.get("library_ms")})
        if any(kernels[-1][k] is None for k in
               ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms")):
            failed.append(f"{name}: missing numbers")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    if failed:
        print(f"chip_smoke: FAILED: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
