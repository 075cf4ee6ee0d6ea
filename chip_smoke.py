#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_dist_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. ``env``/``build``: versions, the card, and the build of the CUDA kernels
   from ``tpu_dist_torch/csrc`` (the Triton kernels compile at first launch).
2. ``kernel``: every kernel of the training path against its plain PyTorch
   version on the card, at the path's shapes and at a ragged shape, with the
   tolerance it is held to; kernel, plain and library-yardstick times (CUDA
   events, median) and the least time the card could take (``bound_ms``).
3. ``slice``: the GPT-2-small-shaped TransformerLM trained at full width
   through the port's DDP (bf16, fused cross-entropy, flash attention at
   T = 2048), with every kernel's launch count over that run; then
   ``composition``: one step against the plain composition (dense attention,
   unfused loss) on the same weights and batch.
4. ``kernels``: one line over all kernels; the card's name and power limit
   as ``nvidia-smi`` gives them; and, last, the result line.

Any failure exits non-zero and prints no result line; so does a machine with
no CUDA device, or a directory without the ``tpu_dist_torch`` package.
"""

from __future__ import annotations

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
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def causal_pairs(tq: int, tk: int, causal: bool) -> int:
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

    def run_case(b, t, h, d, dtype, causal, tol, timed):
        nonlocal ok_all
        # q, k, v as the strided views of a fused projection, as on the path
        qkv = torch.randn(b, t, 3, h, d, device=dev, generator=g).to(dtype)
        q, k, v = qkv.unbind(2)
        do = torch.randn(b, t, h, d, device=dev, generator=g).to(dtype)
        scale = 1.0 / math.sqrt(d)
        t0 = time.perf_counter()
        o_k, lse_k = fa.flash_fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale)
        delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
        grads_k = fa.flash_bwd(q, k, v, do, lse_p, delta, causal, scale)
        torch.cuda.synchronize()
        grads_p = fa.flash_bwd_plain(q, k, v, do, lse_p, delta, causal, scale)
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
        ok = ok and ok_l
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
        emit("kernel", name="flash", shape=shape, max_abs_err=errs,
             max_rel_err=rels, margin=margins, tolerance=tol, ok=ok,
             first_call_s=first_s, **fields)
        if not timed:
            return
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        lib_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        t_f = (time_ms(lambda: fa.flash_fwd(q, k, v, causal, scale)),
               time_ms(lambda: fa.flash_fwd_plain(q, k, v, causal, scale),
                       reps=5),
               time_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal)))
        t_b = (time_ms(lambda: fa.flash_bwd(q, k, v, do, lse_p, delta,
                                            causal, scale)),
               time_ms(lambda: fa.flash_bwd_plain(q, k, v, do, lse_p, delta,
                                                  causal, scale), reps=5),
               time_ms(lambda: torch.autograd.grad(
                   lib_o, (qt, kt, vt), do.transpose(1, 2),
                   retain_graph=True)))
        el = q.element_size()
        pairs = b * h * causal_pairs(t, t, causal)
        tile = b * t * h * d * el
        bf = bound(4 * tile + b * h * t * 4, 4 * d * pairs, "bf16_tensor")
        bb = bound(7 * tile + 2 * b * h * t * 4, 10 * d * pairs,
                   "bf16_tensor")
        emit("kernel", name="flash_fwd", shape=shape, ms=t_f[0],
             plain_ms=t_f[1], library_ms=t_f[2],
             library="F.scaled_dot_product_attention", bound_ms=bf[0],
             bound_by=bf[1], tflops=4 * d * pairs / t_f[0] / 1e9)
        emit("kernel", name="flash_bwd", shape=shape, ms=t_b[0],
             plain_ms=t_b[1], library_ms=t_b[2],
             library="F.scaled_dot_product_attention backward",
             bound_ms=bb[0], bound_by=bb[1],
             tflops=10 * d * pairs / t_b[0] / 1e9)
        results["flash_fwd"] = dict(max_abs_err=max(errs["o"], errs["lse"]),
                                    ms=t_f[0], plain_ms=t_f[1],
                                    library_ms=t_f[2], bound_ms=bf[0],
                                    bound_by=bf[1])
        results["flash_bwd"] = dict(
            max_abs_err=max(errs["dq"], errs["dk"], errs["dv"]), ms=t_b[0],
            plain_ms=t_b[1], library_ms=t_b[2], bound_ms=bb[0],
            bound_by=bb[1])

    bf16_tol = {"rtol": 1.6e-2, "atol": 0.0, "atol_row": BF16_ATOL_ROW,
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
    f32_tol = {"rtol": 2e-5, "atol": 2e-5, "atol_row": 0.0, "atol_all": 0.0,
               "why": "float32 throughout; the JAX package's forward "
                      "tolerance (tests/test_flash_attention.py:42), here "
                      "for o and the gradients alike"}
    run_case(8, 2048, 12, 64, torch.bfloat16, True, bf16_tol, timed=True)
    # ragged T and D, both head-dim instantiations (D <= 64, D <= 128), both
    # dtypes' kernels
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

    for k in KERNELS:
        k.launches = 0
    res = run()
    counts = {k.__name__: k.launches for k in KERNELS}
    steps, depth = res["steps_run"], res["model"]["depth"]
    per_step = {"cross_entropy_fwd": 1, "cross_entropy_bwd": 1,
                "flash_fwd": depth, "flash_bwd": depth}
    ok_counts = all(counts[n] == steps * c for n, c in per_step.items())
    ok_loss = all(math.isfinite(x) for x in res["losses"])
    for name, c in counts.items():
        results.setdefault(name, {})["launches"] = c
    emit("slice", tokens_per_s_per_gpu=res["value"], step_ms=res["step_ms"],
         peak_mem_bytes=res["peak_mem_bytes"], n_params=res["n_params"],
         achieved_model_tflops=res["achieved_model_tflops"],
         model=res["model"], steps_run=steps, launches=counts,
         launches_per_step_expected=per_step, ok_launches=ok_counts,
         losses=res["losses"], ok_losses_finite=ok_loss)
    return ok_counts and ok_loss


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to smoke-test",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import tpu_dist_torch  # noqa: F401  (fails alone, without the repo)
    from tpu_dist_torch.ops import _build
    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")

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
    fa._lib()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas=[ln.strip() for ln in
                _build.compile_log("flash_attention").splitlines()
                if "registers" in ln or "spill" in ln or "Compiling" in ln])

    results: dict = {}
    failed = []
    for name, fn in (("cross_entropy", check_cross_entropy),
                     ("flash", check_flash), ("slice", check_slice),
                     ("composition", check_composition)):
        try:
            ok = fn(results)
        except Exception:  # report every phase, then fail
            traceback.print_exc()
            ok = False
        if not ok:
            failed.append(name)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

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
