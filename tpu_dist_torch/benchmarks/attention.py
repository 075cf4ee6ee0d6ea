"""Flash attention against the dense composition on the card.

The port's twin of the JAX package's ``benchmarks/attention.py``: causal
self-attention, forward and forward + backward, in bf16 at b = 4, h = 8,
d = 64, through both routes of
:func:`tpu_dist_torch.nn.attention.scaled_dot_product_attention`:

  dense — the materialized (T, T) scores and softmax (torch ops);
  flash — the hand-written kernels K2f and K2b
          (``tpu_dist_torch/csrc/flash_attention.cu``), O(T) memory.

Each row gives model TFLOP/s with the JAX accounting (4·B·H·T²·D forward,
2.5× that with the backward; the causal half is not credited) and
flash's speedup over dense; at 8192 and 32768 (batch 1) where dense's
scores do not fit it is flash only.  torch's
``F.scaled_dot_product_attention`` (``is_causal=True``) is timed at each
row as the library yardstick (``library_sdpa``; the JAX row's
``stock_jax_kernel``).  The sweep over T = 64-1024 at the same shape
(ROADMAP S7) finds the shortest sequence from which on flash's forward +
backward is no slower than dense's (``crossover_seq_len``); the
auto-dispatch's ``_FLASH_MIN_SEQ`` is not changed by it.  Times: CUDA
events, one call a sample, medians.  Each row also gives the flash
kernels' launches while it ran against the calls it made
(``flash_launches``, ``flash_calls``).

    python -m tpu_dist_torch.benchmarks.attention
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..nn.attention import _FLASH_MIN_SEQ, scaled_dot_product_attention
from ..ops import flash_bwd, flash_fwd
from ..ops._build import resolve_device
from ._card import device_stamp, median_seconds

__all__ = ["run", "ROWS", "SWEEP"]

# (sequence, dense too?, batch): 32k at batch 1 is flash only
ROWS = ((2048, True, None), (8192, False, None), (32768, False, 1))
SWEEP = (64, 128, 256, 512, 1024)


def _routes(q, k, v, impl: str):
    """``(forward, forward + backward)`` closures of one route."""
    if impl == "sdpa":
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def attend(q_, k_, v_):
            return torch.nn.functional.scaled_dot_product_attention(
                q_, k_, v_, is_causal=True)
        args = (qt, kt, vt)
    else:
        def attend(q_, k_, v_):
            return scaled_dot_product_attention(q_, k_, v_, causal=True,
                                                impl=impl)
        args = (q, k, v)

    def fwd():
        with torch.no_grad():
            return attend(*args)

    def fwd_bwd():
        leaves = [a.detach().requires_grad_(True) for a in args]
        o = attend(*leaves)
        return torch.autograd.grad(o.float().pow(2).sum(), leaves)

    return fwd, fwd_bwd


def _timed_route(q, k, v, impl: str, flops_fwd: float, reps: int) -> dict:
    fwd, fwd_bwd = _routes(q, k, v, impl)
    t_f = median_seconds(fwd, q.device, reps, warm=2)
    t_b = median_seconds(fwd_bwd, q.device, reps, warm=2)
    return {"fwd_ms": t_f * 1e3, "fwd_bwd_ms": t_b * 1e3,
            "fwd_tflops": flops_fwd / t_f / 1e12,
            "fwd_bwd_tflops": 2.5 * flops_fwd / t_b / 1e12}


def _row(t: int, b: int, h: int, d: int, dense: bool, library: bool,
         reps: int, device) -> dict:
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
        np.float32)).to(device, torch.bfloat16) for _ in range(3))
    flops_fwd = 4 * b * h * t * t * d
    row = {"seq_len": t, "batch": b}
    f0, b0 = flash_fwd.launches, flash_bwd.launches
    row["flash"] = _timed_route(q, k, v, "flash", flops_fwd, reps)
    calls = 2 + reps   # warm-up and timed calls of each closure
    row["flash_calls"] = {"fwd": 2 * calls, "bwd": calls}
    row["flash_launches"] = {"flash_fwd": flash_fwd.launches - f0,
                             "flash_bwd": flash_bwd.launches - b0}
    if dense:
        row["dense"] = _timed_route(q, k, v, "dense", flops_fwd, reps)
        row["flash_speedup_fwd_bwd"] = (row["dense"]["fwd_bwd_ms"]
                                        / row["flash"]["fwd_bwd_ms"])
    if library:
        row["library_sdpa"] = _timed_route(q, k, v, "sdpa", flops_fwd, reps)
    return row


def run(b: int = 4, h: int = 8, d: int = 64, rows=ROWS, sweep=SWEEP,
        reps: int = 10, device=None) -> dict:
    """The rows at ``rows`` (``(T, dense too?, batch or None for b)``) and
    the flash-against-dense sweep over ``sweep``; the kernels need a card
    (on the CPU the flash route takes its plain version)."""
    device = resolve_device(device)
    library = device.type == "cuda"
    out_rows = [_row(t, bt or b, h, d, both, library, reps, device)
                for t, both, bt in rows]
    swept = [_row(t, b, h, d, True, False, reps, device) for t in sweep]
    # the shortest swept T from which flash is no slower at every longer one
    crossover = None
    for r in reversed(swept):
        if r["flash"]["fwd_bwd_ms"] > r["dense"]["fwd_bwd_ms"]:
            break
        crossover = r["seq_len"]
    return {
        "metric": "flash_attention_causal_bf16",
        "shape": {"batch": b, "heads": h, "head_dim": d},
        "rows": out_rows,
        "sweep": [{"seq_len": r["seq_len"],
                   "flash_fwd_bwd_ms": r["flash"]["fwd_bwd_ms"],
                   "dense_fwd_bwd_ms": r["dense"]["fwd_bwd_ms"],
                   "flash_fwd_ms": r["flash"]["fwd_ms"],
                   "dense_fwd_ms": r["dense"]["fwd_ms"],
                   "flash_speedup_fwd_bwd": r["flash_speedup_fwd_bwd"]}
                  for r in swept],
        "crossover_seq_len": crossover,
        "flash_min_seq": _FLASH_MIN_SEQ,
        "timing": "CUDA events, one call a sample, median of "
                  f"{reps}" if library else "host clock (no card)",
        **device_stamp(device),
    }


if __name__ == "__main__":
    print(json.dumps(run()))
