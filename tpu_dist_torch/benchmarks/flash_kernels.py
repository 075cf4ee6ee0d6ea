"""Flash attention (K2f, K2b) on the card: checked, then timed.

Holds the kernels that :func:`~tpu_dist_torch.ops.flash_attention.flash_design`
picks against their plain versions at ragged D = 64 shapes and at the
training path's (8, 2048, 12, 64) bf16 causal, with q, k, v the strided
views of a fused qkv projection, and checks that two launches on the same
inputs agree bit for bit.  Then it times K2f and K2b at the path shape with
``chip_smoke.py``'s stopwatch (median of CUDA events, one call a sample,
the wrapper's host work included): the design the shape takes, the older
``mma.sync`` design (``_older=True``), the card's own time (the host kept
ahead by a sleep on the card) and ``F.scaled_dot_product_attention`` with
its backward.  One JSON line per case, then one with the times.  The loop
for iterating on the flash kernels alone; ``chip_smoke.py --only flash``
is the full check.

    python -m tpu_dist_torch.benchmarks.flash_kernels [--only fwd|bwd]
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import statistics
import subprocess

import torch

from ..ops._build import resolve_device

# bf16 limits of chip_smoke.py's flash check: rtol, atol, of the row's rms,
# of the tensor's rms
_BF16_TOL = (1.6e-2, 0.0, 1.6e-2, 1e-3)


def time_ms(fn, reps: int = 10, warm: int = 2,
            hide_host: bool = False) -> float:
    """Median CUDA-event time of one ``fn()`` call; with ``hide_host`` the
    start event waits behind a sleep on the card, so the host has enqueued
    the call before the clock starts."""
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


def margin(got, want, rtol, atol, atol_row, atol_all) -> float:
    """The largest error over its limit (chip_smoke.py's ``compare``)."""
    got, want = got.detach().float(), want.detach().float()
    limit = (atol + atol_all * float(want.pow(2).mean().sqrt())
             + atol_row * want.pow(2).mean(-1, keepdim=True).sqrt()
             + rtol * want.abs())
    return float(((got - want).abs() / limit).max())


def run(only=("fwd", "bwd"), device=None) -> dict:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("flash_kernels times the card; it needs one")
    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")
    g = torch.Generator(device=device).manual_seed(1)
    result = {"device": torch.cuda.get_device_name(device), "cases": []}

    def case(b, t, h, d, causal, timed=False):
        qkv = torch.randn(b, t, 3, h, d, device=device, generator=g).to(
            torch.bfloat16)
        q, k, v = qkv.unbind(2)
        do = torch.randn(b, t, h, d, device=device, generator=g).to(
            torch.bfloat16)
        scale = 1.0 / math.sqrt(d)
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale)
        delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
        out = {"shape": [b, t, h, d], "causal": causal,
               "design": fa.flash_design(q.dtype, t, t, d,
                                         [x.stride() for x in (q, k, v)])}
        if "fwd" in only:
            o_k, lse_k = fa.flash_fwd(q, k, v, causal, scale)
            o_k2, lse_k2 = fa.flash_fwd(q, k, v, causal, scale)
            out["margin_o"] = margin(o_k, o_p, *_BF16_TOL)
            out["margin_lse"] = margin(lse_k, lse_p, 1e-5, 1e-4, 0.0, 0.0)
            out["fwd_bitwise"] = (torch.equal(o_k, o_k2)
                                  and torch.equal(lse_k, lse_k2))
        if "bwd" in only:
            grads = fa.flash_bwd(q, k, v, do, lse_p, delta, causal, scale)
            grads2 = fa.flash_bwd(q, k, v, do, lse_p, delta, causal, scale)
            plain = fa.flash_bwd_plain(q, k, v, do, lse_p, delta, causal,
                                       scale)
            for name, got, want in zip(("dq", "dk", "dv"), grads, plain):
                out[f"margin_{name}"] = margin(got, want, *_BF16_TOL)
            out["bwd_bitwise"] = all(torch.equal(x, y)
                                     for x, y in zip(grads, grads2))
        print(json.dumps(out), flush=True)
        result["cases"].append(out)
        if not timed:
            return
        import torch.nn.functional as F

        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        lib_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        times = {}
        if "fwd" in only:
            times["fwd_ms"] = time_ms(lambda: fa.flash_fwd(q, k, v, causal,
                                                           scale))
            times["fwd_older_ms"] = time_ms(lambda: fa.flash_fwd(
                q, k, v, causal, scale, _older=True))
            times["fwd_device_ms"] = time_ms(
                lambda: fa.flash_fwd(q, k, v, causal, scale), hide_host=True)
            times["sdpa_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
        if "bwd" in only:
            def bwd(older=False):
                return fa.flash_bwd(q, k, v, do, lse_p, delta, causal, scale,
                                    _older=older)

            times["bwd_ms"] = time_ms(bwd)
            times["bwd_older_ms"] = time_ms(lambda: bwd(True))
            times["bwd_device_ms"] = time_ms(bwd, hide_host=True)
            times["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                lib_o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
        result["times"] = times

    for shape in ((1, 128, 1, 64, False), (1, 128, 1, 64, True),
                  (1, 515, 2, 64, True), (2, 1000, 3, 64, False),
                  (2, 1000, 3, 64, True)):
        case(*shape)
    case(8, 2048, 12, 64, True, timed=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    result["nvidia_smi"] = smi.splitlines()[0] if smi else None
    print(json.dumps({"times": result["times"],
                      "nvidia_smi": result["nvidia_smi"]}), flush=True)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("fwd", "bwd"), default=None)
    args = ap.parse_args()
    run(only=(args.only,) if args.only else ("fwd", "bwd"))


if __name__ == "__main__":
    main()
