"""Where the time of one step goes, on the card.

Runs the dense slice of :mod:`tpu_dist_torch.benchmarks.transformer_lm`,
with ``--model llama`` the same slice with ``norm="rmsnorm", rope=True``,
with ``--model lm_32k`` its 32k-context row (T = 32768, batch 1, remat),
with ``--model moe`` the dropless-MoE slice of
:mod:`tpu_dist_torch.benchmarks.moe_lm` (``moe_gather``, ``moe_einsum``: its
capacity dispatches), with ``--model convnet`` the
ConvNet of :mod:`tpu_dist_torch.benchmarks.convnet` (batch 8192, bf16),
with ``--model resnet18`` the ResNet-18 of
:mod:`tpu_dist_torch.benchmarks.resnet_cifar` (batch 1024, bf16), with
``--model resnet50`` the ResNet-50 step of
:mod:`tpu_dist_torch.benchmarks.imagenet_e2e` (224², batch 128, bf16), with
``--model vit_b_16`` the ViT-B/16 step of
:mod:`tpu_dist_torch.benchmarks.vit_train` (224², batch 64, bf16), with
``--model sp_ring`` or ``sp_ulysses`` the sequence-parallel GPT-2-small of
``train_lm --parallel sp`` at world 1 (T = 8192, batch 1, bf16, unfused
loss; a training step each), or one
decode iteration (``SlotEngine.step``: the pool's forward, the sampling and
the read-back of the tokens) of the serving slice of
:mod:`tpu_dist_torch.benchmarks.serve_lm` with its 8 slots filled by the
benchmark's first 8 prompts — greedy (``serve``), all sampling at
temperature 0.8 with seeds 1-8 (``serve_sampled``), or greedy over the
int8 KV cache (``serve_int8``) — under ``torch.profiler`` for a few steps
after warm-up, and prints one JSON line: device time per step by kernel
group and for the slowest kernels, kernel launches per step, the device's
idle share over the profiled window
(1 − union of kernel intervals / the span from the first kernel's start to
the last one's end, the profiler's own host overhead included), and the
step's time without the profiler (host clock, synchronized).

    python -m tpu_dist_torch.benchmarks.profile_step [--model MODEL]
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from collections import defaultdict

import torch

from ..ops._build import resolve_device
from ..serve import Request, SlotEngine
from . import (convnet, imagenet_e2e, moe_lm, resnet_cifar, serve_lm,
               transformer_lm, vit_train)


def _train_step(build):
    def make(device):
        ddp, x, y = build(device=device)
        state = [ddp.init(seed=0)]

        def step():
            state[0], _ = ddp.train_step(state[0], x, y)
        return step
    return make


def _convnet(device):
    ddp, xs, ys = convnet.build(device=device)
    return ddp, xs[0], ys[0]


def _decode_step(cache_dtype, sampled: bool):
    def make(device):
        engine = SlotEngine(serve_lm.build(device=device), num_slots=8,
                            cache_dtype=cache_dtype, device=device)
        for i, r in enumerate(serve_lm.workload(8)):
            # enough new tokens for warm-up and both timed windows
            engine.admit(Request(r["prompt"], 100,
                                 temperature=0.8 if sampled else 0.0,
                                 seed=i + 1))
        return engine.step
    return make


def _sp_step(mode):
    return _train_step(functools.partial(
        transformer_lm.build, batch=1, seq_len=8192, fused=False,
        sequence_axis="seq", mode=mode))


_BUILDERS = {"dense": _train_step(transformer_lm.build),
             "llama": _train_step(functools.partial(
                 transformer_lm.build, norm="rmsnorm", rope=True)),
             "lm_32k": _train_step(functools.partial(
                 transformer_lm.build, batch=1, seq_len=32768, remat=True)),
             "sp_ring": _sp_step("ring"),
             "sp_ulysses": _sp_step("ulysses"),
             "moe": _train_step(functools.partial(moe_lm.build,
                                                  dispatch="dropless")),
             "moe_gather": _train_step(functools.partial(
                 moe_lm.build, dispatch="gather")),
             "moe_einsum": _train_step(functools.partial(
                 moe_lm.build, dispatch="einsum")),
             "convnet": _train_step(_convnet),
             "resnet18": _train_step(resnet_cifar.build),
             "resnet50": _train_step(imagenet_e2e.build),
             "vit_b_16": _train_step(vit_train.build),
             "serve": _decode_step(torch.float32, sampled=False),
             "serve_sampled": _decode_step(torch.float32, sampled=True),
             "serve_int8": _decode_step(torch.int8, sampled=False)}

# kernel-name fragments → group (first match wins)
_GROUPS = (("flash", "flash attention (K2)"),
           ("cross_entropy", "cross-entropy (K1)"),
           ("tgmm", "grouped matmul tgmm (K4)"),
           ("gmm", "grouped matmul gmm (K3)"),
           # cuDNN's convolutions are implicit GEMMs: name them first
           ("fprop", "convolution"), ("dgrad", "convolution"),
           ("wgrad", "convolution"), ("conv", "convolution"),
           ("gemm", "matmul"), ("xmma", "matmul"), ("nvjet", "matmul"),
           ("cutlass", "matmul"), ("pool", "pooling"),
           ("softmax", "softmax"), ("layer_norm", "layernorm"),
           ("elementwise", "elementwise"),
           ("reduce", "reductions"))


def _group(name: str) -> str:
    low = name.lower()
    for frag, group in _GROUPS:
        if frag in low:
            return group
    return "other"


def profile(steps: int = 3, warmup: int = 3, model: str = "dense",
            device=None) -> dict:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("profile() reads device kernels; it needs the card")
    step = _BUILDERS[model](device)
    for _ in range(warmup):
        step()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize(device)
    unprofiled_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize(device)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    by_name = defaultdict(float)
    by_group = defaultdict(float)
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] += us
        by_group[_group(e.name)] += us
    busy, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = spans[-1][1] - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {
        "device": torch.cuda.get_device_name(device),
        "model": model,
        "steps": steps,
        "kernel_ms_per_step": sum(by_name.values()) / steps / 1e3,
        "window_ms_per_step": window / steps / 1e3,
        "idle_share": 1.0 - busy / window,
        "groups_ms_per_step": {
            g: us / steps / 1e3
            for g, us in sorted(by_group.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [[n[:120], us / steps / 1e3]
                                    for n, us in top],
        "kernel_launches_per_step": len(kernels) / steps,
        "unprofiled_ms_per_step": unprofiled_ms,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(_BUILDERS), default="dense")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    print(json.dumps(profile(steps=args.steps, model=args.model)))
